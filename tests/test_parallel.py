"""Sharding tests on the 8-device virtual CPU mesh (SURVEY.md §4):
sharded-vs-single-device step parity, batch sharding layout, dryrun entry.
"""

import pytest
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from kd_cheap_conv import nnx

from kd_cheap_conv.models import build_model
from kd_cheap_conv.parallel import make_mesh, replicate, shard_batch
from kd_cheap_conv.train import make_optimizer, make_train_step

RNG = np.random.RandomState(0)


def _batch(n=8, hw=33, classes=21):
    return (jnp.asarray(RNG.randn(n, hw, hw, 3), jnp.float32),
            jnp.asarray(RNG.randint(0, classes, (n, hw, hw)), jnp.int32))


def test_mesh_has_8_devices():
    mesh = make_mesh()
    assert mesh.devices.size == 8
    assert mesh.axis_names == ("data",)


def test_shard_batch_layout():
    mesh = make_mesh()
    images, labels = shard_batch(_batch(), mesh)
    assert isinstance(images.sharding, NamedSharding)
    assert images.sharding.spec == P("data")
    # each device holds 1/8 of the batch
    assert images.addressable_shards[0].data.shape[0] == 1


@pytest.mark.slow
def test_sharded_step_matches_single_device():
    """The SPMD-sharded train step must track the unsharded one. Elementwise
    param equality is NOT expected (f32 reduction reorder + cancellation in
    grad sums), so assert the loss trajectory over several steps instead —
    a wrong all-reduce (e.g. per-shard mean not globalized) diverges fast."""

    fixed_batch = _batch()  # ONE batch for both runs (RNG is shared state)

    def build_and_run(shard: bool, steps: int = 4):
        model = build_model("deeplabv3plus_mobilenet", num_classes=21,
                            rngs=nnx.Rngs(0))
        _, params, _ = nnx.split(model, nnx.Param, ...)
        tx = make_optimizer(params, lr=0.01, max_iters=100)
        init, step = make_train_step(model, tx)
        state = init()
        batch = fixed_batch
        if shard:
            mesh = make_mesh()
            state = replicate(state, mesh)
            batch = shard_batch(batch, mesh)
        losses = []
        for _ in range(steps):
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
        return losses

    single = build_and_run(False)
    sharded = build_and_run(True)
    # step 1 is pre-divergence: tight. Later steps drift chaotically from
    # f32 reduction reorder (momentum amplifies); 5% still catches a broken
    # all-reduce (per-shard means are off by ~8x).
    np.testing.assert_allclose(sharded[0], single[0], rtol=1e-4)
    np.testing.assert_allclose(sharded, single, rtol=5e-2)


def test_sharded_bn_uses_global_batch_moments():
    """Sync-BN semantics: with a batch whose per-shard means differ wildly,
    train-mode BN must normalize with the GLOBAL batch moments. Crafted so
    there is no cancellation — the check is near-exact."""
    from kd_cheap_conv.models.layers import BatchNorm

    class M(nnx.Module):
        def __init__(self, rngs):
            self.bn = BatchNorm(4, rngs=rngs)

        def __call__(self, x):
            return self.bn(x)

    # per-device constant blocks: shard i holds value i -> per-shard var = 0,
    # global var > 0. If BN were per-shard, output would be all zeros.
    x = np.repeat(np.arange(8, dtype=np.float32), 4 * 4 * 4).reshape(8, 4, 4, 4)

    def run(shard):
        m = M(nnx.Rngs(0))
        m.train()
        graphdef, state = nnx.split(m)
        xb = jnp.asarray(x)
        st = state
        if shard:
            mesh = make_mesh()
            xb = shard_batch(xb, mesh)
            st = replicate(state, mesh)

        @jax.jit
        def fwd(st, xb):
            mm = nnx.merge(graphdef, st)
            y = mm(xb)
            return y, nnx.state(mm)

        y, _ = fwd(st, xb)
        return np.asarray(y)

    y_single = run(False)
    y_sharded = run(True)
    assert np.abs(y_sharded).max() > 0.5, "per-shard BN detected (all-zero out)"
    np.testing.assert_allclose(y_sharded, y_single, rtol=1e-5, atol=1e-5)


def test_graft_entry_single_chip():
    import sys
    sys.path.insert(0, "/root/repo")
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (1, 129, 129, 21)
    assert bool(jnp.isfinite(out).all())


def test_eval_step_sharded_matches_replicated():
    """make_eval_step on mesh-sharded val batches produces the same
    confusion matrix as replicated compute (VERDICT r1 weak #5)."""
    from kd_cheap_conv.train.steps import make_eval_step

    mesh = make_mesh()
    model = build_model("deeplabv3plus_mobilenet", num_classes=6,
                        output_stride=16, rngs=nnx.Rngs(0))
    model.eval()
    graphdef, params, rest = nnx.split(model, nnx.Param, ...)
    eval_step = make_eval_step(graphdef, num_classes=6)

    images, labels = _batch(n=8, hw=33, classes=6)

    cm_rep, _ = eval_step(params, rest, (images, labels))

    sharding = NamedSharding(mesh, P("data"))
    sb = (jax.device_put(images, sharding), jax.device_put(labels, sharding))
    cm_sh, preds = eval_step(params, rest, sb)

    np.testing.assert_array_equal(np.asarray(cm_rep), np.asarray(cm_sh))
    assert int(np.asarray(cm_sh).sum()) == labels.size
    assert preds.shape == labels.shape


def test_tta_sharded_matches_replicated():
    """config #5 on a mesh: make_tta_predict_fn on batch-sharded inputs
    produces the same preds/probs as replicated compute (the jitted TTA
    program is GSPMD-partitioned from the input sharding)."""
    from kd_cheap_conv.inference import make_tta_predict_fn

    mesh = make_mesh()
    model = build_model("deeplabv3plus_mobilenet", num_classes=6,
                        output_stride=16, rngs=nnx.Rngs(0))
    model.eval()
    tta = make_tta_predict_fn(model, scales=(0.5, 1.0), flip=True)

    images, _ = _batch(n=8, hw=33, classes=6)
    preds_rep, probs_rep = tta(images)

    sharding = NamedSharding(mesh, P("data"))
    preds_sh, probs_sh = tta(jax.device_put(images, sharding))

    np.testing.assert_array_equal(np.asarray(preds_sh), np.asarray(preds_rep))
    np.testing.assert_allclose(np.asarray(probs_sh), np.asarray(probs_rep),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_devices", [2, 4, 8])
def test_sharded_kd_step_matches_one_device(n_devices):
    """The data-parallel KD step (main.py's multi-device path: data mesh,
    batches placed by prefetch_to_device, uncommitted state) gives the same
    loss and parameter update as one device on the same global batch. Run
    in float64: at random init this step amplifies float32 summation-order
    noise to ~1e-2 in the update, which would hide a real discrepancy."""
    from kd_cheap_conv.data import prefetch_to_device
    from kd_cheap_conv.kd import KDConfig, replace_cheap_convs
    from kd_cheap_conv.kd.replace import CheapConvSpec
    from kd_cheap_conv.train import make_kd_train_step

    teacher = build_model("deeplabv3plus_mobilenet", num_classes=6,
                          rngs=nnx.Rngs(0))
    student = build_model("deeplabv3plus_mobilenet", num_classes=6,
                          rngs=nnx.Rngs(1))
    replace_cheap_convs(student, CheapConvSpec(kind="separable"),
                        scope="classifier")
    _, params, _ = nnx.split(student, nnx.Param, ...)
    tx = make_optimizer({"student": params}, lr=0.01, max_iters=10,
                        label_fn=lambda d: "head")
    init, step, t_state = make_kd_train_step(
        student, teacher, tx, KDConfig(temperature=2.0, alpha=0.5, beta=0.5))
    rng = np.random.RandomState(n_devices)
    host = (rng.randn(8, 33, 33, 3), rng.randint(0, 6, (8, 33, 33)))
    jax.config.update("jax_enable_x64", True)
    try:
        f64 = lambda t: jax.tree.map(
            lambda x: (jnp.asarray(x, jnp.float64)
                       if jnp.issubdtype(x.dtype, jnp.floating)
                       else jnp.array(x)), t)
        p0 = jax.tree.map(np.asarray, f64(init().params))
        t64 = f64(t_state)
        s1, m1 = step(f64(init()), f64(host), t64)
        mesh = make_mesh(jax.devices()[:n_devices])
        batch = next(prefetch_to_device(iter([host]), mesh=mesh))
        sn, mn = step(f64(init()), batch, t64)
        assert len(batch[0].addressable_shards) == n_devices
        assert batch[0].addressable_shards[0].data.shape[0] == 8 // n_devices
        assert batch[0].dtype == jnp.float64
        # the losses reduce in float32 (ops.losses casts logits to f32)
        np.testing.assert_allclose(float(mn["loss"]), float(m1["loss"]),
                                   rtol=1e-6)

        def delta(s):
            return np.concatenate([(np.asarray(a) - b).ravel()
                                   for a, b in zip(jax.tree.leaves(s.params),
                                                   jax.tree.leaves(p0))])

        d1, dn = delta(s1), delta(sn)
        # measured <= 6e-9; the update passes a float32 momentum buffer
        assert np.linalg.norm(dn - d1) <= 1e-6 * np.linalg.norm(d1)
    finally:
        jax.config.update("jax_enable_x64", False)
