"""Checkpoint layout roundtrip (reference keys) + torch .pth import parity."""

import pytest
import os

import numpy as np
import jax
import jax.numpy as jnp
import torch
from kd_cheap_conv import nnx

from kd_cheap_conv.models import build_model
from kd_cheap_conv.models.layers import Conv2d
from kd_cheap_conv.train import make_optimizer, make_train_step
from kd_cheap_conv.train.checkpoint import (
    checkpoint_path,
    import_torch_state_dict,
    load_checkpoint,
    save_checkpoint,
)


def test_checkpoint_roundtrip(tmp_path):
    model = build_model("deeplabv3plus_mobilenet", num_classes=21)
    _, params, rest = nnx.split(model, nnx.Param, ...)
    tx = make_optimizer(params, lr=0.01, max_iters=10)
    init, step = make_train_step(model, tx)
    state = init()
    path = checkpoint_path(str(tmp_path), "latest", "deeplabv3plus_mobilenet",
                           "voc", 16)
    save_checkpoint(path, cur_itrs=7, params=state.params, rest=state.rest,
                    opt_state=state.opt_state, best_score=0.42)
    assert os.path.isdir(path)
    restored = load_checkpoint(path)
    # reference's five keys (SURVEY.md §2.4)
    assert set(restored) == {"cur_itrs", "model_state", "optimizer_state",
                             "scheduler_state", "best_score"}
    assert int(restored["cur_itrs"]) == 7
    assert float(restored["best_score"]) == np.float32(0.42)
    # params roundtrip bit-exact (orbax stringifies int dict keys, so compare
    # by normalized path, not leaf order)
    def flat(d, prefix=""):
        out = {}
        if isinstance(d, dict):
            for k, v in d.items():
                out.update(flat(v, f"{prefix}.{k}"))
        else:
            out[prefix] = np.asarray(d)
        return out

    want = flat(nnx.to_pure_dict(state.params))
    got = flat(restored["model_state"]["params"])
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)


@pytest.mark.slow
def test_continue_training_full_resume(tmp_path):
    """Resume must restore optimizer momentum + schedule count + best_score:
    4 steps -> save -> restore into a FRESH differently-seeded state -> 4 more
    steps must match an uninterrupted 8-step run (deterministic batches).
    Catches the round-1 defect where resume restarted poly LR from base lr."""
    from jax.flatten_util import ravel_pytree

    from kd_cheap_conv.train.checkpoint import restore_train_state

    rng = np.random.RandomState(0)
    batches = [(jnp.asarray(rng.randn(2, 33, 33, 3), jnp.float32),
                jnp.asarray(rng.randint(0, 6, (2, 33, 33)), jnp.int32))
               for _ in range(8)]

    def build(seed):
        model = build_model("deeplabv3plus_mobilenet", num_classes=6,
                            rngs=nnx.Rngs(seed))
        _, params, _ = nnx.split(model, nnx.Param, ...)
        tx = make_optimizer(params, lr=0.01, max_iters=8)
        return make_train_step(model, tx)

    init_a, step_a = build(0)
    st = init_a()
    for b in batches:
        st, _ = step_a(st, b)
    want, _ = ravel_pytree(nnx.to_pure_dict(st.params))

    init_b, step_b = build(0)
    st_b = init_b()
    for b in batches[:4]:
        st_b, _ = step_b(st_b, b)
    path = checkpoint_path(str(tmp_path), "latest", "m", "synthetic", 16)
    save_checkpoint(path, cur_itrs=int(st_b.step), params=st_b.params,
                    rest=st_b.rest, opt_state=st_b.opt_state, best_score=0.33)

    init_c, step_c = build(1)  # different init — restore must overwrite all
    st_c, best = restore_train_state(path, init_c())
    assert abs(best - 0.33) < 1e-6
    assert int(st_c.step) == 4
    assert int(st_c.opt_state.count) == 4  # poly LR continues, not restarts
    for b in batches[4:]:
        st_c, _ = step_c(st_c, b)
    got, _ = ravel_pytree(nnx.to_pure_dict(st_c.params))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


def test_torch_import_conv_bn_parity():
    """Import a tiny torch conv+bn model and check forward parity."""
    tnet = torch.nn.Sequential(
        torch.nn.Conv2d(3, 8, 3, padding=1, bias=False),
        torch.nn.BatchNorm2d(8),
        torch.nn.ReLU(),
        torch.nn.Conv2d(8, 4, 1),
    ).eval()
    # nnx mirror with same structure (paths 0.weight, 1.*, 3.*)
    from kd_cheap_conv.models.layers import BatchNorm

    class Mirror(nnx.Module):
        def __init__(self, rngs):
            self.layers = nnx.List([
                Conv2d(3, 8, 3, padding=1, use_bias=False, rngs=rngs),
                BatchNorm(8, rngs=rngs),
                None,
                Conv2d(8, 4, 1, rngs=rngs),
            ])

        def __call__(self, x):
            x = self.layers[1](self.layers[0](x))
            x = jax.nn.relu(x)
            return self.layers[3](x)

    m = Mirror(nnx.Rngs(0))
    m.eval()
    sd = {k.replace("", "", 1): v for k, v in tnet.state_dict().items()}
    # torch keys are '0.weight', '1.weight'... ; mirror paths are
    # 'layers.0.weight' — prepend
    sd = {"layers." + k: v for k, v in sd.items()}
    n, missing = import_torch_state_dict(m, sd)
    assert n == 7, (n, missing)  # conv w, bn w/b/mean/var, conv w/b
    x = np.random.RandomState(0).randn(1, 9, 9, 3).astype(np.float32)
    got = np.asarray(m(jnp.asarray(x)))
    want = tnet(torch.from_numpy(x.transpose(0, 3, 1, 2))).detach().numpy()
    np.testing.assert_allclose(got.transpose(0, 3, 1, 2), want,
                               rtol=1e-4, atol=1e-5)


def test_torch_import_full_model_keys():
    """A reference-shaped state dict for our ResNet student maps losslessly."""
    model = build_model("deeplabv3plus_resnet50", num_classes=21)
    # export our own params as a fake torch state dict, then re-import
    from kd_cheap_conv.train.checkpoint import _iter_params

    sd = {}
    for path, (var, kind) in _iter_params(model):
        key = ".".join(str(p) for p in path)
        arr = np.asarray(var[...])
        if kind == "conv_kernel":
            arr = arr.transpose(3, 2, 0, 1)
        elif kind == "linear_kernel":
            arr = arr.T
        sd[key] = torch.from_numpy(np.ascontiguousarray(arr))
    n, missing = import_torch_state_dict(model, sd, strict=True)
    assert n == len(sd) and not missing


def test_checkpoint_restore_with_target_checks_shapes(tmp_path):
    """Restoring into a target validates every entry's shape and dtype and
    returns the target's structure (tuples/NamedTuples included)."""
    path = str(tmp_path / "ck")
    opt = (np.zeros(3, np.float32), {"m": np.ones((2, 2), np.float32)})
    save_checkpoint(path, cur_itrs=2, params={"w": np.ones(4, np.float32)},
                    rest={}, opt_state=opt, best_score=0.5)
    assert sorted(os.listdir(path)) == ["checkpoint.npz"]
    target = {"cur_itrs": np.zeros((), np.int32),
              "model_state": {"params": {"w": np.zeros(4, np.float32)},
                              "rest": {}},
              "optimizer_state": opt,
              "scheduler_state": {"step": np.zeros((), np.int32)},
              "best_score": np.zeros((), np.float32)}
    got = load_checkpoint(path, target=target)
    assert isinstance(got["optimizer_state"], tuple)
    np.testing.assert_array_equal(got["model_state"]["params"]["w"],
                                  np.ones(4))
    bad = dict(target, model_state={"params": {"w": np.zeros(5, np.float32)},
                                    "rest": {}})
    with pytest.raises(ValueError, match="expected"):
        load_checkpoint(path, target=bad)
    missing = dict(target, extra=np.zeros(()))
    with pytest.raises(ValueError, match="no entry"):
        load_checkpoint(path, target=missing)


def test_checkpoint_overwrite_replaces_contents(tmp_path):
    path = str(tmp_path / "ck")
    for itrs in (1, 2):
        save_checkpoint(path, cur_itrs=itrs, params={}, rest={},
                        opt_state=(), best_score=0.0)
    assert int(load_checkpoint(path)["cur_itrs"]) == 2
