"""KD layer tests: cheap-conv surgery, factorized init fidelity, KD train
steps (live + cached teacher), optimizer groups, progressive freezing.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
from kd_cheap_conv import nnx

from kd_cheap_conv.kd import (
    KDConfig,
    backbone_stages,
    convert_to_separable_conv,
    replace_cheap_convs,
)
from kd_cheap_conv.kd.distill import make_hint_adapters
from kd_cheap_conv.kd.replace import AtrousSeparableConvolution, CheapConvSpec
from kd_cheap_conv.models import build_model
from kd_cheap_conv.models.layers import Conv2d
from kd_cheap_conv.train import make_kd_train_step, make_optimizer, make_train_step

RNG = np.random.RandomState(0)


def _count_convs(model, pred):
    return sum(1 for _, m in nnx.iter_modules(model) if pred(m))


@pytest.mark.slow
def test_replace_all_dense_convs_with_separable():
    m = build_model("deeplabv3plus_mobilenet", num_classes=21)
    before = _count_convs(
        m, lambda x: isinstance(x, Conv2d) and max(x.kernel_size) > 1 and x.groups == 1
    )
    assert before > 0
    replaced = replace_cheap_convs(m, CheapConvSpec(kind="separable"))
    assert len(replaced) == before
    after = _count_convs(
        m, lambda x: isinstance(x, Conv2d) and max(x.kernel_size) > 1 and x.groups == 1
    )
    assert after == 0
    m.eval()
    y = m(jnp.zeros((1, 33, 33, 3)))
    assert y.shape == (1, 33, 33, 21)


def test_separable_factorization_approximates_rank1_kernel():
    # If the dense kernel IS separable (rank-1 per input channel), the
    # factorized replacement must reproduce it exactly.
    rngs = nnx.Rngs(0)
    conv = Conv2d(4, 8, 3, padding=1, use_bias=True, rngs=rngs)
    d = RNG.randn(3, 3, 4)
    p = RNG.randn(4, 8)
    conv.kernel[...] = jnp.asarray(
        d[:, :, :, None] * p[None, None], jnp.float32
    )
    holder = nnx.Dict(conv=conv)
    replace_cheap_convs(holder, CheapConvSpec(kind="separable", init="factorize"))
    new = holder["conv"]
    assert isinstance(new, AtrousSeparableConvolution)
    x = jnp.asarray(RNG.randn(1, 9, 9, 4), jnp.float32)
    np.testing.assert_allclose(
        np.asarray(new(x)),
        np.asarray(conv(x)),
        rtol=1e-3, atol=1e-3,
    )


def test_grouped_replacement_runs_and_inherits_blockdiag():
    rngs = nnx.Rngs(0)
    conv = Conv2d(8, 16, 3, padding=1, use_bias=False, rngs=rngs)
    holder = nnx.Dict(conv=conv)
    replace_cheap_convs(holder, CheapConvSpec(kind="grouped", groups=4))
    new = holder["conv"]
    assert new.groups == 4
    assert new.kernel[...].shape == (3, 3, 2, 16)
    x = jnp.asarray(RNG.randn(1, 9, 9, 8), jnp.float32)
    assert new(x).shape == (1, 9, 9, 16)


def test_convert_to_separable_conv_reference_shim():
    m = build_model("deeplabv3_mobilenet", num_classes=21)
    convert_to_separable_conv(m.classifier)
    # backbone untouched, classifier fully separable
    dense_in_head = _count_convs(
        m.classifier,
        lambda x: isinstance(x, Conv2d) and max(x.kernel_size) > 1 and x.groups == 1,
    )
    assert dense_in_head == 0


def test_scope_limits_replacement():
    m = build_model("deeplabv3plus_resnet50", num_classes=21)
    replaced = replace_cheap_convs(m, scope="backbone.layer4")
    assert replaced and all(r.startswith("backbone.layer4") for r in replaced)
    # layer3 still has dense 3x3 convs
    dense_l3 = _count_convs(
        m.backbone.layer3,
        lambda x: isinstance(x, Conv2d) and max(x.kernel_size) > 1 and x.groups == 1,
    )
    assert dense_l3 > 0


def test_backbone_stages_exist_for_all_families():
    # ResNet stages are dense 3x3 bottlenecks: every stage must be replaceable.
    m = build_model("deeplabv3plus_resnet50", num_classes=21)
    stages = backbone_stages(m)
    assert len(stages) == 4
    for stage in stages:
        assert replace_cheap_convs(m, scope=stage), f"stage {stage} empty"
    # MobileNetV2/Xception backbones are already depthwise-separable — stages
    # exist for schedule bookkeeping, but contain no dense convs to replace
    # (the cheap-conv surface there is the dense DeepLab head; see config #2).
    for name in ("deeplabv3plus_mobilenet", "deeplabv3plus_xception"):
        m = build_model(name, num_classes=21)
        stages = backbone_stages(m)
        assert len(stages) >= 4
        head_replaced = replace_cheap_convs(m, scope="classifier")
        assert head_replaced, f"{name} head had nothing to replace"


def _tiny_batch(n=2, hw=33, classes=21):
    images = jnp.asarray(RNG.randn(n, hw, hw, 3), jnp.float32)
    labels = jnp.asarray(RNG.randint(0, classes, (n, hw, hw)), jnp.int32)
    return images, labels


@pytest.mark.slow
def test_kd_step_live_teacher_loss_decreases():
    teacher = build_model("deeplabv3plus_mobilenet", num_classes=21, rngs=nnx.Rngs(0))
    student = build_model("deeplabv3plus_mobilenet", num_classes=21, rngs=nnx.Rngs(1))
    replace_cheap_convs(student, CheapConvSpec(kind="separable"))
    cfg = KDConfig(temperature=2.0, alpha=0.5, beta=0.5, gamma=0.1,
                   hint_taps=("out",))
    adapters = make_hint_adapters(student, teacher, cfg.hint_taps,
                                  input_hw=(33, 33))
    _, params, _ = nnx.split(student, nnx.Param, ...)
    _, a_params = nnx.split(adapters, nnx.Param)
    tx = make_optimizer({"student": params, "adapters": a_params},
                        lr=0.05, max_iters=100,
                        label_fn=lambda d: "head")
    init, step, t_state = make_kd_train_step(student, teacher, tx, cfg,
                                             adapters=adapters)
    state = init()
    batch = _tiny_batch()
    losses = []
    # momentum SGD at this lr overshoots for ~3 steps before descending;
    # 8 steps shows the downward trend reliably
    for _ in range(8):
        state, metrics = step(state, batch, t_state)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0]
    assert int(state.step) == 8
    assert all(np.isfinite(losses))


def test_kd_step_cached_teacher():
    student = build_model("deeplabv3plus_mobilenet", num_classes=21, rngs=nnx.Rngs(1))
    cfg = KDConfig(temperature=4.0, alpha=0.5, beta=0.5)
    _, params, _ = nnx.split(student, nnx.Param, ...)
    tx = make_optimizer({"student": params}, lr=0.01, max_iters=100,
                        label_fn=lambda d: "head")
    init, step, t_state = make_kd_train_step(student, None, tx, cfg,
                                             cached_teacher=True)
    assert t_state == ()
    images, labels = _tiny_batch()
    cached = jnp.asarray(RNG.randn(2, 33, 33, 21), jnp.float32)
    state = init()
    losses = []
    for _ in range(8):
        state, metrics = step(state, (images, labels, cached), t_state)
        losses.append(float(metrics["loss"]))
    # tiny-batch BN+SGD is chaotic (backend-dependent trajectories from f32
    # reassociation) — assert the run LEARNS, not a specific step ordering
    assert min(losses[1:]) < losses[0]
    assert np.isfinite(losses).all()


def test_cached_teacher_with_hints_rejected():
    student = build_model("deeplabv3plus_mobilenet", num_classes=21)
    cfg = KDConfig(hint_taps=("out",))
    with pytest.raises(ValueError):
        make_kd_train_step(student, None, optax.sgd(0.1), cfg, cached_teacher=True)


@pytest.mark.slow
def test_progressive_freeze_only_updates_stage():
    student = build_model("deeplabv3plus_resnet50", num_classes=21)
    stage = ("backbone.layer4",)
    replace_cheap_convs(student, scope=stage)
    _, params, _ = nnx.split(student, nnx.Param, ...)
    tx = make_optimizer(
        {"student": params}, lr=0.1, max_iters=100,
        label_fn=lambda d: (
            "head" if any(d.startswith("student." + p) for p in stage) else "frozen"
        ),
    )
    teacher = build_model("deeplabv3plus_resnet50", num_classes=21, rngs=nnx.Rngs(9))
    cfg = KDConfig()
    init, step, t_state = make_kd_train_step(student, teacher, tx, cfg)
    state = init()
    # materialize host copies: the step donates its input state buffers
    before = jax.tree.map(lambda x: np.asarray(x).copy(), state.params)
    state, _ = step(state, _tiny_batch(), t_state)

    def _changed(path, a, b):
        return not np.allclose(np.asarray(a), np.asarray(b))

    flat_before = jax.tree_util.tree_flatten_with_path(before)[0]
    flat_after = jax.tree_util.tree_flatten_with_path(state.params)[0]
    changed_paths = {
        ".".join(str(getattr(k, "key", getattr(k, "name", k))) for k in pa)
        for (pa, a), (_, b) in zip(flat_before, flat_after)
        if _changed(pa, a, b)
    }
    assert changed_paths, "stage params should update"
    for p in changed_paths:
        assert "layer4" in p, f"frozen param updated: {p}"


def test_supervised_train_step():
    m = build_model("deeplabv3plus_mobilenet", num_classes=21)
    _, params, _ = nnx.split(m, nnx.Param, ...)
    tx = make_optimizer(params, lr=0.01, max_iters=100)
    init, step = make_train_step(m, tx)
    state = init()
    batch = _tiny_batch()
    losses = []
    for _ in range(8):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    # see test_kd_step_cached_teacher: trajectory order is chaotic on tiny
    # batches; learning (some step improves on step 0) is the invariant
    assert min(losses[1:]) < losses[0]
    assert np.isfinite(losses).all()


def test_step_lr_schedule():
    from kd_cheap_conv.train.optim import poly_schedule, step_schedule
    s = step_schedule(0.1, step_size=100, gamma=0.1)
    assert float(s(0)) == pytest.approx(0.1)
    assert float(s(99)) == pytest.approx(0.1)
    assert float(s(100)) == pytest.approx(0.01)
    assert float(s(250)) == pytest.approx(0.001)
    p = poly_schedule(0.1, max_iters=100, power=0.9)
    assert float(p(0)) == pytest.approx(0.1)
    assert float(p(100)) == pytest.approx(0.0)


def test_fused_sgd_matches_multi_transform():
    m = build_model("deeplabv3plus_mobilenet", num_classes=6)
    _, params, _ = nnx.split(m, nnx.Param, ...)
    grads = jax.tree.map(lambda p: jnp.ones_like(p) * 0.01, params)

    kw = dict(lr=0.02, max_iters=100, weight_decay=1e-4)
    tx_f = make_optimizer(params, fused=True, **kw)
    tx_u = make_optimizer(params, fused=False, **kw)
    sf, su = tx_f.init(params), tx_u.init(params)
    p_f = p_u = params
    import optax
    for _ in range(3):
        uf, sf = tx_f.update(grads, sf, p_f)
        uu, su = tx_u.update(grads, su, p_u)
        p_f = optax.apply_updates(p_f, uf)
        p_u = optax.apply_updates(p_u, uu)
    for a, b in zip(jax.tree.leaves(p_f), jax.tree.leaves(p_u)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-7)


def test_fused_sgd_respects_frozen_group():
    m = build_model("deeplabv3plus_mobilenet", num_classes=6)
    _, params, _ = nnx.split(m, nnx.Param, ...)
    grads = jax.tree.map(lambda p: jnp.ones_like(p), params)
    tx = make_optimizer(params, lr=0.1, max_iters=10,
                        label_fn=lambda d: ("head" if d.startswith("classifier")
                                            else "frozen"))
    st = tx.init(params)
    upd, _ = tx.update(grads, st, params)
    flat = jax.tree_util.tree_flatten_with_path(upd)[0]
    for path, u in flat:
        dotted = ".".join(str(getattr(k, "key", getattr(k, "name", k)))
                          for k in path)
        if dotted.startswith("classifier"):
            assert float(jnp.abs(u).max()) > 0
        else:
            assert float(jnp.abs(u).max()) == 0, dotted


@pytest.mark.slow
def test_kd_step_xception_teacher_smoke():
    """Config #3 shape: Xception-65 teacher -> separable student (tiny)."""
    teacher = build_model("deeplabv3plus_xception", num_classes=6,
                          rngs=nnx.Rngs(0))
    student = build_model("deeplabv3plus_mobilenet", num_classes=6,
                          rngs=nnx.Rngs(1))
    replace_cheap_convs(student, CheapConvSpec(kind="separable"),
                        scope="classifier")
    cfg = KDConfig(temperature=4.0, alpha=0.5, beta=0.5)
    _, params, _ = nnx.split(student, nnx.Param, ...)
    tx = make_optimizer({"student": params}, lr=0.005, max_iters=10,
                        label_fn=lambda d: "head")
    init, step, t_state = make_kd_train_step(student, teacher, tx, cfg)
    state = init()
    images = jnp.asarray(RNG.randn(2, 33, 33, 3), jnp.float32)
    labels = jnp.asarray(RNG.randint(0, 6, (2, 33, 33)), jnp.int32)
    state, metrics = step(state, (images, labels), t_state)
    assert np.isfinite(float(metrics["loss"]))
