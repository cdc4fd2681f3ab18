"""Model construction / shape / mode tests (SURVEY.md §4: golden shape tests).

Small inputs keep CPU compile fast; output-stride arithmetic is what's under
test, and it is resolution-independent.
"""

import numpy as np
import pytest
import jax.numpy as jnp
from kd_cheap_conv import nnx

from kd_cheap_conv.models import MODEL_FACTORY, build_model
from kd_cheap_conv.models.layers import set_bn_momentum
from kd_cheap_conv.models.mobilenetv2 import mobilenet_v2
from kd_cheap_conv.models.resnet import resnet50
from kd_cheap_conv.models.xception import xception65


def _x(h=65, w=65, n=1):
    return jnp.asarray(np.random.RandomState(0).randn(n, h, w, 3), jnp.float32)


@pytest.mark.parametrize("os_,want", [(16, 5), (8, 9)])
def test_resnet_output_stride(os_, want):
    m = resnet50(output_stride=os_, rngs=nnx.Rngs(0))
    m.eval()
    f = m(_x())
    assert f["out"].shape == (1, want, want, 2048)
    assert f["low_level"].shape == (1, 17, 17, 256)  # stride 4


@pytest.mark.parametrize("os_,want", [(16, 5), (8, 9)])
def test_mobilenet_output_stride(os_, want):
    m = mobilenet_v2(output_stride=os_, rngs=nnx.Rngs(0))
    m.eval()
    f = m(_x())
    assert f["out"].shape == (1, want, want, 320)
    assert f["low_level"].shape == (1, 17, 17, 24)


@pytest.mark.parametrize("os_,want", [(16, 5), (8, 9)])
def test_xception_output_stride(os_, want):
    m = xception65(output_stride=os_, rngs=nnx.Rngs(0))
    m.eval()
    f = m(_x())
    assert f["out"].shape == (1, want, want, 2048)
    assert f["low_level"].shape == (1, 17, 17, 128)


@pytest.mark.parametrize("name", sorted(MODEL_FACTORY))
def test_factory_end_to_end_logits(name):
    m = build_model(name, num_classes=21, output_stride=16)
    m.eval()
    x = _x(33, 33)
    y = m(x)
    assert y.shape == (1, 33, 33, 21)
    assert bool(jnp.isfinite(y).all())


def test_return_features_taps():
    m = build_model("deeplabv3plus_mobilenet", num_classes=19)
    m.eval()
    logits, taps = m(_x(33, 33), return_features=True)
    assert logits.shape == (1, 33, 33, 19)
    assert set(taps) == {"low_level", "out", "head"}
    assert taps["head"].shape[-1] == 256


def test_train_eval_bn_modes():
    m = build_model("deeplabv3plus_mobilenet", num_classes=21)
    x = _x(33, 33)
    m.train()
    y1 = m(x)
    m.eval()
    y2 = m(x)
    # BN running stats moved during the train call -> eval differs from train
    assert not np.allclose(np.asarray(y1), np.asarray(y2))


def test_set_bn_momentum():
    m = build_model("deeplabv3plus_resnet50", num_classes=21)
    set_bn_momentum(m.backbone, 0.01)
    mom = {mm.momentum for _, mm in nnx.iter_modules(m.backbone)
           if isinstance(mm, nnx.BatchNorm)}
    assert mom == {0.99}


@pytest.mark.slow
def test_bf16_compute_dtype():
    m = build_model("deeplabv3plus_mobilenet", num_classes=21, dtype=jnp.bfloat16)
    m.eval()
    y = m(_x(33, 33).astype(jnp.bfloat16))
    assert y.dtype == jnp.bfloat16
    assert bool(jnp.isfinite(y.astype(jnp.float32)).all())


def test_class_major_logits_match_nhwc():
    m = build_model("deeplabv3plus_mobilenet", num_classes=7)
    m.eval()
    x = _x(33, 33)
    nhwc = m(x)
    nchw = m(x, class_major=True)
    np.testing.assert_allclose(np.asarray(nchw),
                               np.asarray(nhwc).transpose(0, 3, 1, 2),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("separable", [False, True])
def test_split_decoder_concat_parity(separable, monkeypatch):
    """fuse(cat(low, up)) == fuseA(low) + fuseB(up): the concat-split decoder
    (models/deeplab.py _call_split_fuse) is exact algebra for dense and
    separable fuse convs, in train mode (same BN moments) and for taps."""
    from kd_cheap_conv import config
    from kd_cheap_conv.kd import replace_cheap_convs
    from kd_cheap_conv.kd.replace import CheapConvSpec

    def build():
        m = build_model("deeplabv3plus_mobilenet", num_classes=7,
                        rngs=nnx.Rngs(3))
        if separable:
            replace_cheap_convs(m, CheapConvSpec(kind="separable"),
                                scope="classifier")
        m.train()
        return m

    x = _x(65, 65, n=2)
    monkeypatch.setattr(config, "split_decoder_concat", False)
    m1 = build()
    y1, taps1 = m1(x, return_features=True)
    monkeypatch.setattr(config, "split_decoder_concat", True)
    m2 = build()
    assert m2.classifier._split_fuse_kind() == (
        "separable" if separable else "dense")
    y2, taps2 = m2(x, return_features=True)
    np.testing.assert_allclose(np.asarray(y1), np.asarray(y2),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(taps1["head"]),
                               np.asarray(taps2["head"]),
                               rtol=1e-5, atol=1e-5)
    # train-mode BN batch stats advanced identically
    np.testing.assert_allclose(
        np.asarray(m1.classifier.fuse.bn.mean[...]),
        np.asarray(m2.classifier.fuse.bn.mean[...]), rtol=1e-5, atol=1e-6)


def test_split_decoder_grouped_falls_back():
    """Grouped cheap convs straddle the 48/256 split — must NOT split."""
    from kd_cheap_conv.kd import replace_cheap_convs
    from kd_cheap_conv.kd.replace import CheapConvSpec

    m = build_model("deeplabv3plus_mobilenet", num_classes=7, rngs=nnx.Rngs(3))
    replace_cheap_convs(m, CheapConvSpec(kind="grouped", groups=4),
                        scope="classifier")
    assert m.classifier._split_fuse_kind() is None
    m.train()
    y = m(_x(65, 65))
    assert np.isfinite(np.asarray(y)).all()


def test_split_decoder_grad_parity():
    """Gradients through the split decoder match the concat path to f64
    precision (measured 1.5e-15 max relative L2). In f32 the two contraction
    orders diverge by up to ~2e-3 relative on far-upstream leaves — pure
    reassociation noise amplified through ~20 layers of chain rule — so the
    airtight check runs in x64, where any real backward bug would still show
    as O(1)."""
    import contextlib

    import jax

    from kd_cheap_conv import config

    @contextlib.contextmanager
    def enable_x64():
        jax.config.update("jax_enable_x64", True)
        try:
            yield
        finally:
            jax.config.update("jax_enable_x64", False)

    def _c64(a):
        try:
            if hasattr(a, "dtype") and jnp.issubdtype(a.dtype, jnp.floating):
                return jnp.asarray(np.asarray(a), jnp.float64)
        except TypeError:
            pass
        return a

    def loss_for(split):
        orig = config.split_decoder_concat
        config.split_decoder_concat = split
        try:
            m = build_model("deeplabv3plus_mobilenet", num_classes=7,
                            rngs=nnx.Rngs(3))
            m.eval()  # plain jax.grad can't mutate BatchStat (NOTES.md)
            graphdef, params, rest = nnx.split(m, nnx.Param, ...)
            params = jax.tree.map(_c64, params)
            rest = jax.tree.map(_c64, rest)
            x = jnp.asarray(np.random.RandomState(0).randn(2, 33, 33, 3),
                            jnp.float64)

            def f(params):
                mm = nnx.merge(graphdef, params, rest)
                return jnp.mean(mm(x) ** 2)

            return jax.grad(f)(params)
        finally:
            config.split_decoder_concat = orig

    with enable_x64():
        g0 = loss_for(False)
        g1 = loss_for(True)
    flat0 = jax.tree.leaves(g0)
    flat1 = jax.tree.leaves(g1)
    assert len(flat0) == len(flat1)
    for a, b in zip(flat0, flat1):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        denom = np.linalg.norm(a) + 1e-300
        assert np.linalg.norm(a - b) / denom < 1e-12


def test_resnet_s2d_stem_parity():
    """KDCC_S2D_STEM: the space-to-depth 4x4 rewrite of the 7x7/s2 stem is
    numerically the stock stem (values and grads), odd and even inputs."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from kd_cheap_conv import nnx

    from kd_cheap_conv import config
    from kd_cheap_conv.models.resnet import resnet50

    m = resnet50(output_stride=16, rngs=nnx.Rngs(0))
    assert not m._stem_s2d_active()
    old = config.use_s2d_stem
    try:
        config.use_s2d_stem = True
        assert m._stem_s2d_active()
        for hw in (33, 32):
            x = jnp.asarray(np.random.RandomState(hw).randn(2, hw, hw, 3),
                            jnp.float32)
            want = m.stem(x)
            got = m._stem_s2d(x)
            assert got.shape == want.shape
            np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                       rtol=1e-4, atol=1e-4)
        x = jnp.asarray(np.random.RandomState(7).randn(1, 17, 17, 3),
                        jnp.float32)
        m.eval()   # running-stat BN: no BatchStat mutation under jax.grad
        g1 = jax.grad(lambda x: jnp.sum(m._stem_s2d(x) ** 2))(x)
        g2 = jax.grad(lambda x: jnp.sum(m.stem(x) ** 2))(x)
        np.testing.assert_allclose(np.asarray(g1), np.asarray(g2),
                                   rtol=1e-3, atol=1e-4)
    finally:
        config.use_s2d_stem = old


def test_aspp_concat_split_parity():
    """KDCC_SPLIT_ASPP: project(cat(branches)) == sum of per-branch
    projections — values, grads, and the project BN batch stats."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from kd_cheap_conv import nnx

    from kd_cheap_conv import config
    from kd_cheap_conv.models.aspp import ASPP

    def build():
        return ASPP(32, (2, 4, 6), out_channels=16, dropout_rate=0.0,
                    rngs=nnx.Rngs(0))

    x = jnp.asarray(np.random.RandomState(5).randn(2, 9, 9, 32), jnp.float32)

    def loss(m, x):
        return jnp.sum(m(x).astype(jnp.float32) ** 2)

    ref, split = build(), build()
    old = config.split_aspp_concat
    try:
        config.split_aspp_concat = False
        v_ref, g_ref = nnx.value_and_grad(loss)(ref, x)
        config.split_aspp_concat = True
        assert split._split_project_ok()
        v_split, g_split = nnx.value_and_grad(loss)(split, x)
    finally:
        config.split_aspp_concat = old
    np.testing.assert_allclose(float(v_split), float(v_ref), rtol=1e-5)
    # grads: split-sum vs concat changes f32 contraction order; pure
    # reassociation noise (see test_split_decoder_grad_parity's f64 study)
    for a, b in zip(jax.tree.leaves(g_split), jax.tree.leaves(g_ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=5e-3, atol=1e-4)
    np.testing.assert_allclose(np.asarray(split.project.bn.mean[...]),
                               np.asarray(ref.project.bn.mean[...]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(split.project.bn.var[...]),
                               np.asarray(ref.project.bn.var[...]),
                               rtol=1e-5, atol=1e-6)


def test_xception_conv1_s2d_parity():
    import numpy as np
    import jax.numpy as jnp
    from kd_cheap_conv import nnx

    from kd_cheap_conv import config
    from kd_cheap_conv.models.xception import Xception65

    m = Xception65(output_stride=16, rngs=nnx.Rngs(0))
    m.eval()
    x = jnp.asarray(np.random.RandomState(2).randn(1, 65, 65, 3),
                    jnp.float32)
    old = config.use_s2d_stem
    try:
        config.use_s2d_stem = False
        want = m(x)
        config.use_s2d_stem = True
        assert m._conv1_s2d_active()
        got = m(x)
    finally:
        config.use_s2d_stem = old
    for k in ("low_level", "out"):
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=5e-4, atol=5e-4, err_msg=k)
