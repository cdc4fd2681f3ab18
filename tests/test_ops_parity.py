"""Op-level numerics parity vs torch CPU (the parity oracle; SURVEY.md §4).

Covers the conv surface the models need: dense 3x3, stride-2, dilated/atrous,
depthwise, grouped, 1x1; bilinear resize up/down (align_corners False/True);
CE/focal/KL losses vs torch functional equivalents.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from kd_cheap_conv.ops import conv2d, depthwise_conv2d, resize_bilinear
from kd_cheap_conv.ops.conv import fixed_padding
from kd_cheap_conv.ops.losses import (
    cross_entropy,
    focal_loss,
    hint_l2_loss,
    kd_kl_loss,
)

RNG = np.random.RandomState(0)


def _nchw(x_nhwc):
    return torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))


def _oihw(w_hwio):
    # HWIO (kh,kw,ci,co) -> OIHW (co,ci,kh,kw)
    return torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))


def _assert_close(jax_nhwc, torch_nchw, tol=1e-4):
    got = np.asarray(jax_nhwc).transpose(0, 3, 1, 2)
    want = torch_nchw.numpy()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize(
    "cin,cout,k,stride,pad,dil,groups",
    [
        (8, 16, 3, 1, 1, 1, 1),      # dense 3x3
        (8, 16, 3, 2, 1, 1, 1),      # stride-2 (torch pad=1, not XLA SAME)
        (8, 16, 3, 1, 6, 6, 1),      # ASPP atrous rate 6
        (8, 16, 3, 1, 12, 12, 1),    # ASPP atrous rate 12
        (16, 16, 3, 1, 1, 1, 16),    # depthwise
        (16, 16, 3, 2, 1, 1, 16),    # depthwise stride-2 (MobileNetV2)
        (16, 32, 3, 1, 1, 1, 4),     # grouped (cheap-conv variant)
        (8, 16, 1, 1, 0, 1, 1),      # pointwise
        (8, 16, 7, 2, 3, 1, 1),      # ResNet stem
    ],
)
def test_conv2d_matches_torch(cin, cout, k, stride, pad, dil, groups):
    x = RNG.randn(2, 17, 19, cin).astype(np.float32)
    w = (RNG.randn(k, k, cin // groups, cout) * 0.1).astype(np.float32)
    b = RNG.randn(cout).astype(np.float32)
    got = conv2d(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        stride=stride, padding=pad, dilation=dil, groups=groups,
    )
    want = F.conv2d(
        _nchw(x), _oihw(w), torch.from_numpy(b),
        stride=stride, padding=pad, dilation=dil, groups=groups,
    )
    _assert_close(got, want)


def test_depthwise_helper():
    x = RNG.randn(1, 9, 9, 8).astype(np.float32)
    w = RNG.randn(3, 3, 1, 8).astype(np.float32)
    got = depthwise_conv2d(jnp.asarray(x), jnp.asarray(w), padding=1)
    want = F.conv2d(_nchw(x), _oihw(w), padding=1, groups=8)
    _assert_close(got, want)


def test_fixed_padding_stride2_alignment():
    # Xception fixed_padding: pad 'SAME'-style then VALID conv; output spatial
    # must be ceil(H/2) regardless of parity.
    for h in (15, 16):
        x = jnp.asarray(RNG.randn(1, h, h, 4).astype(np.float32))
        w = jnp.asarray(RNG.randn(3, 3, 4, 4).astype(np.float32))
        y = conv2d(fixed_padding(x, 3, 3), w, stride=2, padding=0)
        assert y.shape[1] == (h + 1) // 2


@pytest.mark.parametrize("size", [(34, 38), (9, 10), (68, 76), (513, 513)])
def test_bilinear_resize_matches_torch_half_pixel(size):
    x = RNG.randn(2, 17, 19, 5).astype(np.float32)
    got = resize_bilinear(jnp.asarray(x), size)
    want = F.interpolate(_nchw(x), size=size, mode="bilinear", align_corners=False)
    _assert_close(got, want, tol=1e-4)


@pytest.mark.parametrize("size", [(34, 38), (68, 76), (129, 129), (9, 10)])
def test_bilinear_resize_matmul_matches_torch(size):
    # the NHWC-preserving matmul form used by the decoder upsample
    # (ops.resize.resize_bilinear_matmul) is the same half-pixel operator
    from kd_cheap_conv.ops.resize import resize_bilinear_matmul

    x = RNG.randn(2, 17, 19, 5).astype(np.float32)
    got = resize_bilinear_matmul(jnp.asarray(x), size)
    want = F.interpolate(_nchw(x), size=size, mode="bilinear",
                         align_corners=False)
    _assert_close(got, want, tol=1e-4)


def test_bilinear_resize_matmul_grad_matches_resize_grad():
    import jax

    from kd_cheap_conv.ops.resize import resize_bilinear_matmul

    x = jnp.asarray(RNG.randn(2, 9, 9, 4).astype(np.float32))
    g1 = jax.grad(lambda t: jnp.sum(jnp.sin(
        resize_bilinear(t, (33, 33)))))(x)
    g2 = jax.grad(lambda t: jnp.sum(jnp.sin(
        resize_bilinear_matmul(t, (33, 33)))))(x)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("size", [(34, 38), (9, 10)])
def test_bilinear_resize_align_corners_true(size):
    x = RNG.randn(2, 17, 19, 5).astype(np.float32)
    got = resize_bilinear(jnp.asarray(x), size, align_corners=True)
    want = F.interpolate(_nchw(x), size=size, mode="bilinear", align_corners=True)
    _assert_close(got, want, tol=1e-4)


def test_cross_entropy_matches_torch_with_ignore():
    logits = RNG.randn(2, 7, 7, 21).astype(np.float32)
    labels = RNG.randint(0, 21, size=(2, 7, 7)).astype(np.int32)
    labels[0, :2, :3] = 255
    got = cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    want = F.cross_entropy(
        _nchw(logits), torch.from_numpy(labels.astype(np.int64)), ignore_index=255
    )
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-6)


def test_kd_kl_matches_torch():
    t = 4.0
    s = RNG.randn(2, 5, 5, 21).astype(np.float32)
    te = RNG.randn(2, 5, 5, 21).astype(np.float32)
    got = kd_kl_loss(jnp.asarray(s), jnp.asarray(te), temperature=t)
    st = _nchw(s) / t
    tt = _nchw(te) / t
    # torch: KLDiv(log_softmax(s), softmax(t)) per pixel, mean over pixels * T^2
    kl = F.kl_div(
        F.log_softmax(st, dim=1), F.softmax(tt, dim=1), reduction="none"
    ).sum(1)
    want = float(kl.mean() * t * t)
    np.testing.assert_allclose(float(got), want, rtol=1e-5, atol=1e-6)


def test_kd_kl_nonnegative_and_zero_at_match():
    z = jnp.asarray(RNG.randn(1, 4, 4, 19).astype(np.float32))
    assert float(kd_kl_loss(z, z, temperature=2.0)) == pytest.approx(0.0, abs=1e-6)
    # uniform shifts leave softmax unchanged (KL stays ~0); perturb unevenly
    z2 = z.at[..., 0].add(1.0)
    assert float(kd_kl_loss(z2, z, temperature=2.0)) > 1e-4


def test_kd_kl_extreme_teacher_logits_finite():
    # untrained eval-mode teachers emit |logits| ~ 1e6; KL and its grad must
    # stay finite (fused exp range-reduction edge; see ops.losses)
    import jax

    s = jnp.asarray(RNG.randn(1, 8, 8, 21).astype(np.float32) * 5)
    t = jnp.asarray(RNG.randn(1, 8, 8, 21).astype(np.float32) * 3.6e6)
    v, g = jax.value_and_grad(
        lambda s: kd_kl_loss(s, t, temperature=4.0))(s)
    assert np.isfinite(float(v))
    assert bool(jnp.isfinite(g).all())


def test_focal_reduces_to_ce_at_gamma0():
    logits = RNG.randn(2, 6, 6, 19).astype(np.float32)
    labels = RNG.randint(0, 19, size=(2, 6, 6)).astype(np.int32)
    fl = focal_loss(jnp.asarray(logits), jnp.asarray(labels), gamma=0.0)
    ce = cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(float(fl), float(ce), rtol=1e-6)


def test_hint_l2():
    a = jnp.asarray(RNG.randn(1, 4, 4, 8).astype(np.float32))
    b = jnp.asarray(RNG.randn(1, 4, 4, 8).astype(np.float32))
    want = float(((np.asarray(a) - np.asarray(b)) ** 2).mean())
    np.testing.assert_allclose(float(hint_l2_loss(a, b)), want, rtol=1e-6)


def test_losses_channel_axis_equivalence():
    logits = RNG.randn(2, 6, 6, 19).astype(np.float32)
    labels = RNG.randint(0, 19, size=(2, 6, 6)).astype(np.int32)
    labels[0, 0, :2] = 255
    lo = jnp.asarray(logits)
    lo_cm = jnp.transpose(lo, (0, 3, 1, 2))
    la = jnp.asarray(labels)
    np.testing.assert_allclose(
        float(cross_entropy(lo, la)),
        float(cross_entropy(lo_cm, la, channel_axis=1)), rtol=1e-6)
    t = lo + 0.3
    t_cm = jnp.transpose(t, (0, 3, 1, 2))
    np.testing.assert_allclose(
        float(kd_kl_loss(lo, t, temperature=3.0, labels=la)),
        float(kd_kl_loss(lo_cm, t_cm, temperature=3.0, labels=la,
                         channel_axis=1)), rtol=1e-6)
    np.testing.assert_allclose(
        float(focal_loss(lo, la)),
        float(focal_loss(lo_cm, la, channel_axis=1)), rtol=1e-6)


def test_conv2d_gemm_matches_conv2d():
    from kd_cheap_conv.ops.conv import conv2d_gemm

    for (ci, co, d) in [(8, 16, 1), (8, 16, 2), (16, 8, 6)]:
        x = RNG.randn(2, 19, 21, ci).astype(np.float32)
        w = (RNG.randn(3, 3, ci, co) * 0.1).astype(np.float32)
        b = RNG.randn(co).astype(np.float32)
        got = conv2d_gemm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                          padding=d, dilation=d)
        want = conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                      stride=1, padding=d, dilation=d)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


def test_conv2d_gemm_grad_matches():
    import jax
    from kd_cheap_conv.ops.conv import conv2d_gemm

    x = jnp.asarray(RNG.randn(1, 9, 9, 8).astype(np.float32))
    w = jnp.asarray((RNG.randn(3, 3, 8, 8) * 0.1).astype(np.float32))
    g1 = jax.grad(lambda x, w: (conv2d_gemm(x, w, padding=2, dilation=2) ** 2
                                ).mean(), argnums=(0, 1))(x, w)
    g2 = jax.grad(lambda x, w: (conv2d(x, w, stride=1, padding=2, dilation=2)
                                ** 2).mean(), argnums=(0, 1))(x, w)
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-5)
