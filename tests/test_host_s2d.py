"""Host-side space-to-depth packing (KDCC_HOST_S2D, VERDICT r3 item 5).

The data pipeline packs odd-sized 3-channel images into (N, (H-1)//2+4, .,
12) tensors (ops.conv.s2d_pack); the entry stems consume them through the
exact VALID-conv rewrite (conv2d_s2d_packed). These tests pin exactness
against the stock stride-2 convs and the full backbones/models.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from kd_cheap_conv import config
from kd_cheap_conv.ops.conv import (conv2d_s2d_packed, s2d_orig_size,
                                        s2d_pack)

RNG = np.random.RandomState(42)


def _ref_conv(x, w, stride, pad):
    return jax.lax.conv_general_dilated(
        x, w, window_strides=(stride, stride),
        padding=[(pad, pad), (pad, pad)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"))


@pytest.mark.parametrize("k,pad", [(7, 3), (3, 1)])
@pytest.mark.parametrize("hw", [13, 33])
def test_packed_conv_exact(k, pad, hw):
    x = jnp.asarray(RNG.randn(2, hw, hw, 3), jnp.float32)
    w = jnp.asarray(RNG.randn(k, k, 3, 8) * 0.1, jnp.float32)
    want = _ref_conv(x, w, 2, pad)
    got = conv2d_s2d_packed(s2d_pack(x), w, pad)
    assert got.shape == want.shape
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_pack_numpy_matches_jnp():
    x = RNG.randn(1, 13, 13, 3).astype(np.float32)
    np.testing.assert_array_equal(s2d_pack(x),
                                  np.asarray(s2d_pack(jnp.asarray(x))))


def test_pack_rejects_even():
    with pytest.raises(ValueError):
        s2d_pack(np.zeros((1, 12, 13, 3), np.float32))


def test_orig_size_roundtrip():
    z = s2d_pack(np.zeros((1, 33, 65, 3), np.float32))
    assert s2d_orig_size(z.shape[1], z.shape[2]) == (33, 65)


def test_packed_conv_weight_grads_match():
    """The weight transform inside conv2d_s2d_packed is differentiable —
    entry-conv gradients must match the stock conv's."""
    x = jnp.asarray(RNG.randn(1, 13, 13, 3), jnp.float32)
    w = jnp.asarray(RNG.randn(3, 3, 3, 4) * 0.1, jnp.float32)
    xp = s2d_pack(x)

    g_ref = jax.grad(lambda w: (_ref_conv(x, w, 2, 1) ** 2).sum())(w)
    g_got = jax.grad(
        lambda w: (conv2d_s2d_packed(xp, w, 1) ** 2).sum())(w)
    np.testing.assert_allclose(np.asarray(g_got), np.asarray(g_ref),
                               rtol=1e-4, atol=1e-4)


@pytest.fixture
def host_s2d_on():
    old = config.use_host_s2d
    config.use_host_s2d = True
    try:
        yield
    finally:
        config.use_host_s2d = old


@pytest.mark.parametrize("name", ["deeplabv3plus_resnet50",
                                  "deeplabv3plus_mobilenet",
                                  "deeplabv3plus_xception"])
def test_model_packed_input_parity(name, host_s2d_on):
    """Full model: packed input == normal input (same weights), and the
    logits upsample to the ORIGINAL odd resolution."""
    from kd_cheap_conv import nnx

    from kd_cheap_conv.models import build_model

    model = build_model(name, num_classes=5, output_stride=16,
                        rngs=nnx.Rngs(0))
    model.eval()
    x = jnp.asarray(RNG.randn(1, 33, 33, 3), jnp.float32)

    config.use_host_s2d = False
    want = model(x)
    config.use_host_s2d = True
    got = model(s2d_pack(x))
    assert got.shape == want.shape == (1, 33, 33, 5)
    # full-model float32 parity: the packed conv contracts 12 channels in a
    # different order than the stock 7x7/3x3, so deep-net accumulation noise
    # reaches ~4e-4 abs on O(100) logits
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=5e-3, atol=1e-3)


def test_prefetch_packs_images(host_s2d_on):
    from kd_cheap_conv.data.pipeline import prefetch_to_device

    imgs = RNG.randn(2, 13, 13, 3).astype(np.float32)
    lbls = RNG.randint(0, 5, (2, 13, 13)).astype(np.int32)
    out = list(prefetch_to_device(iter([(imgs, lbls)]), host_s2d=True))
    assert len(out) == 1
    pi, pl = out[0]
    assert pi.shape == (2, 10, 10, 12)
    assert pl.shape == (2, 13, 13)
    np.testing.assert_array_equal(np.asarray(pi), s2d_pack(imgs))
