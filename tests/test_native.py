"""Native host-ops (C/ctypes) parity vs the numpy reference path."""

import numpy as np
import pytest

from kd_cheap_conv import native

RNG = np.random.RandomState(0)

requires_native = pytest.mark.skipif(native.lib() is None,
                                     reason="no C toolchain")


@requires_native
def test_remap_matches_numpy():
    table = RNG.randint(0, 256, 256).astype(np.uint8)
    labels = RNG.randint(0, 256, (123, 77)).astype(np.uint8)
    got = native.remap_u8(labels, table)
    np.testing.assert_array_equal(got, table[labels])


@requires_native
def test_normalize_matches_numpy():
    img = RNG.randint(0, 256, (57, 63, 3)).astype(np.uint8)
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    got = native.normalize_u8_f32(img, mean, std)
    want = (img.astype(np.float32) / 255.0 - mean) / std
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@requires_native
def test_hflip_matches_numpy():
    img = RNG.randint(0, 256, (20, 31, 3)).astype(np.uint8)
    lbl = RNG.randint(0, 256, (20, 31)).astype(np.uint8)
    np.testing.assert_array_equal(native.hflip_u8(img), img[:, ::-1])
    np.testing.assert_array_equal(native.hflip_u8(lbl), lbl[:, ::-1])


def test_fused_transform_uses_same_math():
    from kd_cheap_conv.data.transforms import (
        ExtNormalize, ExtToArray, ExtToNormalizedArray)

    img = RNG.randint(0, 256, (33, 35, 3)).astype(np.uint8)
    lbl = RNG.randint(0, 21, (33, 35)).astype(np.uint8)
    fused_img, fused_lbl = ExtToNormalizedArray()(img, lbl)
    a, l2 = ExtToArray()(img, lbl)
    ref_img, _ = ExtNormalize()(a, l2)
    np.testing.assert_allclose(fused_img, ref_img, rtol=1e-5, atol=1e-6)
    assert fused_lbl.dtype == np.int32


def test_cityscapes_encode_still_correct():
    from kd_cheap_conv.data.cityscapes import encode_target

    raw = np.arange(34, dtype=np.uint8).reshape(2, 17)
    enc = encode_target(raw)
    # road(7)->0, tunnel(16)->void, bicycle(33)->18
    assert enc[0, 7] == 0 and enc[0, 16] == 255 and enc[1, 16] == 18
