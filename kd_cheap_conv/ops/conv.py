"""2-D convolution wrappers.

Everything is NHWC / HWIO (channels-last, the layout cuDNN's tensor-core
convolutions prefer). The reference's conv surface
(dense, dilated/atrous, depthwise, grouped; torch-style symmetric integer
padding) is reproduced on top of a single `lax.conv_general_dilated` call.

Capability contract: BASELINE.json:5 (north_star) — "ASPP dilated convs",
"replaced cheap-conv blocks (depthwise-separable / grouped convs)".
Numerics are pinned to torch.nn.functional.conv2d by tests/test_ops_parity.py.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import jax
import jax.numpy as jnp
from jax import lax

# NHWC activations, HWIO kernels. HWIO = (kh, kw, in_ch // groups, out_ch).
DIMENSION_NUMBERS = ("NHWC", "HWIO", "NHWC")
# Channel-major alternative for the low-channel/high-resolution MobileNetV2
# stem stages (KDCC_STEM_CM).
DIMENSION_NUMBERS_NCHW = ("NCHW", "HWIO", "NCHW")


def _pair(v) -> tuple[int, int]:
    if isinstance(v, (tuple, list)):
        a, b = v
        return int(a), int(b)
    return int(v), int(v)


def torch_conv_padding(padding) -> tuple[tuple[int, int], tuple[int, int]]:
    """torch-style symmetric integer padding -> lax explicit padding pairs.

    torch `Conv2d(padding=p)` pads p on every side. The reference never uses
    'same' string padding; DeepLab atrous convs use padding=dilation so that
    3x3 atrous convs are shape-preserving.
    """
    ph, pw = _pair(padding)
    return ((ph, ph), (pw, pw))


def conv2d(
    x: jax.Array,
    w: jax.Array,
    b: jax.Array | None = None,
    *,
    stride: int | Sequence[int] = 1,
    padding: int | Sequence[int] | str = 0,
    dilation: int | Sequence[int] = 1,
    groups: int = 1,
    preferred_dtype=None,
    layout: str = "NHWC",
) -> jax.Array:
    """2-D convolution, torch `F.conv2d` semantics in NHWC/HWIO layout
    (or NCHW activations with `layout='NCHW'` — same HWIO kernels).

    Args:
      x: (N, H, W, Cin) activations.
      w: (kh, kw, Cin // groups, Cout) kernel.
      b: optional (Cout,) bias.
      padding: int / (ph, pw) torch-style symmetric padding, or a lax string
        ('SAME', 'VALID') — the reference only needs the integer form.
      groups: feature group count (groups == Cin -> depthwise).
      preferred_dtype: explicit XLA accumulation dtype. Leave None in
        differentiable code: the conv transpose (grad) rule cannot handle a
        preferred dtype that differs from the operands, and the tensor
        cores already accumulate bf16 products in f32, so bf16 pipelines
        lose nothing.
    """
    if isinstance(padding, str):
        pad = padding
    else:
        pad = torch_conv_padding(padding)
    common = jnp.promote_types(x.dtype, w.dtype)
    x = x.astype(common)
    w = w.astype(common)
    out = lax.conv_general_dilated(
        x,
        w,
        window_strides=_pair(stride),
        padding=pad,
        rhs_dilation=_pair(dilation),
        dimension_numbers=(DIMENSION_NUMBERS_NCHW if layout == "NCHW"
                           else DIMENSION_NUMBERS),
        feature_group_count=groups,
        preferred_element_type=preferred_dtype,
    )
    if preferred_dtype is None:
        out = out.astype(common)
    if b is not None:
        bb = b.astype(out.dtype)
        out = out + (bb[:, None, None] if layout == "NCHW" else bb)
    return out


def depthwise_conv2d(
    x: jax.Array,
    w: jax.Array,
    b: jax.Array | None = None,
    *,
    stride: int | Sequence[int] = 1,
    padding: int | Sequence[int] = 0,
    dilation: int | Sequence[int] = 1,
) -> jax.Array:
    """Depthwise conv: w is (kh, kw, 1, C); groups == C."""
    c = x.shape[-1]
    assert w.shape[2] == 1 and w.shape[3] == c, (
        f"depthwise kernel must be (kh,kw,1,{c}), got {w.shape}"
    )
    return conv2d(x, w, b, stride=stride, padding=padding, dilation=dilation, groups=c)


def conv2d_gemm(
    x: jax.Array,
    w: jax.Array,
    b: jax.Array | None = None,
    *,
    padding: int | Sequence[int] = 0,
    dilation: int | Sequence[int] = 1,
) -> jax.Array:
    """Stride-1 dense conv as a sum of k² shifted matmuls.

    Built for dilated dense 3x3 convs at 33² (ResNet layer4 rate-2, ASPP
    rates 6/12/18). Each kernel tap becomes an (N*H*W, Cin) @ (Cin, Cout)
    matmul — mathematically identical, autodiff works through it natively.
    """
    kh, kw, cin, co = w.shape
    assert x.shape[-1] == cin, "groups != 1 not supported in GEMM path"
    ph, pw = _pair(padding)
    dh, dw = _pair(dilation)
    common = jnp.promote_types(x.dtype, w.dtype)
    x = x.astype(common)
    w = w.astype(common)
    n, h, wdt, _ = x.shape
    ho = h + 2 * ph - dh * (kh - 1)
    wo = wdt + 2 * pw - dw * (kw - 1)
    assert ho > 0 and wo > 0, "negative output size"
    xp = jnp.pad(x, ((0, 0), (ph, ph), (pw, pw), (0, 0)))
    acc = None
    for ki in range(kh):
        for kj in range(kw):
            tap = xp[:, ki * dh:ki * dh + ho, kj * dw:kj * dw + wo, :]
            contrib = jnp.dot(tap.reshape(-1, cin), w[ki, kj],
                              preferred_element_type=jnp.float32)
            acc = contrib if acc is None else acc + contrib
    out = acc.reshape(n, ho, wo, co).astype(common)
    if b is not None:
        out = out + b.astype(out.dtype)
    return out


@partial(jax.jit, static_argnames=("kh", "kw", "dilation"))
def fixed_padding(x: jax.Array, kh: int, kw: int, dilation: int = 1) -> jax.Array:
    """Xception-style explicit 'SAME' padding applied *before* a VALID conv.

    Matches the reference Xception backbone's `fixed_padding` (SURVEY.md §2.1):
    pad_total = dilation*(k-1); pad_beg = pad_total//2, pad_end = rest.
    Needed so stride-2 separable convs are alignment-invariant.
    """
    def _amt(k):
        eff = dilation * (k - 1)
        return eff // 2, eff - eff // 2

    (t, b), (l, r) = _amt(kh), _amt(kw)
    return jnp.pad(x, ((0, 0), (t, b), (l, r), (0, 0)))


def s2d_pack(x):
    """Host-side space-to-depth(2) packing with a 3-pixel zero margin.

    (N, H, W, C) -> (N, (H-1)//2 + 4, (W-1)//2 + 4, 4C), H/W odd (the
    reference crop sizes 513/769 are odd by construction). Packed cell
    (r, c) holds original pixels (2r-3+a, 2c-3+b), channel order (a, b, C)
    — identical to conv2d_s2d's on-device packing, but meant to run in the
    HOST data pipeline (numpy in, numpy out), where the gather is free.
    The 3-pixel margin serves every stride-2 entry conv with odd padding
    <= 3: the ResNet 7x7/pad-3 stem reads the whole tensor, the MobileNetV2
    3x3/pad-1 stem reads the [1:-1, 1:-1] cell window (conv2d_s2d_packed).
    Total H2D bytes are unchanged (same element count).
    """
    import numpy as _np

    mod = _np if isinstance(x, _np.ndarray) else jnp
    n, H, W, c = x.shape
    if H % 2 != 1 or W % 2 != 1:
        raise ValueError(f"s2d_pack requires odd H/W, got {H}x{W}")
    Hp, Wp = (H - 1) // 2 + 4, (W - 1) // 2 + 4
    xp = mod.pad(x, ((0, 0), (3, 2 * Hp - H - 3), (3, 2 * Wp - W - 3),
                     (0, 0)))
    z = xp.reshape(n, Hp, 2, Wp, 2, c)
    return mod.transpose(z, (0, 1, 3, 2, 4, 5)).reshape(n, Hp, Wp, 4 * c)


def is_s2d_packed(x) -> bool:
    """True for an s2d_pack'ed 4-D NHWC array (12 = 4 x RGB channels; no
    crop size in the reference recipes produces a 12-wide spatial dim)."""
    return getattr(x, "ndim", 0) == 4 and x.shape[-1] == 12


def s2d_orig_size(hp: int, wp: int) -> tuple[int, int]:
    """Original (odd) H, W of an s2d_pack'ed tensor's spatial dims."""
    return 2 * hp - 7, 2 * wp - 7


def supports_host_s2d(model) -> bool:
    """True iff `model`'s entry stem can consume s2d_pack'ed input —
    i.e. the standard ResNet 7x7/s2/pad3 or MobileNetV2 3x3/s2/pad1 entry
    conv is intact (no cheap-conv surgery on it, no channel-major stem).
    Pack sites (data pipeline / bench) must check this for EVERY model the
    batch feeds; when any says no, keep normal 3-channel images."""
    from ..models.mobilenetv2 import ConvBNReLU6, MobileNetV2
    from ..models.resnet import ResNet
    from ..models.xception import Xception65

    b = getattr(model, "backbone", model)
    try:
        if isinstance(b, MobileNetV2):
            f0 = b.features[0]
            return (isinstance(f0, ConvBNReLU6)
                    and b.channel_major_until == 0
                    and f0.conv.kernel_size == (3, 3)
                    and f0.conv.stride == (2, 2)
                    and f0.conv.padding == (1, 1))
        if isinstance(b, ResNet):
            c = b.stem.conv
            return (c.kernel_size == (7, 7) and c.stride == (2, 2)
                    and c.padding == (3, 3))
        if isinstance(b, Xception65):
            c = b.conv1.conv
            return (c.kernel_size == (3, 3) and c.stride == (2, 2)
                    and c.padding == (1, 1) and c.bias is None)
    except AttributeError:
        return False
    return False


def conv2d_s2d_packed(xpk, w, padding: int):
    """Stride-2 small-C_in conv consuming a HOST-packed S2D tensor.

    xpk: s2d_pack(x) output (N, Hp, Wp, 4*Ci). w: (kh, kw, Ci, Co) HWIO of
    the original k x k / stride-2 conv with symmetric odd `padding` <= 3.
    Exact rewrite: the conv becomes a ceil(k/2)² VALID conv with a 4*Ci
    contraction over the packed cells, starting at cell offset
    (3 - padding) // 2. Output extent is (Hp-3, Wp-3) for every such conv
    (all stride-2/odd-pad convs on the same odd input agree). The weight
    transform is differentiable, so the student's entry-conv grads flow
    through it unchanged.
    """
    kh, kw, ci, co = w.shape
    if padding % 2 != 1 or padding > 3:
        raise ValueError(f"conv2d_s2d_packed needs odd padding <= 3, "
                         f"got {padding}")
    if xpk.shape[-1] != 4 * ci:
        raise ValueError(f"packed input has {xpk.shape[-1]} channels, "
                         f"kernel expects {4 * ci}")
    ka, kb = (kh + 1) // 2, (kw + 1) // 2
    off = (3 - padding) // 2
    ho, wo = xpk.shape[1] - 3, xpk.shape[2] - 3
    v = xpk[:, off:off + ho + ka - 1, off:off + wo + kb - 1, :]
    w2 = jnp.pad(w, ((0, 2 * ka - kh), (0, 2 * kb - kw), (0, 0), (0, 0)))
    w2 = jnp.transpose(w2.reshape(ka, 2, kb, 2, ci, co),
                       (0, 2, 1, 3, 4, 5)).reshape(ka, kb, 4 * ci, co)
    return lax.conv_general_dilated(
        v, w2, window_strides=(1, 1), padding="VALID",
        dimension_numbers=DIMENSION_NUMBERS)


def conv2d_s2d(x, w, padding: int):
    """Stride-2 conv with small C_in as an exact space-to-depth rewrite.

    Image-entry convs (C_in=3) have too narrow a contraction for matrix
    units. Folding 2x2 input patches into channels turns the k x k / s2
    conv into a ceil(k/2)² VALID conv with a 4*C_in contraction per tap
    position.

    x (N, H, W, Ci) NHWC; w (kh, kw, Ci, Co) HWIO; symmetric `padding`.
    Exact: out[h',w'] = sum_{dh,dw} w[dh,dw] . xp[2h'+dh, 2w'+dw] with the
    kernel scattered over dh = 2a + ph (and dw = 2b + pw).
    """
    kh, kw, ci, co = w.shape
    n, H, W, _ = x.shape
    ho = (H + 2 * padding - kh) // 2 + 1
    wo = (W + 2 * padding - kw) // 2 + 1
    ka, kb = (kh + 1) // 2, (kw + 1) // 2
    rp, cp = 2 * (ho + ka - 1), 2 * (wo + kb - 1)
    xp = jnp.pad(x, ((0, 0), (padding, rp - H - padding),
                     (padding, cp - W - padding), (0, 0)))
    s2d = xp.reshape(n, rp // 2, 2, cp // 2, 2, ci)
    s2d = jnp.transpose(s2d, (0, 1, 3, 2, 4, 5)).reshape(
        n, rp // 2, cp // 2, 4 * ci)
    w2 = jnp.pad(w, ((0, 2 * ka - kh), (0, 2 * kb - kw), (0, 0), (0, 0)))
    w2 = jnp.transpose(w2.reshape(ka, 2, kb, 2, ci, co),
                       (0, 2, 1, 3, 4, 5)).reshape(ka, kb, 4 * ci, co)
    return lax.conv_general_dilated(
        s2d, w2, window_strides=(1, 1), padding="VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
