"""Bilinear / nearest resize with torch `F.interpolate` semantics.

The decoder's bilinear upsample and TTA's multi-scale resizes
(BASELINE.json:5 "decoder bilinear upsample", config #5 TTA) must match torch
`align_corners=False` numerics — a silent mIoU killer otherwise (SURVEY.md §7
"hard parts"). `jax.image.resize(method='bilinear', antialias=False)` uses the
same half-pixel convention as torch align_corners=False for both up- and
down-sampling (torch never antialiases); align_corners=True is provided via
an explicit separable gather for completeness.

jax.image.resize lowers to small dense matmuls per spatial axis and fuses
well.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def resize_bilinear(
    x: jax.Array, size: tuple[int, int], *, align_corners: bool = False
) -> jax.Array:
    """Resize NHWC (or HWC) to spatial `size` = (H, W), torch bilinear semantics."""
    if x.ndim == 3:
        return resize_bilinear(x[None], size, align_corners=align_corners)[0]
    n, h, w, c = x.shape
    oh, ow = int(size[0]), int(size[1])
    if (oh, ow) == (h, w):
        return x
    if not align_corners:
        return jax.image.resize(x, (n, oh, ow, c), method="bilinear", antialias=False)
    return _resize_align_corners(x, oh, ow)


def resize_bilinear_nchw(x: jax.Array, size: tuple[int, int]) -> jax.Array:
    """Bilinear resize of (N, C, H, W), torch align_corners=False semantics.

    Used by the class-major loss path (see train.steps).
    """
    n, c, h, w = x.shape
    oh, ow = int(size[0]), int(size[1])
    if (oh, ow) == (h, w):
        return x
    return jax.image.resize(x, (n, c, oh, ow), method="bilinear",
                            antialias=False)


def _axis_weights(in_size: int, out_size: int, dtype) -> jax.Array:
    """Dense (out, in) interpolation matrix for align_corners=True."""
    if out_size == 1 or in_size == 1:
        # torch maps everything to index 0 in this degenerate case
        m = jnp.zeros((out_size, in_size), dtype)
        return m.at[:, 0].set(1.0)
    scale = (in_size - 1) / (out_size - 1)
    pos = jnp.arange(out_size, dtype=jnp.float32) * scale
    lo = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0, in_size - 1)
    hi = jnp.clip(lo + 1, 0, in_size - 1)
    frac = (pos - lo.astype(jnp.float32)).astype(dtype)
    m = jnp.zeros((out_size, in_size), dtype)
    rows = jnp.arange(out_size)
    m = m.at[rows, lo].add(1.0 - frac)
    m = m.at[rows, hi].add(frac)
    return m


def _resize_align_corners(x: jax.Array, oh: int, ow: int) -> jax.Array:
    n, h, w, c = x.shape
    dt = x.dtype if x.dtype in (jnp.float32, jnp.float64) else jnp.float32
    mh = _axis_weights(h, oh, dt)  # (oh, h)
    mw = _axis_weights(w, ow, dt)  # (ow, w)
    y = jnp.einsum("oh,nhwc->nowc", mh, x.astype(dt))
    y = jnp.einsum("pw,nowc->nopc", mw, y)
    return y.astype(x.dtype)


def _halfpix_weights(in_size: int, out_size: int, dtype) -> jax.Array:
    """Dense (out, in) bilinear matrix, torch align_corners=False / half-pixel
    semantics (matches jax.image.resize(method='bilinear', antialias=False)
    for upsampling). Built with numpy on the host so it enters the jaxpr as
    a constant — no device-side scatter to fold."""
    import numpy as np

    if in_size == out_size:
        return jnp.asarray(np.eye(out_size, dtype=np.float32), dtype)
    scale = in_size / out_size
    pos = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    lo = np.floor(pos).astype(np.int64)
    frac = (pos - lo).astype(np.float32)
    lo_c = np.clip(lo, 0, in_size - 1)
    hi_c = np.clip(lo + 1, 0, in_size - 1)
    m = np.zeros((out_size, in_size), np.float32)
    rows = np.arange(out_size)
    np.add.at(m, (rows, lo_c), 1.0 - frac)
    np.add.at(m, (rows, hi_c), frac)
    return jnp.asarray(m, dtype)


def resize_matrices(h_in: int, h_out: int, w_in: int, w_out: int,
                    dtype) -> tuple[jax.Array, jax.Array]:
    """(Mh (h_out, h_in), Mw (w_out, w_in)) half-pixel bilinear matrices.

    Lets callers run the decoder's 4x upsample as two explicit matmuls with
    a CHOSEN output layout (einsum transposes compose into the dot for
    free), instead of jax.image.resize followed by a materialized layout
    fold."""
    return (_halfpix_weights(h_in, h_out, dtype),
            _halfpix_weights(w_in, w_out, dtype))


def resize_bilinear_matmul(x: jax.Array, size: tuple[int, int]) -> jax.Array:
    """Half-pixel bilinear upsample as two explicit NHWC-preserving matmuls.

    Numerically the same operator as `resize_bilinear` (XLA's resize also
    lowers to dense matmuls), but the einsum order is chosen so BOTH dots
    produce channel-minor (NHWC) outputs directly. The backward of each
    einsum is the transposed matmul in the same layouts. Opt-in
    (KDCC_MM_UPSAMPLE)."""
    n, h, w, c = x.shape
    oh, ow = int(size[0]), int(size[1])
    if (oh, ow) == (h, w):
        return x
    mh, mw = resize_matrices(h, oh, w, ow, x.dtype)
    # W-axis dot FIRST, while H is still small, so any transposes the
    # compiler inserts touch the pre-upsample (4x smaller) tensor. The
    # H-axis dot second is layout-clean by construction: per image it is
    # (oh, h) @ (h, w*c) with a row-major NHWC output.
    y = jnp.einsum("wW,nhWc->nhwc", mw, x)
    return jnp.einsum("hH,nHwc->nhwc", mh, y)


def resize_nearest(x: jax.Array, size: tuple[int, int]) -> jax.Array:
    """Nearest resize (labels / masks). NHWC or NHW."""
    squeeze = False
    if x.ndim == 3:  # (N, H, W) integer masks
        x = x[..., None]
        squeeze = True
    n, h, w, c = x.shape
    out = jax.image.resize(x, (n, int(size[0]), int(size[1]), c), method="nearest")
    return out[..., 0] if squeeze else out
