"""Global runtime knobs for the plain-JAX graph rewrites.

Each knob is a module global (tests flip it) with an env override read at
call time. All of them select between exact rewrites of the same math in
plain `jnp`/`lax`; none of them selects a kernel or a platform. Which of
them keep their place is decided by A/Bs on the GPU.
"""

from __future__ import annotations

import os


def _flag(env: str, value) -> bool:
    """Env override (0/false/False = off, anything else = on), else the
    module-level value."""
    v = os.environ.get(env)
    if v is not None:
        return v not in ("0", "false", "False")
    return bool(value)


use_gemm_dilated_conv: bool | None = None

# dilation >= this routes dense stride-1 convs through the shifted-matmul
# (GEMM) formulation instead of lax.conv (ops.conv.conv2d_gemm).
gemm_conv_min_dilation: int = 2


def gemm_dilated_conv_enabled() -> bool:
    """Dilated dense convs as k² shifted matmuls (ops.conv.conv2d_gemm).
    Opt-in, not measured on the GPU. Env: KDCC_GEMM=0/1."""
    return _flag("KDCC_GEMM", use_gemm_dilated_conv)


# ResNet 7x7-s2 / Xception 3x3-s2 entry conv as an exact space-to-depth
# rewrite done on the device (ops.conv.conv2d_s2d). Opt-in.
# Env: KDCC_S2D_STEM=0/1.
use_s2d_stem: bool | None = False


def s2d_stem_enabled() -> bool:
    return _flag("KDCC_S2D_STEM", use_s2d_stem)


# Host-side space-to-depth: the data pipeline emits s2d_pack'ed images
# (N, (H-1)//2+4, ., 12) so the entry stems (ResNet 7x7/s2, MobileNetV2 and
# Xception 3x3/s2) consume the packed tensor directly via conv2d_s2d_packed.
# H2D bytes are unchanged. Models detect the packed input by its 12
# channels when this knob is on; eval/TTA paths keep normal images. Pack
# sites additionally require ops.conv.supports_host_s2d(model) so
# nonstandard stems (cheap-conv surgery on the entry conv, channel-major
# stem) keep normal images. Default on. Env: KDCC_HOST_S2D=0/1.
use_host_s2d: bool | None = True


def host_s2d_enabled() -> bool:
    return _flag("KDCC_HOST_S2D", use_host_s2d)


# Decoder concat-split: compute fuse(cat(low, up)) as fuseA(low) + fuseB(up)
# (channel-split of the fuse kernel, exact algebra for dense AND separable
# fuse convs), so the 304-channel concat tensor never materializes.
# Default on. Env: KDCC_SPLIT_DECODER=0/1.
split_decoder_concat: bool | None = True


def split_decoder_concat_enabled() -> bool:
    return _flag("KDCC_SPLIT_DECODER", split_decoder_concat)


# Decoder 4x upsample as two explicit matmuls
# (ops.resize.resize_bilinear_matmul) instead of jax.image.resize. Opt-in.
# Env: KDCC_MM_UPSAMPLE=0/1.
mm_upsample: bool | None = False


def mm_upsample_enabled() -> bool:
    return _flag("KDCC_MM_UPSAMPLE", mm_upsample)


# ASPP concat-split: project(cat(b1..b5)) as a sum of per-branch 1x1 convs
# (exact channel-split of the project kernel, same algebra as the decoder
# split), so the 5*256-channel concat never materializes and the pool
# branch's contribution is a broadcast-add of a 1x1 projection. Default on.
# Env: KDCC_SPLIT_ASPP=0/1.
split_aspp_concat: bool | None = True


def split_aspp_concat_enabled() -> bool:
    return _flag("KDCC_SPLIT_ASPP", split_aspp_concat)


# MobileNetV2 stem layout: run the first K feature blocks channel-major
# (NCHW). 0 = off. Env: KDCC_STEM_CM=K.
stem_channel_major: int | None = None


def stem_channel_major_until() -> int:
    env = os.environ.get("KDCC_STEM_CM")
    if env is not None:
        return int(env)
    return int(stem_channel_major or 0)
