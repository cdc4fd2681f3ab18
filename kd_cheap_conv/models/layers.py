"""Shared NNX building blocks (NHWC, mixed-precision aware).

Parameters live in f32 (`param_dtype`); compute can run in bf16 (`dtype`) —
the tensor cores accumulate bf16 conv products in f32 inside ops.conv2d. BatchNorm
statistics always stay f32. Matches the torch layers the reference models are
made of (Conv2d kaiming-fan-out init, BatchNorm2d defaults; SURVEY.md §2.1).
"""

from __future__ import annotations

import jax.numpy as jnp

from .. import nnx
from ..ops.conv import conv2d, fixed_padding

# torch BatchNorm2d(momentum=0.1) == flax BatchNorm(momentum=0.9):
# flax: ra = momentum*ra + (1-momentum)*batch.
TORCH_DEFAULT_BN_MOMENTUM = 0.9


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


class Conv2d(nnx.Module):
    """torch-semantics conv (symmetric int padding) in NHWC/HWIO."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size,
        *,
        stride=1,
        padding=0,
        dilation=1,
        groups: int = 1,
        use_bias: bool = True,
        dtype=None,
        layout: str = "NHWC",
        rngs: nnx.Rngs,
    ):
        kh, kw = _pair(kernel_size)
        assert in_channels % groups == 0
        # torchvision-style kaiming_normal(mode='fan_out', nonlinearity='relu')
        init = nnx.initializers.variance_scaling(2.0, "fan_out", "truncated_normal")
        self.kernel = nnx.Param(
            init(rngs.params(), (kh, kw, in_channels // groups, out_channels), jnp.float32)
        )
        self.bias = (
            nnx.Param(jnp.zeros((out_channels,), jnp.float32)) if use_bias else None
        )
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = (kh, kw)
        self.stride = _pair(stride)
        self.padding = _pair(padding)
        self.dilation = _pair(dilation)
        self.groups = groups
        self.dtype = dtype
        self.layout = layout
        # static routing decision: dilated stride-1 dense convs go through
        # the shifted-matmul GEMM path (ops.conv.conv2d_gemm, KDCC_GEMM)
        from .. import config

        self._use_gemm = bool(
            config.gemm_dilated_conv_enabled()
            and groups == 1
            and self.stride == (1, 1)
            and max(kh, kw) > 1
            and self.dilation[0] >= config.gemm_conv_min_dilation
        )

    def __call__(self, x):
        w = self.kernel[...]
        b = self.bias[...] if self.bias is not None else None
        if self.dtype is not None:
            x = x.astype(self.dtype)
            w = w.astype(self.dtype)
        if self._use_gemm:
            from ..ops.conv import conv2d_gemm

            return conv2d_gemm(x, w, b, padding=self.padding,
                               dilation=self.dilation)
        return conv2d(
            x, w, b,
            stride=self.stride,
            padding=self.padding,
            dilation=self.dilation,
            groups=self.groups,
            layout=self.layout,
        )


class BatchNorm(nnx.BatchNorm):
    """BatchNorm2d with torch defaults; running stats and affine params in
    f32; activations stay in the model's compute dtype (flax computes the
    batch moments in >=f32 internally regardless, so bf16 pipelines don't
    round-trip activations through f32 — that cast would silently promote
    every downstream conv to f32 and halve tensor-core throughput).

    Under `jax.jit` + `NamedSharding` over a data mesh the batch moments are
    computed over the *global* (sharded) batch — XLA inserts the cross-chip
    reductions, so sync-BN comes for free (SURVEY.md §5.8).
    """

    def __init__(self, num_features: int, *, momentum: float = TORCH_DEFAULT_BN_MOMENTUM,
                 epsilon: float = 1e-5, dtype=None, axis: int = -1,
                 rngs: nnx.Rngs):
        super().__init__(
            num_features,
            use_running_average=False,
            axis=axis,              # 1 for channel-major (NCHW) stages
            momentum=momentum,
            epsilon=epsilon,
            dtype=dtype,            # None -> promote with f32 params = f32
            param_dtype=jnp.float32,
            rngs=rngs,
        )


class ConvBNReLU(nnx.Module):
    """Conv -> BN -> (optional) ReLU, the reference's ubiquitous triple."""

    def __init__(self, in_channels, out_channels, kernel_size, *, stride=1,
                 padding=0, dilation=1, groups=1, relu=True, dtype=None,
                 rngs: nnx.Rngs):
        self.conv = Conv2d(
            in_channels, out_channels, kernel_size, stride=stride,
            padding=padding, dilation=dilation, groups=groups,
            use_bias=False, dtype=dtype, rngs=rngs,
        )
        self.bn = BatchNorm(out_channels, dtype=dtype, rngs=rngs)
        self.relu = relu

    def __call__(self, x):
        x = self.bn(self.conv(x))
        return nnx.relu(x) if self.relu else x


class SeparableConv2d(nnx.Module):
    """Depthwise kxk + pointwise 1x1, with BN between (Xception style) or not.

    This is both the Xception building block and the "cheap conv" the student
    is rebuilt from (BASELINE.json:5 "depthwise-separable / grouped convs").
    With `fixed_pad=True` it applies Xception's explicit SAME padding before a
    VALID depthwise conv (alignment-invariant stride-2).
    """

    def __init__(self, in_channels, out_channels, kernel_size=3, *, stride=1,
                 padding=0, dilation=1, use_bias=False, bn_between=False,
                 fixed_pad=False, dtype=None, rngs: nnx.Rngs):
        kh, kw = _pair(kernel_size)
        self.depthwise = Conv2d(
            in_channels, in_channels, (kh, kw), stride=stride,
            padding=0 if fixed_pad else padding, dilation=dilation,
            groups=in_channels, use_bias=use_bias, dtype=dtype, rngs=rngs,
        )
        self.bn_dw = BatchNorm(in_channels, dtype=dtype, rngs=rngs) if bn_between else None
        self.pointwise = Conv2d(
            in_channels, out_channels, 1, use_bias=use_bias, dtype=dtype, rngs=rngs
        )
        self.fixed_pad = fixed_pad
        self._k = (kh, kw)
        self._dilation = _pair(dilation)

    def __call__(self, x):
        if self.fixed_pad:
            x = fixed_padding(x, self._k[0], self._k[1], self._dilation[0])
        x = self.depthwise(x)
        if self.bn_dw is not None:
            x = self.bn_dw(x)
        return self.pointwise(x)


def set_bn_momentum(module: nnx.Module, torch_momentum: float = 0.01) -> None:
    """Reference `utils.set_bn_momentum(backbone, momentum=0.01)` equivalent.

    torch momentum m -> flax momentum (1 - m).
    """
    for _, m in nnx.iter_modules(module):
        if isinstance(m, nnx.BatchNorm):
            m.momentum = 1.0 - torch_momentum
