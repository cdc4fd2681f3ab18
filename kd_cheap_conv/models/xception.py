"""Modified aligned Xception-65 backbone (DeepLabV3+ teacher, config #3).

Reference capability (SURVEY.md §2.1, BASELINE.json:5/10): Xception-65 with
depthwise-separable convs throughout, entry/middle/exit flows, strides
replaced with dilation for output-stride control, and `fixed_padding` so
stride-2 separable convs stay alignment-invariant.

Structure (aligned / "modified" Xception per DeepLabV3+, arXiv 1802.02611):
- entry: conv 3x3/2 (32) -> conv 3x3 (64) -> block1 (128, s2)
         -> block2 (256, s2) -> block3 (728, s2 or dilated)
- middle: 16 residual blocks of 3x sep-conv(728)
- exit: block (728->1024, s2 or dilated) -> sep 1536 -> sep 1536 -> sep 2048
Low-level decoder tap: block1 output (128ch, stride 4).
"""

from __future__ import annotations

from .. import nnx
from .layers import BatchNorm, Conv2d, ConvBNReLU, SeparableConv2d


class SepConvBN(nnx.Module):
    """ReLU(optional, pre) -> sep conv (fixed padding) -> BN, Xception-style:
    BN after the depthwise and after the pointwise."""

    def __init__(self, in_ch, out_ch, *, stride=1, dilation=1, pre_relu=True,
                 post_relu=False, dtype=None, rngs: nnx.Rngs):
        self.sep = SeparableConv2d(in_ch, out_ch, 3, stride=stride,
                                   dilation=dilation, bn_between=True,
                                   fixed_pad=True, dtype=dtype, rngs=rngs)
        self.bn = BatchNorm(out_ch, dtype=dtype, rngs=rngs)
        self.pre_relu = pre_relu
        self.post_relu = post_relu

    def __call__(self, x):
        if self.pre_relu:
            x = nnx.relu(x)
        x = self.bn(self.sep(x))
        return nnx.relu(x) if self.post_relu else x


class XceptionBlock(nnx.Module):
    """Three separable convs + residual skip (1x1 conv if shape changes)."""

    def __init__(self, in_ch, channels: tuple[int, int, int], *, stride=1,
                 dilation=1, first_relu=True, dtype=None, rngs: nnx.Rngs):
        c1, c2, c3 = channels
        self.sep1 = SepConvBN(in_ch, c1, dilation=dilation, pre_relu=first_relu,
                              dtype=dtype, rngs=rngs)
        self.sep2 = SepConvBN(c1, c2, dilation=dilation, dtype=dtype, rngs=rngs)
        self.sep3 = SepConvBN(c2, c3, stride=stride, dilation=dilation,
                              dtype=dtype, rngs=rngs)
        if stride != 1 or in_ch != c3:
            self.skip_conv = Conv2d(in_ch, c3, 1, stride=stride, use_bias=False,
                                    dtype=dtype, rngs=rngs)
            self.skip_bn = BatchNorm(c3, dtype=dtype, rngs=rngs)
        else:
            self.skip_conv = None
            self.skip_bn = None

    def __call__(self, x):
        out = self.sep3(self.sep2(self.sep1(x)))
        skip = x if self.skip_conv is None else self.skip_bn(self.skip_conv(x))
        return out + skip


class Xception65(nnx.Module):
    """Returns {'low_level': 128ch stride-4, 'out': 2048ch stride-OS}."""

    def __init__(self, *, output_stride: int = 16, dtype=None, rngs: nnx.Rngs):
        if output_stride == 16:
            entry3_stride, exit_stride = 2, 1
            middle_dilation, exit_dilation = 1, 2
        elif output_stride == 8:
            entry3_stride, exit_stride = 1, 1
            middle_dilation, exit_dilation = 2, 4
        elif output_stride == 32:
            entry3_stride, exit_stride = 2, 2
            middle_dilation, exit_dilation = 1, 1
        else:
            raise ValueError(f"output_stride must be 8/16/32, got {output_stride}")

        self.conv1 = ConvBNReLU(3, 32, 3, stride=2, padding=1, dtype=dtype, rngs=rngs)
        self.conv2 = ConvBNReLU(32, 64, 3, padding=1, dtype=dtype, rngs=rngs)
        self.block1 = XceptionBlock(64, (128, 128, 128), stride=2,
                                    first_relu=False, dtype=dtype, rngs=rngs)
        self.block2 = XceptionBlock(128, (256, 256, 256), stride=2, dtype=dtype, rngs=rngs)
        self.block3 = XceptionBlock(256, (728, 728, 728), stride=entry3_stride,
                                    dtype=dtype, rngs=rngs)
        self.middle = nnx.List([
            XceptionBlock(728, (728, 728, 728), dilation=middle_dilation,
                          dtype=dtype, rngs=rngs)
            for _ in range(16)
        ])
        self.exit_block = XceptionBlock(728, (728, 1024, 1024), stride=exit_stride,
                                        dilation=exit_dilation, dtype=dtype, rngs=rngs)
        self.exit_sep1 = SepConvBN(1024, 1536, dilation=exit_dilation,
                                   pre_relu=False, post_relu=True, dtype=dtype, rngs=rngs)
        self.exit_sep2 = SepConvBN(1536, 1536, dilation=exit_dilation,
                                   pre_relu=False, post_relu=True, dtype=dtype, rngs=rngs)
        self.exit_sep3 = SepConvBN(1536, 2048, dilation=exit_dilation,
                                   pre_relu=False, post_relu=True, dtype=dtype, rngs=rngs)
        self.low_level_channels = 128
        self.out_channels = 2048

    def _conv1_s2d_active(self) -> bool:
        from .. import config

        c = self.conv1.conv
        return (config.s2d_stem_enabled() and c.kernel_size == (3, 3)
                and c.stride == (2, 2) and c.padding == (1, 1)
                and c.dilation == (1, 1) and c.bias is None)

    def __call__(self, x):
        from .. import config
        from ..ops.conv import is_s2d_packed

        if config.host_s2d_enabled() and is_s2d_packed(x):
            # HOST-packed S2D input (ops.conv.s2d_pack): the 3x3/s2/pad1
            # entry conv reads the packed tensor via an exact 2x2-VALID
            # rewrite. The weight transform is differentiable, so the
            # student's conv1 grads flow unchanged.
            from ..ops.conv import conv2d_s2d_packed

            c = self.conv1.conv
            w = c.kernel[...]
            if c.dtype is not None:
                x = x.astype(c.dtype)
                w = w.astype(c.dtype)
            x = nnx.relu(self.conv1.bn(conv2d_s2d_packed(x, w, 1)))
            x = self.conv2(x)
        elif self._conv1_s2d_active():
            # entry 3x3/s2 C_in=3 via the space-to-depth rewrite
            # (ops.conv.conv2d_s2d); BN+relu stay on the module
            from ..ops.conv import conv2d_s2d

            c = self.conv1.conv
            w = c.kernel[...]
            if c.dtype is not None:
                x = x.astype(c.dtype)
                w = w.astype(c.dtype)
            x = nnx.relu(self.conv1.bn(conv2d_s2d(x, w, 1)))
            x = self.conv2(x)
        else:
            x = self.conv2(self.conv1(x))
        x = self.block1(x)
        low_level = x
        x = self.block3(self.block2(x))
        for b in self.middle:
            x = b(x)
        x = self.exit_block(x)
        x = self.exit_sep3(self.exit_sep2(self.exit_sep1(x)))
        return {"low_level": low_level, "out": x}


def xception65(*, output_stride=16, dtype=None, rngs: nnx.Rngs) -> Xception65:
    return Xception65(output_stride=output_stride, dtype=dtype, rngs=rngs)
