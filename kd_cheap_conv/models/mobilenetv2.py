"""MobileNetV2 backbone with output-stride control (DeepLab variant).

Reference capability (SURVEY.md §2.1): inverted-residual backbone where, once
the running stride reaches `output_stride`, later stage strides are converted
into dilation. Low-level tap = output of the first four feature blocks (24ch,
stride 4); high-level tap = final 320ch block (the 1x1 1280 head conv is
dropped for segmentation), matching the reference's
`features[0:4]` / `features[4:-1]` split.
"""

from __future__ import annotations

from .. import nnx
from .layers import BatchNorm, Conv2d, ConvBNReLU


def _make_divisible(v, divisor=8, min_value=None):
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class ConvBNReLU6(nnx.Module):
    def __init__(self, in_ch, out_ch, kernel_size=3, *, stride=1, dilation=1,
                 groups=1, dtype=None, layout="NHWC", rngs: nnx.Rngs):
        pad = (kernel_size - 1) // 2 * dilation
        self.conv = Conv2d(in_ch, out_ch, kernel_size, stride=stride, padding=pad,
                           dilation=dilation, groups=groups, use_bias=False,
                           dtype=dtype, layout=layout, rngs=rngs)
        self.bn = BatchNorm(out_ch, dtype=dtype,
                            axis=1 if layout == "NCHW" else -1, rngs=rngs)

    def __call__(self, x):
        return nnx.relu6(self.bn(self.conv(x)))


class InvertedResidual(nnx.Module):
    def __init__(self, inp, oup, *, stride=1, dilation=1, expand_ratio=6,
                 dtype=None, layout="NHWC", rngs: nnx.Rngs):
        assert stride in (1, 2)
        hidden = int(round(inp * expand_ratio))
        self.use_res_connect = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNReLU6(inp, hidden, 1, dtype=dtype,
                                      layout=layout, rngs=rngs))
        layers.append(ConvBNReLU6(hidden, hidden, 3, stride=stride,
                                  dilation=dilation, groups=hidden,
                                  dtype=dtype, layout=layout, rngs=rngs))
        self.pw_linear = Conv2d(hidden, oup, 1, use_bias=False, dtype=dtype,
                                layout=layout, rngs=rngs)
        self.pw_bn = BatchNorm(oup, dtype=dtype,
                               axis=1 if layout == "NCHW" else -1, rngs=rngs)
        self.body = nnx.List(layers)

    def __call__(self, x):
        out = x
        for m in self.body:
            out = m(out)
        out = self.pw_bn(self.pw_linear(out))
        return x + out if self.use_res_connect else out


# (expand_ratio t, channels c, repeats n, stride s)
_INVERTED_RESIDUAL_SETTING = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


class MobileNetV2(nnx.Module):
    """Returns {'low_level': 24ch stride-4, 'out': 320ch stride-OS}."""

    def __init__(self, *, output_stride: int = 16, width_mult: float = 1.0,
                 dtype=None, channel_major_until: int = 0, rngs: nnx.Rngs):
        input_channel = _make_divisible(32 * width_mult)
        cm = channel_major_until

        def _layout(idx):
            return "NCHW" if idx < cm else "NHWC"

        features = [ConvBNReLU6(3, input_channel, 3, stride=2, dtype=dtype,
                                layout=_layout(0), rngs=rngs)]
        current_stride = 2
        dilation = 1
        for t, c, n, s in _INVERTED_RESIDUAL_SETTING:
            previous_dilation = dilation
            if current_stride == output_stride:
                stride = 1
                dilation *= s
            else:
                stride = s
                current_stride *= s
            output_channel = _make_divisible(c * width_mult)
            for i in range(n):
                features.append(InvertedResidual(
                    input_channel, output_channel,
                    stride=stride if i == 0 else 1,
                    dilation=previous_dilation if i == 0 else dilation,
                    expand_ratio=t, dtype=dtype,
                    layout=_layout(len(features)), rngs=rngs,
                ))
                input_channel = output_channel
        self.features = nnx.List(features)
        self.low_level_channels = _make_divisible(24 * width_mult)
        self.out_channels = input_channel  # 320
        self.channel_major_until = cm

    def _apply_f0(self, x):
        """features[0] (ConvBNReLU6 3x3/s2/pad1). Consumes a host-packed
        S2D tensor (12 channels, ops.conv.s2d_pack) via the exact 2x2 VALID
        rewrite when KDCC_HOST_S2D is on."""
        from .. import config
        from ..ops.conv import conv2d_s2d_packed, is_s2d_packed

        f0 = self.features[0]
        if not (config.host_s2d_enabled() and is_s2d_packed(x)):
            return f0(x)
        if f0.conv.kernel_size != (3, 3) or f0.conv.stride != (2, 2) \
                or f0.conv.padding != (1, 1):
            raise ValueError("host-S2D input requires the standard "
                             "3x3/s2/pad1 MobileNetV2 entry conv")
        w = f0.conv.kernel[...]
        if f0.conv.dtype is not None:
            x = x.astype(f0.conv.dtype)
            w = w.astype(f0.conv.dtype)
        return nnx.relu6(f0.bn(conv2d_s2d_packed(x, w, 1)))

    def __call__(self, x):
        import jax
        import jax.numpy as jnp

        cm = self.channel_major_until
        if cm > 0:
            from ..ops.conv import is_s2d_packed

            if x.shape[1] == 12 or is_s2d_packed(x):
                raise ValueError("host-S2D packed input is not supported "
                                 "with the NCHW channel-major stem")
            x = jnp.transpose(x, (0, 3, 1, 2))
        low_level = None
        for i, m in enumerate(self.features):
            if i == cm and cm > 0:
                x = jnp.transpose(x, (0, 2, 3, 1))
            # the high-resolution stages f0..f6 get a scope of their own so
            # device traces can price them (tools/profile_kd.py)
            with jax.named_scope("mnv2_f0_f6" if i <= 6 else "mnv2_f7_f17"):
                x = self._apply_f0(x) if i == 0 and cm == 0 else m(x)
            if i == 3:  # features[0:4] -> 24ch stride-4 tap
                low_level = (jnp.transpose(x, (0, 2, 3, 1)) if i < cm else x)
        if cm > len(self.features) - 1:
            x = jnp.transpose(x, (0, 2, 3, 1))
        return {"low_level": low_level, "out": x}


def mobilenet_v2(*, output_stride=16, width_mult=1.0, dtype=None,
                 channel_major_until: int | None = None,
                 rngs: nnx.Rngs) -> MobileNetV2:
    if channel_major_until is None:
        from .. import config

        channel_major_until = config.stem_channel_major_until()
    return MobileNetV2(output_stride=output_stride, width_mult=width_mult,
                       dtype=dtype, channel_major_until=channel_major_until,
                       rngs=rngs)
