"""ResNet-50/101 backbones with dilated final stages (DeepLab style).

Reference capability (SURVEY.md §2.1, BASELINE.json:5): ResNet backbone with
`replace_stride_with_dilation` so the output stride is 8 or 16 instead of 32;
exposes the stride-4 `layer1` output ('low_level') and the final `layer4`
output ('out') for the DeepLabV3+ decoder and KD feature taps.

NHWC / NNX. Stage-3/4 dilation mirrors the torchvision scheme the reference
inherits: when a stage is dilated, its stride moves into `dilation *= stride`
and the first block keeps the *previous* dilation for its 3x3 conv.
"""

from __future__ import annotations


from .. import nnx
from .layers import BatchNorm, Conv2d, ConvBNReLU


class Bottleneck(nnx.Module):
    expansion = 4

    def __init__(self, inplanes, planes, *, stride=1, dilation=1,
                 downsample=None, dtype=None, rngs: nnx.Rngs):
        self.conv1 = Conv2d(inplanes, planes, 1, use_bias=False, dtype=dtype, rngs=rngs)
        self.bn1 = BatchNorm(planes, dtype=dtype, rngs=rngs)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=dilation,
                            dilation=dilation, use_bias=False, dtype=dtype, rngs=rngs)
        self.bn2 = BatchNorm(planes, dtype=dtype, rngs=rngs)
        self.conv3 = Conv2d(planes, planes * 4, 1, use_bias=False, dtype=dtype, rngs=rngs)
        self.bn3 = BatchNorm(planes * 4, dtype=dtype, rngs=rngs)
        self.downsample = downsample

    def __call__(self, x):
        identity = x
        out = nnx.relu(self.bn1(self.conv1(x)))
        out = nnx.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return nnx.relu(out + identity)


class _Downsample(nnx.Module):
    def __init__(self, in_ch, out_ch, stride, *, dtype=None, rngs: nnx.Rngs):
        self.conv = Conv2d(in_ch, out_ch, 1, stride=stride, use_bias=False,
                           dtype=dtype, rngs=rngs)
        self.bn = BatchNorm(out_ch, dtype=dtype, rngs=rngs)

    def __call__(self, x):
        return self.bn(self.conv(x))


class ResNet(nnx.Module):
    """Dilated ResNet returning {'low_level': layer1, 'out': layer4}."""

    def __init__(self, layers: tuple[int, ...], *, output_stride: int = 16,
                 dtype=None, rngs: nnx.Rngs):
        if output_stride == 16:
            dilate = (False, False, True)
        elif output_stride == 8:
            dilate = (False, True, True)
        elif output_stride == 32:
            dilate = (False, False, False)
        else:
            raise ValueError(f"output_stride must be 8/16/32, got {output_stride}")

        self.stem = ConvBNReLU(3, 64, 7, stride=2, padding=3, dtype=dtype, rngs=rngs)
        self._inplanes = 64
        self._dilation = 1
        self.layer1 = self._make_layer(64, layers[0], stride=1, dilate=False, dtype=dtype, rngs=rngs)
        self.layer2 = self._make_layer(128, layers[1], stride=2, dilate=dilate[0], dtype=dtype, rngs=rngs)
        self.layer3 = self._make_layer(256, layers[2], stride=2, dilate=dilate[1], dtype=dtype, rngs=rngs)
        self.layer4 = self._make_layer(512, layers[3], stride=2, dilate=dilate[2], dtype=dtype, rngs=rngs)
        self.low_level_channels = 256
        self.out_channels = 2048

    def _make_layer(self, planes, blocks, *, stride, dilate, dtype, rngs):
        previous_dilation = self._dilation
        if dilate:
            self._dilation *= stride
            stride = 1
        downsample = None
        if stride != 1 or self._inplanes != planes * Bottleneck.expansion:
            downsample = _Downsample(self._inplanes, planes * Bottleneck.expansion,
                                     stride, dtype=dtype, rngs=rngs)
        layer = [Bottleneck(self._inplanes, planes, stride=stride,
                            dilation=previous_dilation, downsample=downsample,
                            dtype=dtype, rngs=rngs)]
        self._inplanes = planes * Bottleneck.expansion
        for _ in range(1, blocks):
            layer.append(Bottleneck(self._inplanes, planes, dilation=self._dilation,
                                    dtype=dtype, rngs=rngs))
        return nnx.List(layer)

    def _stem_s2d_active(self) -> bool:
        from .. import config

        if not config.s2d_stem_enabled():
            return False
        c = self.stem.conv
        return (c.kernel_size == (7, 7) and c.stride == (2, 2)
                and c.padding == (3, 3) and c.dilation == (1, 1)
                and c.bias is None)

    def _stem_s2d(self, x):
        """Exact space-to-depth rewrite of the 7x7/s2 stem conv
        (ops.conv.conv2d_s2d): the contraction becomes 4x4x12=192 wide.
        BN+relu stay on the module (identical train/eval semantics)."""
        from ..ops.conv import conv2d_s2d

        conv = self.stem.conv
        w = conv.kernel[...]                          # (7, 7, 3, 64) HWIO
        if conv.dtype is not None:
            x = x.astype(conv.dtype)
            w = w.astype(conv.dtype)
        return nnx.relu(self.stem.bn(conv2d_s2d(x, w, 3)))

    def _stem_s2d_packed(self, x):
        """7x7/s2 stem over a HOST-packed S2D input (ops.conv.s2d_pack, 12
        channels): the 4x4 VALID conv reads the packed tensor directly, so
        there is no device gather (KDCC_HOST_S2D)."""
        from ..ops.conv import conv2d_s2d_packed

        conv = self.stem.conv
        if conv.kernel_size != (7, 7) or conv.stride != (2, 2) \
                or conv.padding != (3, 3):
            raise ValueError("host-S2D input requires the standard "
                             "7x7/s2/pad3 ResNet stem")
        w = conv.kernel[...]
        if conv.dtype is not None:
            x = x.astype(conv.dtype)
            w = w.astype(conv.dtype)
        return nnx.relu(self.stem.bn(conv2d_s2d_packed(x, w, 3)))

    def _maxpool(self, x):
        # torch MaxPool2d(kernel_size=3, stride=2, padding=1).
        # init must be the literal -inf for JAX to recognize the max monoid
        # (select-and-scatter grad rule); finfo.min breaks reverse-mode AD.
        from jax import lax
        return lax.reduce_window(
            x, -float("inf"), lax.max,
            window_dimensions=(1, 3, 3, 1), window_strides=(1, 2, 2, 1),
            padding=((0, 0), (1, 1), (1, 1), (0, 0)),
        )

    def __call__(self, x):
        from .. import config
        from ..ops.conv import is_s2d_packed

        if config.host_s2d_enabled() and is_s2d_packed(x):
            x = self._stem_s2d_packed(x)
        else:
            x = self._stem_s2d(x) if self._stem_s2d_active() else self.stem(x)
        x = self._maxpool(x)
        for b in self.layer1:
            x = b(x)
        low_level = x
        for layer in (self.layer2, self.layer3, self.layer4):
            for b in layer:
                x = b(x)
        return {"low_level": low_level, "out": x}


def resnet50(*, output_stride=16, dtype=None, rngs: nnx.Rngs) -> ResNet:
    return ResNet((3, 4, 6, 3), output_stride=output_stride, dtype=dtype, rngs=rngs)


def resnet101(*, output_stride=16, dtype=None, rngs: nnx.Rngs) -> ResNet:
    return ResNet((3, 4, 23, 3), output_stride=output_stride, dtype=dtype, rngs=rngs)
