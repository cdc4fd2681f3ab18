"""Model factory — same public names as the reference CLI (SURVEY.md §2.1).

`deeplabv3{,plus}_{resnet50,resnet101,mobilenet,xception}(num_classes,
output_stride)` build the assembled NNX model; ASPP rates follow the
output stride (6/12/18 at OS16, 12/24/36 at OS8). `pretrained_backbone` is
accepted for API parity but offline: weights load via
train.checkpoint.import_torch_state_dict when a .pth is supplied
(SURVEY.md §7 "no pretrained weights offline").
"""

from __future__ import annotations

from .. import nnx
from .deeplab import DeepLabHead, DeepLabHeadV3Plus, SegmentationModel
from .mobilenetv2 import mobilenet_v2
from .resnet import resnet50, resnet101
from .xception import xception65


def _aspp_dilate(output_stride: int) -> tuple[int, int, int]:
    return (12, 24, 36) if output_stride == 8 else (6, 12, 18)


_BACKBONES = {
    "resnet50": resnet50,
    "resnet101": resnet101,
    "mobilenet": mobilenet_v2,
    "xception": xception65,
}


def _build(arch: str, backbone_name: str, num_classes: int, output_stride: int,
           *, dtype=None, rngs: nnx.Rngs) -> SegmentationModel:
    backbone = _BACKBONES[backbone_name](output_stride=output_stride,
                                         dtype=dtype, rngs=rngs)
    rates = _aspp_dilate(output_stride)
    if arch == "deeplabv3plus":
        head = DeepLabHeadV3Plus(backbone.out_channels,
                                 backbone.low_level_channels,
                                 num_classes, rates, dtype=dtype, rngs=rngs)
    elif arch == "deeplabv3":
        head = DeepLabHead(backbone.out_channels, num_classes, rates,
                           dtype=dtype, rngs=rngs)
    else:
        raise ValueError(f"unknown arch {arch!r}")
    return SegmentationModel(backbone, head)


def _factory(arch, backbone_name):
    def fn(num_classes: int = 21, output_stride: int = 16, *,
           pretrained_backbone: bool = False, dtype=None,
           rngs: nnx.Rngs | None = None) -> SegmentationModel:
        del pretrained_backbone  # API parity; see module docstring
        if rngs is None:
            rngs = nnx.Rngs(0)
        return _build(arch, backbone_name, num_classes, output_stride,
                      dtype=dtype, rngs=rngs)

    fn.__name__ = f"{arch}_{backbone_name}"
    return fn


deeplabv3_resnet50 = _factory("deeplabv3", "resnet50")
deeplabv3_resnet101 = _factory("deeplabv3", "resnet101")
deeplabv3_mobilenet = _factory("deeplabv3", "mobilenet")
deeplabv3_xception = _factory("deeplabv3", "xception")
deeplabv3plus_resnet50 = _factory("deeplabv3plus", "resnet50")
deeplabv3plus_resnet101 = _factory("deeplabv3plus", "resnet101")
deeplabv3plus_mobilenet = _factory("deeplabv3plus", "mobilenet")
deeplabv3plus_xception = _factory("deeplabv3plus", "xception")

MODEL_FACTORY = {
    fn.__name__: fn
    for fn in (
        deeplabv3_resnet50, deeplabv3_resnet101, deeplabv3_mobilenet,
        deeplabv3_xception, deeplabv3plus_resnet50, deeplabv3plus_resnet101,
        deeplabv3plus_mobilenet, deeplabv3plus_xception,
    )
}


def build_model(name: str, num_classes: int, output_stride: int = 16, *,
                dtype=None, rngs: nnx.Rngs | None = None) -> SegmentationModel:
    """CLI entry: model-name string -> assembled model (reference
    `network.modeling.__dict__[opts.model]` equivalent)."""
    if name not in MODEL_FACTORY:
        raise ValueError(f"unknown model {name!r}; choose from {sorted(MODEL_FACTORY)}")
    return MODEL_FACTORY[name](num_classes, output_stride, dtype=dtype, rngs=rngs)
