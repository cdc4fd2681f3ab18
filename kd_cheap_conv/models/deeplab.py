"""DeepLabV3 / DeepLabV3+ heads and the segmentation model wrapper.

Reference capability (SURVEY.md §2.1):
- `DeepLabHeadV3Plus`: 1x1-project low-level features to 48ch, ASPP on the
  high-level features, bilinear-upsample ASPP output to the low-level
  resolution, concat (304ch), one 3x3 conv to 256ch, 1x1 classifier.
- `DeepLabHead` (V3, no decoder): ASPP -> 3x3 conv 256 -> 1x1 classifier.
- `_SimpleSegmentationModel` equivalent: backbone -> head -> bilinear
  upsample logits to input resolution.

The model can also return its KD feature taps (low-level, backbone out, head
pre-logit features) for the hint L2 loss (BASELINE.json:5).
"""

from __future__ import annotations


from .. import nnx
from ..ops.resize import resize_bilinear
from .aspp import ASPP
from .layers import Conv2d, ConvBNReLU


class DeepLabHeadV3Plus(nnx.Module):
    def __init__(self, in_channels: int, low_level_channels: int,
                 num_classes: int, aspp_dilate=(6, 12, 18), *, dtype=None,
                 rngs: nnx.Rngs):
        self.project = ConvBNReLU(low_level_channels, 48, 1, dtype=dtype, rngs=rngs)
        self.aspp = ASPP(in_channels, tuple(aspp_dilate), dtype=dtype, rngs=rngs)
        self.fuse = ConvBNReLU(304, 256, 3, padding=1, dtype=dtype, rngs=rngs)
        self.classifier = Conv2d(256, num_classes, 1, dtype=dtype, rngs=rngs)

    def _split_fuse_kind(self) -> str | None:
        """Can fuse(cat(low, up)) be computed as fuseA(low) + fuseB(up)?

        Exact for a dense groups-1 conv (split the in-channel axis of the
        kernel) and for a separable pair (depthwise is per-channel, so it
        splits too; the pointwise splits like the dense case). NOT exact for
        grouped convs whose block boundaries straddle the 48/256 split —
        those fall back to the materialized concat.
        """
        conv = self.fuse.conv
        if isinstance(conv, Conv2d):
            return "dense" if conv.groups == 1 else None
        dw = getattr(conv, "depthwise", None)
        pw = getattr(conv, "pointwise", None)
        if (isinstance(dw, Conv2d) and isinstance(pw, Conv2d)
                and dw.groups == dw.in_channels and pw.groups == 1
                and pw.kernel_size == (1, 1) and dw.bias is None
                and getattr(conv, "bn_dw", None) is None):
            return "separable"
        return None

    def _call_split_fuse(self, low, up, kind: str):
        """fuse(cat(low, up)) without materializing the 304ch concat: the
        pad/copy/layout glue around the concat is ~9ms of the 68.5ms KD step
        at b16/513² (xplane profile, round 3). Same math, same BN."""
        from ..ops.conv import conv2d

        conv = self.fuse.conv
        cl = low.shape[-1]
        if kind == "dense":
            w = conv.kernel[...]
            dtype = conv.dtype
            if dtype is not None:
                low, up, w = (low.astype(dtype), up.astype(dtype),
                              w.astype(dtype))
            y = conv2d(low, w[:, :, :cl], None, stride=conv.stride,
                       padding=conv.padding, dilation=conv.dilation)
            y = y + conv2d(up, w[:, :, cl:], None, stride=conv.stride,
                           padding=conv.padding, dilation=conv.dilation)
            if conv.bias is not None:
                y = y + conv.bias[...].astype(y.dtype)
        else:  # separable
            dw, pw = conv.depthwise, conv.pointwise
            dwk = dw.kernel[...]
            pwk = pw.kernel[...]
            dtype = dw.dtype
            if dtype is not None:
                low, up = low.astype(dtype), up.astype(dtype)
                dwk, pwk = dwk.astype(dtype), pwk.astype(dtype)
            ylo = conv2d(low, dwk[:, :, :, :cl], None, stride=dw.stride,
                         padding=dw.padding, dilation=dw.dilation, groups=cl)
            yup = conv2d(up, dwk[:, :, :, cl:], None, stride=dw.stride,
                         padding=dw.padding, dilation=dw.dilation,
                         groups=dwk.shape[3] - cl)
            y = conv2d(ylo, pwk[:, :, :cl], None)
            y = y + conv2d(yup, pwk[:, :, cl:], None)
            if pw.bias is not None:
                y = y + pw.bias[...].astype(y.dtype)
        y = self.fuse.bn(y)
        return nnx.relu(y) if self.fuse.relu else y

    def __call__(self, features: dict, *, return_features: bool = False):
        import jax.numpy as jnp

        from .. import config

        low = self.project(features["low_level"])
        x = self.aspp(features["out"])
        size = low.shape[1:3]
        if config.mm_upsample_enabled():
            from ..ops.resize import resize_bilinear_matmul

            x = resize_bilinear_matmul(x, size)
        else:
            x = resize_bilinear(x, size)
        split_kind = (self._split_fuse_kind()
                      if config.split_decoder_concat_enabled() else None)
        if split_kind is not None:
            x = self._call_split_fuse(low, x, split_kind)
        else:
            x = self.fuse(jnp.concatenate([low, x], axis=-1))
        logits = self.classifier(x)
        if return_features:
            return logits, {"head": x}
        return logits


class DeepLabHead(nnx.Module):
    def __init__(self, in_channels: int, num_classes: int,
                 aspp_dilate=(6, 12, 18), *, dtype=None, rngs: nnx.Rngs):
        self.aspp = ASPP(in_channels, tuple(aspp_dilate), dtype=dtype, rngs=rngs)
        self.fuse = ConvBNReLU(256, 256, 3, padding=1, dtype=dtype, rngs=rngs)
        self.classifier = Conv2d(256, num_classes, 1, dtype=dtype, rngs=rngs)

    def __call__(self, features: dict, *, return_features: bool = False):
        x = self.fuse(self.aspp(features["out"]))
        logits = self.classifier(x)
        if return_features:
            return logits, {"head": x}
        return logits


class SegmentationModel(nnx.Module):
    """backbone -> head -> bilinear upsample to input size.

    Logits are NHWC by default (reference semantics). With
    `class_major=True` they come back as (N, C, H, W): the transpose happens
    at head resolution (cheap) and the 16x bilinear upsample runs in the
    class-major layout. The loss path uses this (ops.losses channel_axis=1);
    numerics are identical.
    """

    def __init__(self, backbone: nnx.Module, classifier: nnx.Module):
        self.backbone = backbone
        self.classifier = classifier

    def __call__(self, x, *, return_features: bool = False,
                 class_major: bool = False, upsample: bool = True):
        import jax
        import jax.numpy as jnp

        from .. import config
        from ..ops.conv import is_s2d_packed, s2d_orig_size
        from ..ops.resize import resize_bilinear_nchw

        if config.host_s2d_enabled() and is_s2d_packed(x):
            # host-packed S2D input (ops.conv.s2d_pack): logits upsample to
            # the ORIGINAL odd resolution, not the packed extent
            size = s2d_orig_size(x.shape[1], x.shape[2])
        else:
            size = x.shape[1:3]
        feats = self.backbone(x)
        if return_features:
            logits, head_feats = self.classifier(feats, return_features=True)
        else:
            logits = self.classifier(feats)
            head_feats = None
        with jax.named_scope("logits_upsample"):
            if class_major:
                logits = jnp.transpose(logits, (0, 3, 1, 2))
                if upsample:
                    logits = resize_bilinear_nchw(logits, size)
            elif upsample:
                logits = resize_bilinear(logits, size)
        if return_features:
            taps = {"low_level": feats["low_level"], "out": feats["out"],
                    **head_feats}
            return logits, taps
        return logits
