"""Cheap-conv replacement: build the student by surgically swapping expensive
convs of a (trained) teacher for cheap ones.

This is the fork's core primitive (SURVEY.md §2.2, BASELINE.json:5
"cheap-conv replacement = depthwise-separable / grouped convs"; reference
symbol `convert_to_separable_conv(module)` recursively replaces every
nn.Conv2d with kernel>1 by a depthwise-separable pair).

NNX module surgery is pure-tree editing: walk `nnx.iter_modules(model)`, and for
every eligible `Conv2d`, assign a replacement module onto its parent. Teacher
weights for non-replaced parts are inherited by construction (we clone the
teacher and edit in place). Replaced blocks can be initialized either randomly
or by factorizing the dense kernel:

- separable: per-input-channel rank-1 SVD of the (kh*kw, Cout) slice, since
  the separable pair's effective kernel is W[kh,kw,ci,co] = D[kh,kw,ci]*P[ci,co].
- grouped: block-diagonal slice of the dense kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax.numpy as jnp

from .. import nnx
from ..models.layers import Conv2d


@dataclasses.dataclass(frozen=True)
class CheapConvSpec:
    """What to replace an expensive conv with."""

    kind: str = "separable"   # 'separable' | 'grouped'
    groups: int = 4           # for kind='grouped'
    init: str = "factorize"   # 'factorize' | 'random'


class AtrousSeparableConvolution(nnx.Module):
    """Depthwise kxk (inherits stride/padding/dilation) + pointwise 1x1.

    Mirrors the reference's AtrousSeparableConvolution (SURVEY.md §2.1): the
    cheap drop-in for a dense conv. Bias (if any) moves to the pointwise.
    """

    def __init__(self, in_channels, out_channels, kernel_size, *, stride=1,
                 padding=0, dilation=1, use_bias=True, dtype=None,
                 rngs: nnx.Rngs):
        self.depthwise = Conv2d(in_channels, in_channels, kernel_size,
                                stride=stride, padding=padding,
                                dilation=dilation, groups=in_channels,
                                use_bias=False, dtype=dtype, rngs=rngs)
        self.pointwise = Conv2d(in_channels, out_channels, 1,
                                use_bias=use_bias, dtype=dtype, rngs=rngs)

    def __call__(self, x):
        return self.pointwise(self.depthwise(x))


def _factorize(kernel: np.ndarray):
    """Best rank-1-per-input-channel factorization of an HWIO kernel:
    W[kh,kw,ci,co] ~= D[kh,kw,ci] * P[ci,co] via batched SVD over ci.
    Returns (depthwise (kh,kw,1,ci), pointwise (1,1,ci,co))."""
    kh, kw, ci, co = kernel.shape
    mats = np.transpose(kernel, (2, 0, 1, 3)).reshape(ci, kh * kw, co)
    u, s, vt = np.linalg.svd(mats, full_matrices=False)
    s0 = np.sqrt(np.maximum(s[:, 0], 0.0))
    d = (u[:, :, 0] * s0[:, None]).reshape(ci, kh, kw)
    d = np.transpose(d, (1, 2, 0))[:, :, None, :]     # (kh, kw, 1, ci)
    p = (vt[:, 0, :] * s0[:, None])[None, None]       # (1, 1, ci, co)
    return d, p


def _separable_from(conv: Conv2d, spec: CheapConvSpec, rngs: nnx.Rngs):
    new = AtrousSeparableConvolution(
        conv.in_channels, conv.out_channels, conv.kernel_size,
        stride=conv.stride, padding=conv.padding, dilation=conv.dilation,
        use_bias=conv.bias is not None, dtype=conv.dtype, rngs=rngs,
    )
    if spec.init == "factorize":
        d, p = _factorize(np.asarray(conv.kernel[...], np.float32))
        new.depthwise.kernel[...] = jnp.asarray(d)
        new.pointwise.kernel[...] = jnp.asarray(p)
    if conv.bias is not None:
        new.pointwise.bias[...] = conv.bias[...]
    return new


def _grouped_from(conv: Conv2d, spec: CheapConvSpec, rngs: nnx.Rngs):
    g = spec.groups
    ci, co = conv.in_channels, conv.out_channels
    if ci % g or co % g:
        raise ValueError(f"groups={g} does not divide channels ({ci},{co})")
    new = Conv2d(ci, co, conv.kernel_size, stride=conv.stride,
                 padding=conv.padding, dilation=conv.dilation, groups=g,
                 use_bias=conv.bias is not None, dtype=conv.dtype, rngs=rngs)
    if spec.init == "factorize":
        w = np.asarray(conv.kernel[...], np.float32)  # (kh,kw,ci,co)
        cig, cog = ci // g, co // g
        blocks = [w[:, :, j * cig:(j + 1) * cig, j * cog:(j + 1) * cog]
                  for j in range(g)]
        new.kernel[...] = jnp.asarray(np.concatenate(blocks, axis=-1))
    if conv.bias is not None:
        new.bias[...] = conv.bias[...]
    return new


def _eligible(conv: Conv2d, min_kernel: int) -> bool:
    return (max(conv.kernel_size) >= min_kernel
            and conv.groups == 1)


def _set_at_path(root: nnx.Module, path: tuple, value) -> None:
    obj = root
    for key in path[:-1]:
        obj = obj[key] if isinstance(key, int) else getattr(obj, key)
    last = path[-1]
    if isinstance(last, int):
        obj[last] = value
    else:
        setattr(obj, last, value)


def replace_cheap_convs(
    model: nnx.Module,
    spec: CheapConvSpec = CheapConvSpec(),
    *,
    scope: str | tuple[str, ...] | None = None,
    min_kernel: int = 2,
    rngs: nnx.Rngs | None = None,
) -> list[str]:
    """Replace eligible convs in `model` (in place) per `spec`.

    Args:
      scope: dotted path prefix(es) ('backbone.layer3'); None = whole model.
      min_kernel: only convs with kernel >= this are replaced (reference
        replaces kernel>1 only).
    Returns the dotted paths of the replaced convs.
    """
    if rngs is None:
        rngs = nnx.Rngs(0)
    scopes = (scope,) if isinstance(scope, str) else scope
    replaced = []
    # Materialize the module list first: we mutate while walking.
    mods = [(path, m) for path, m in nnx.iter_modules(model)]
    for path, m in mods:
        if not isinstance(m, Conv2d) or isinstance(m, AtrousSeparableConvolution):
            continue
        if not _eligible(m, min_kernel):
            continue
        dotted = ".".join(str(k) for k in path)
        if scopes is not None and not any(
            dotted == s or dotted.startswith(s + ".") for s in scopes
        ):
            continue
        if spec.kind == "separable":
            new = _separable_from(m, spec, rngs)
        elif spec.kind == "grouped":
            new = _grouped_from(m, spec, rngs)
        else:
            raise ValueError(f"unknown cheap-conv kind {spec.kind!r}")
        _set_at_path(model, path, new)
        replaced.append(dotted)
    return replaced


def convert_to_separable_conv(module: nnx.Module, *, rngs: nnx.Rngs | None = None
                              ) -> nnx.Module:
    """Reference-API shim: replace every conv with kernel>1 in `module` by an
    AtrousSeparableConvolution (random init, as the reference does)."""
    replace_cheap_convs(module, CheapConvSpec(kind="separable", init="random"),
                        min_kernel=2, rngs=rngs)
    return module


def backbone_stages(model) -> list[tuple[str, ...]]:
    """Ordered stage path-prefix groups for the progressive replacement
    schedule (SURVEY.md §3.3), per backbone family. Each stage is a tuple of
    dotted prefixes usable as `scope=` for replace_cheap_convs and as
    trainable-mask prefixes."""
    from ..models.mobilenetv2 import MobileNetV2
    from ..models.resnet import ResNet
    from ..models.xception import Xception65

    bb = model.backbone
    if isinstance(bb, ResNet):
        return [(f"backbone.layer{i}",) for i in (1, 2, 3, 4)]
    if isinstance(bb, MobileNetV2):
        # group the 18 feature blocks by the 7 inverted-residual stages
        bounds = [(1, 2), (2, 4), (4, 7), (7, 11), (11, 14), (14, 17), (17, 18)]
        return [
            tuple(f"backbone.features.{i}" for i in range(a, b))
            for a, b in bounds
        ]
    if isinstance(bb, Xception65):
        return ([("backbone.block1",), ("backbone.block2",), ("backbone.block3",)]
                + [(f"backbone.middle.{i}",) for i in range(16)]
                + [("backbone.exit_block",)])
    raise ValueError(f"no stage map for backbone {type(bb).__name__}")
