"""Atrous Spatial Pyramid Pooling (SURVEY.md §2.1, BASELINE.json:5 "ASPP
dilated convs").

Five branches — 1x1 conv, three 3x3 atrous convs (rates 6/12/18 at OS16,
doubled at OS8), global-average-pool + 1x1 — concatenated and projected to
256ch with BN/ReLU/Dropout(0.1). All branches are dense convs;
XLA fuses the concat+project.
"""

from __future__ import annotations

import jax.numpy as jnp

from .. import nnx
from .layers import ConvBNReLU


def _pool(x):
    """Global average pool, accumulated in at least float32."""
    acc = jnp.promote_types(x.dtype, jnp.float32)
    return jnp.mean(x, axis=(1, 2), keepdims=True, dtype=acc).astype(x.dtype)


class ASPPPooling(nnx.Module):
    def __init__(self, in_channels, out_channels, *, dtype=None, rngs: nnx.Rngs):
        self.conv = ConvBNReLU(in_channels, out_channels, 1, dtype=dtype, rngs=rngs)

    def __call__(self, x):
        size = x.shape[1:3]
        pooled = _pool(x)
        pooled = self.conv(pooled)
        # broadcast back to the feature resolution (bilinear of a 1x1 map
        # == broadcast; kept as explicit broadcast for XLA)
        return jnp.broadcast_to(pooled, (x.shape[0], size[0], size[1], pooled.shape[-1]))


class ASPP(nnx.Module):
    def __init__(self, in_channels: int, atrous_rates: tuple[int, int, int],
                 out_channels: int = 256, *, dropout_rate: float = 0.1,
                 dtype=None, rngs: nnx.Rngs):
        r1, r2, r3 = atrous_rates
        self.branch1 = ConvBNReLU(in_channels, out_channels, 1, dtype=dtype, rngs=rngs)
        self.branch2 = ConvBNReLU(in_channels, out_channels, 3, padding=r1,
                                  dilation=r1, dtype=dtype, rngs=rngs)
        self.branch3 = ConvBNReLU(in_channels, out_channels, 3, padding=r2,
                                  dilation=r2, dtype=dtype, rngs=rngs)
        self.branch4 = ConvBNReLU(in_channels, out_channels, 3, padding=r3,
                                  dilation=r3, dtype=dtype, rngs=rngs)
        self.pool = ASPPPooling(in_channels, out_channels, dtype=dtype, rngs=rngs)
        self.project = ConvBNReLU(5 * out_channels, out_channels, 1, dtype=dtype, rngs=rngs)
        self.dropout = nnx.Dropout(rate=dropout_rate, rngs=rngs)

    def _split_project_ok(self) -> bool:
        from .layers import Conv2d

        c = self.project.conv
        return (isinstance(c, Conv2d) and c.groups == 1
                and c.kernel_size == (1, 1) and c.bias is None)

    def _call_split(self, x):
        """project(cat(b1..b5)) = sum_i project_i(b_i): exact channel-split
        of the 1x1 project kernel — the 5*Cout concat tensor and its
        pad/copy glue never materialize, and the pooled branch contributes
        a broadcast-add of a 1x1-resolution projection."""
        from ..ops.conv import conv2d

        w = self.project.conv.kernel[...]            # (1, 1, 5*Co, Co)
        dt = self.project.conv.dtype
        if dt is not None:
            w = w.astype(dt)
        co = w.shape[3]
        y = None
        for i, b in enumerate((self.branch1, self.branch2, self.branch3,
                               self.branch4)):
            t = conv2d(b(x), w[:, :, i * co:(i + 1) * co], None)
            y = t if y is None else y + t
        pooled = _pool(x)
        p = conv2d(self.pool.conv(pooled), w[:, :, 4 * co:], None)
        y = y + p                                     # broadcast add
        y = self.project.bn(y)
        y = nnx.relu(y) if self.project.relu else y
        return self.dropout(y)

    def __call__(self, x):
        from .. import config

        if config.split_aspp_concat_enabled() and self._split_project_ok():
            return self._call_split(x)
        feats = jnp.concatenate(
            [self.branch1(x), self.branch2(x), self.branch3(x),
             self.branch4(x), self.pool(x)],
            axis=-1,
        )
        return self.dropout(self.project(feats))
