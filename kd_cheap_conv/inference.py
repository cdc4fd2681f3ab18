"""Multi-scale + flip TTA inference (BASELINE.json config #5; SURVEY.md §3.5).

The whole TTA sweep is ONE jitted XLA program per (input-shape, scale-set):
for each scale s and flip f, resize -> forward -> un-flip -> resize logits to
base size -> accumulate probabilities; final argmax. Static scale list keeps
shapes static for XLA; the flip pair is batched (stacked on the batch axis)
so each scale costs one forward of 2N images — one large batch instead
of the reference's per-augmentation Python loop.

Also hosts plain `predict` (single forward + argmax), used by validate().
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import nnx
from .ops.resize import resize_bilinear


def make_predict_fn(model: nnx.Module):
    """model must be in eval mode. Returns jitted (images)->preds."""
    graphdef, state = nnx.split(model)

    @jax.jit
    def predict(state, images):
        m = nnx.merge(graphdef, state)
        logits = m(images)
        return jnp.argmax(logits, axis=-1).astype(jnp.int32)

    return partial(predict, state)


def make_tta_predict_fn(
    model: nnx.Module,
    *,
    scales: tuple[float, ...] = (0.5, 0.75, 1.0, 1.25, 1.5, 1.75),
    flip: bool = True,
):
    """Returns jitted (images NHWC) -> (preds NHW, mean probs NHWC)."""
    graphdef, state = nnx.split(model)
    scales = tuple(float(s) for s in scales)

    @jax.jit
    def tta(state, images):
        m = nnx.merge(graphdef, state)
        n, h, w, _ = images.shape
        prob_sum = None
        for s in scales:
            sh, sw = max(1, int(round(h * s))), max(1, int(round(w * s)))
            x = resize_bilinear(images, (sh, sw))
            if flip:
                x = jnp.concatenate([x, x[:, :, ::-1, :]], axis=0)
            logits = m(x)
            logits = resize_bilinear(logits, (h, w))
            probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
            if flip:
                fwd, mirrored = probs[:n], probs[n:]
                probs = fwd + mirrored[:, :, ::-1, :]
            prob_sum = probs if prob_sum is None else prob_sum + probs
        denom = len(scales) * (2 if flip else 1)
        mean_probs = prob_sum / denom
        return jnp.argmax(mean_probs, axis=-1).astype(jnp.int32), mean_probs

    return partial(tta, state)
