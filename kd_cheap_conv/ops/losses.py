"""Segmentation + knowledge-distillation losses, fused-friendly.

Capability contract (BASELINE.json:5): "the KD objectives (pixelwise
softened-KL on logits, intermediate feature/hint L2) run fused with the loss
reduction in a single jitted train step". These are plain jnp functions so XLA
fuses them into the train step; softmax/log-softmax run in f32 even when
logits arrive in bf16 (SURVEY.md §7 "per-pixel KL at 513²x21 in bf16").

Layout: logits default to NHWC (`channel_axis=-1`); labels are (N, H, W)
int32 with `ignore_index` (255) marking void pixels — the reference's
CrossEntropyLoss(ignore_index=255) semantics. The hot train step passes
class-major (N, C, H, W) logits with `channel_axis=1`; both layouts give
the same numbers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

IGNORE_INDEX = 255


def _valid_mask(labels: jax.Array, ignore_index: int) -> jax.Array:
    return (labels != ignore_index).astype(jnp.float32)


def _gather_class(logp: jax.Array, labels: jax.Array, axis: int) -> jax.Array:
    """logp indexed by per-pixel class labels; returns (N, H, W)."""
    idx = jnp.expand_dims(labels, axis)
    return jnp.take_along_axis(logp, idx, axis=axis).squeeze(axis)


def cross_entropy(
    logits: jax.Array,
    labels: jax.Array,
    *,
    ignore_index: int = IGNORE_INDEX,
    channel_axis: int = -1,
) -> jax.Array:
    """Mean CE over non-ignored pixels. Matches torch CrossEntropyLoss
    (reduction='mean', ignore_index=255)."""
    mask = _valid_mask(labels, ignore_index)
    safe = jnp.where(labels == ignore_index, 0, labels)
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=channel_axis)
    nll = -_gather_class(logp, safe, channel_axis)
    denom = jnp.maximum(mask.sum(), 1.0)
    return (nll * mask).sum() / denom


def focal_loss(
    logits: jax.Array,
    labels: jax.Array,
    *,
    alpha: float = 1.0,
    gamma: float = 2.0,
    ignore_index: int = IGNORE_INDEX,
    channel_axis: int = -1,
) -> jax.Array:
    """Focal loss, matching the reference's FocalLoss option (SURVEY.md §2.4):
    FL = alpha * (1 - p_t)^gamma * CE, mean over valid pixels."""
    mask = _valid_mask(labels, ignore_index)
    safe = jnp.where(labels == ignore_index, 0, labels)
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=channel_axis)
    logpt = _gather_class(logp, safe, channel_axis)
    pt = jnp.exp(logpt)
    fl = -alpha * (1.0 - pt) ** gamma * logpt
    denom = jnp.maximum(mask.sum(), 1.0)
    return (fl * mask).sum() / denom


def kd_kl_loss(
    student_logits: jax.Array,
    teacher_logits: jax.Array,
    *,
    temperature: float = 1.0,
    labels: jax.Array | None = None,
    ignore_index: int = IGNORE_INDEX,
    channel_axis: int = -1,
) -> jax.Array:
    """Pixelwise softened KL: T^2 * KL(softmax(z_t/T) || softmax(z_s/T)).

    Mean over pixels (all pixels, or only non-ignored if `labels` given).
    Matches torch KLDivLoss(reduction='none').sum(C).mean() * T^2 applied to
    per-pixel class distributions (SURVEY.md §2.2, BASELINE.json:5).
    """
    t = float(temperature)
    sl = student_logits.astype(jnp.float32) / t
    tl = teacher_logits.astype(jnp.float32) / t
    log_p_s = jax.nn.log_softmax(sl, axis=channel_axis)
    log_p_t = jax.nn.log_softmax(tl, axis=channel_axis)
    # Clamp before exp: for extreme logit gaps (e.g. an untrained eval-mode
    # teacher emits |logits|~1e6) log_p_t reaches ~-1e6, and a fused exp's
    # range reduction may then produce NaN instead of 0. exp(-87) == 0 in
    # f32, so the clamp changes nothing mathematically.
    log_p_t = jnp.maximum(log_p_t, -87.0)
    p_t = jnp.exp(log_p_t)
    kl = jnp.sum(p_t * (log_p_t - log_p_s), axis=channel_axis)  # (N, H, W)
    if labels is not None:
        mask = _valid_mask(labels, ignore_index)
        denom = jnp.maximum(mask.sum(), 1.0)
        return (t * t) * (kl * mask).sum() / denom
    return (t * t) * kl.mean()


def hint_l2_loss(student_feat: jax.Array, teacher_feat: jax.Array) -> jax.Array:
    """FitNets-style hint: mean squared error between matched feature taps
    (after any channel adapter). BASELINE.json:5 "intermediate feature/hint L2"."""
    diff = student_feat.astype(jnp.float32) - teacher_feat.astype(jnp.float32)
    return jnp.mean(diff * diff)
