"""KD objective assembly: task CE + pixelwise softened-KL + feature hints.

BASELINE.json:5: "the KD objectives (pixelwise softened-KL on logits,
intermediate feature/hint L2) run fused with the loss reduction in a single
jitted train step". This module is the pure-loss part; train.steps builds the
jitted step around it. Reference shape: SURVEY.md §3.2
(L = alpha*CE + beta*T^2*KL + gamma*hint).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from .. import nnx
from ..ops.losses import cross_entropy, focal_loss, hint_l2_loss, kd_kl_loss
from ..ops.resize import resize_bilinear
from ..models.layers import Conv2d


@dataclasses.dataclass(frozen=True)
class KDConfig:
    temperature: float = 4.0
    alpha: float = 0.5          # hard-label task loss weight
    beta: float = 0.5           # softened-KL weight
    gamma: float = 0.0          # feature-hint weight
    hint_taps: tuple[str, ...] = ()   # subset of {'low_level','out','head'}
    loss_type: str = "cross_entropy"  # 'cross_entropy' | 'focal_loss'
    kl_mask_ignored: bool = False     # mask KL at ignore-index pixels
    # Teacher logits are clipped to +-this before the KL. A trained teacher's
    # logits are O(10) so this is a no-op; an UNTRAINED eval-mode teacher
    # (benchmarks) emits |logits|~1e6, where a fused exp's range reduction
    # can give NaN/inf. Clipping preserves the softened distribution shape
    # for any sane teacher.
    teacher_logit_clip: float = 3.0e4


class HintAdapters(nnx.Module):
    """Per-tap 1x1 conv adapters mapping student feature channels to the
    teacher's (FitNets hints need channel alignment; SURVEY.md §2.2)."""

    def __init__(self, tap_channels: dict[str, tuple[int, int]], *,
                 dtype=None, rngs: nnx.Rngs):
        self.taps = tuple(sorted(tap_channels))
        for tap in self.taps:
            s_ch, t_ch = tap_channels[tap]
            adapter = (Conv2d(s_ch, t_ch, 1, dtype=dtype, rngs=rngs)
                       if s_ch != t_ch else None)
            setattr(self, f"adapt_{tap}", adapter)

    def __call__(self, tap: str, feat):
        adapter = getattr(self, f"adapt_{tap}")
        return adapter(feat) if adapter is not None else feat


def make_hint_adapters(student, teacher, taps: tuple[str, ...], *,
                       input_hw: tuple[int, int] = (65, 65),
                       dtype=None, rngs: nnx.Rngs | None = None) -> HintAdapters:
    """Build adapters by shape inference on a dummy forward (host-side, once)."""
    if rngs is None:
        rngs = nnx.Rngs(0)
    if not taps:
        return HintAdapters({}, dtype=dtype, rngs=rngs)
    x = jnp.zeros((1, *input_hw, 3), jnp.float32)
    s_was_training = _snapshot_eval(student)
    t_was_training = _snapshot_eval(teacher)
    _, s_taps = jax.eval_shape(lambda x: student(x, return_features=True), x)
    _, t_taps = jax.eval_shape(lambda x: teacher(x, return_features=True), x)
    _restore(student, s_was_training)
    _restore(teacher, t_was_training)
    chans = {t: (s_taps[t].shape[-1], t_taps[t].shape[-1]) for t in taps}
    return HintAdapters(chans, dtype=dtype, rngs=rngs)


def _snapshot_eval(model) -> bool:
    # eval_shape still traces BN; run in eval mode to avoid fake stat updates
    training = any(
        not m.use_running_average
        for _, m in nnx.iter_modules(model) if isinstance(m, nnx.BatchNorm)
    )
    model.eval()
    return training


def _restore(model, training: bool) -> None:
    if training:
        model.train()


def kd_total_loss(
    student_logits: jax.Array,
    teacher_logits: jax.Array,
    labels: jax.Array,
    cfg: KDConfig,
    *,
    student_taps: dict | None = None,
    teacher_taps: dict | None = None,
    adapters: HintAdapters | None = None,
    channel_axis: int = -1,
) -> tuple[jax.Array, dict[str, jax.Array]]:
    """Returns (total_loss, aux dict of unweighted component losses).

    channel_axis=1 for the class-major (N,C,H,W) hot path (see
    models.deeplab.SegmentationModel class_major)."""
    if cfg.teacher_logit_clip:
        c = float(cfg.teacher_logit_clip)
        teacher_logits = jnp.clip(teacher_logits, -c, c)
    task_fn = focal_loss if cfg.loss_type == "focal_loss" else cross_entropy
    l_task = task_fn(student_logits, labels, channel_axis=channel_axis)
    l_kd = kd_kl_loss(
        student_logits, teacher_logits,
        temperature=cfg.temperature,
        labels=labels if cfg.kl_mask_ignored else None,
        channel_axis=channel_axis,
    )
    l_hint = jnp.zeros((), jnp.float32)
    if cfg.hint_taps:
        assert student_taps is not None and teacher_taps is not None
        for tap in cfg.hint_taps:
            s = student_taps[tap]
            t = teacher_taps[tap]
            if adapters is not None:
                s = adapters(tap, s)
            if s.shape[1:3] != t.shape[1:3]:
                s = resize_bilinear(s, t.shape[1:3])
            l_hint = l_hint + hint_l2_loss(s, t)
    total = cfg.alpha * l_task + cfg.beta * l_kd + cfg.gamma * l_hint
    return total, {"task": l_task, "kd": l_kd, "hint": l_hint}
