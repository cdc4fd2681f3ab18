"""Progressive block-wise replacement schedule (BASELINE.json config #4;
SURVEY.md §3.3).

Stage-by-stage: clone the teacher as the student, then for each stage
(deepest first, as the reference schedule walks block_k, block_{k-1}, ...):
replace that stage's dense convs with cheap ones, freeze everything except
the replaced stage, distill for `stage_iters` (logit KL + CE; hint L2 on the
standard taps), then move on. Finish with an end-to-end KD fine-tune over all
parameters.

Each stage builds a fresh optimizer + jitted step (the frozen mask and the
student graph change), which is the natural XLA boundary — one compile per
stage.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator

import jax.numpy as jnp

from .. import nnx
from .distill import KDConfig, make_hint_adapters
from .replace import CheapConvSpec, backbone_stages, replace_cheap_convs


def _train_api():
    # deferred: train.steps itself imports kd.distill — importing it at
    # module scope would make kd/__init__ <-> train/__init__ circular
    from ..train.optim import make_optimizer
    from ..train.steps import make_kd_train_step

    return make_optimizer, make_kd_train_step


@dataclasses.dataclass
class ProgressiveConfig:
    stage_iters: int = 1000
    finetune_iters: int = 5000
    spec: CheapConvSpec = dataclasses.field(default_factory=CheapConvSpec)
    kd: KDConfig = dataclasses.field(default_factory=KDConfig)
    lr: float = 0.01
    stage_lr: float = 0.01
    weight_decay: float = 1e-4
    deepest_first: bool = True


def run_progressive(
    teacher: nnx.Module,
    student: nnx.Module,
    batch_iter_factory: Callable[[], Iterator],
    cfg: ProgressiveConfig,
    *,
    stages: list[tuple[str, ...]] | None = None,
    input_hw: tuple[int, int] = (65, 65),
    log_fn: Callable[[str], None] = print,
) -> tuple[nnx.Module, list[dict]]:
    """Runs the schedule in place on `student` (typically an nnx.clone of the
    teacher). Returns (student, per-stage history).

    `batch_iter_factory()` must yield (images, labels) batches; it is called
    once per stage and once for the fine-tune.
    """
    if stages is None:
        stages = backbone_stages(student)
        if cfg.deepest_first:
            stages = list(reversed(stages))

    history = []
    replaced_so_far: list[str] = []

    for si, stage in enumerate(stages):
        replaced = replace_cheap_convs(student, cfg.spec, scope=stage)
        if not replaced:
            log_fn(f"[progressive] stage {si} {stage}: nothing to replace, skip")
            continue
        replaced_so_far += replaced
        log_fn(f"[progressive] stage {si} {stage}: replaced {len(replaced)} convs")

        make_optimizer, make_kd_train_step = _train_api()
        adapters = (make_hint_adapters(student, teacher, cfg.kd.hint_taps,
                                       input_hw=input_hw)
                    if cfg.kd.hint_taps else None)
        _, params, _ = nnx.split(student, nnx.Param, ...)
        opt_params = {"student": params}
        if adapters is not None:
            _, a_params = nnx.split(adapters, nnx.Param)
            opt_params["adapters"] = a_params
        def _stage_label(d, stage=stage):
            # exact module-path boundary: 'backbone.features.1' must not
            # capture features.10-17 (MobileNetV2) or middle.10-15 (Xception)
            qs = ["student." + p for p in stage] + ["adapters"]
            on = any(d == q or d.startswith(q + ".") for q in qs)
            return "head" if on else "frozen"

        tx = make_optimizer(
            opt_params,
            lr=cfg.stage_lr, max_iters=cfg.stage_iters,
            weight_decay=cfg.weight_decay,
            head_lr_mult=1.0,  # stage trains at cfg.stage_lr exactly
            label_fn=_stage_label,
        )
        init, step, t_state = make_kd_train_step(
            student, teacher, tx, cfg.kd, adapters=adapters)
        state = init()
        it = batch_iter_factory()
        losses = []
        for _ in range(cfg.stage_iters):
            state, metrics = step(state, next(it), t_state)
            losses.append(metrics["loss"])
        final_loss = float(losses[-1])
        history.append({"stage": stage, "replaced": replaced,
                        "final_loss": final_loss})
        log_fn(f"[progressive] stage {si} done, loss={final_loss:.4f}")
        # write updated params (+ BN stats) back into the live student module
        nnx.update(student, state.params["student"], state.rest)

    # end-to-end fine-tune, everything trainable
    if cfg.finetune_iters > 0:
        make_optimizer, make_kd_train_step = _train_api()
        adapters = (make_hint_adapters(student, teacher, cfg.kd.hint_taps,
                                       input_hw=input_hw)
                    if cfg.kd.hint_taps else None)
        _, params, _ = nnx.split(student, nnx.Param, ...)
        opt_params = {"student": params}
        if adapters is not None:
            _, a_params = nnx.split(adapters, nnx.Param)
            opt_params["adapters"] = a_params
        tx = make_optimizer(opt_params, lr=cfg.lr,
                            max_iters=cfg.finetune_iters,
                            weight_decay=cfg.weight_decay,
                            label_fn=lambda d: (
                                "backbone" if d.startswith("student.backbone")
                                else "head"))
        init, step, t_state = make_kd_train_step(
            student, teacher, tx, cfg.kd, adapters=adapters)
        state = init()
        it = batch_iter_factory()
        last = jnp.zeros(())
        for _ in range(cfg.finetune_iters):
            state, metrics = step(state, next(it), t_state)
            last = metrics["loss"]
        nnx.update(student, state.params["student"], state.rest)
        history.append({"stage": ("finetune",), "replaced": [],
                        "final_loss": float(last)})
        log_fn(f"[progressive] finetune done, loss={float(last):.4f}")
    return student, history
