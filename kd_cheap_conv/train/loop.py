"""Training loop + validate — the reference main.py's control flow
(SURVEY.md §3.1/§3.4): iteration-based hot loop, print/val intervals,
latest/best checkpointing on val mIoU, streaming confusion-matrix eval.

The loop body stays host-side thin: one jitted step per iteration on
prefetched device batches; metrics cross to host only at print/val points
(jax.block_until_ready only where timing is recorded).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Iterator

import jax
import numpy as np

from .. import nnx
from ..utils.metrics import AverageMeter, StreamSegMetrics
from .checkpoint import save_checkpoint
from .steps import TrainState, make_eval_step


@dataclass
class LoopConfig:
    total_itrs: int = 30_000
    print_interval: int = 10
    val_interval: int = 100
    ckpt_dir: str = "checkpoints"
    model_name: str = "model"
    dataset_name: str = "dataset"
    output_stride: int = 16
    save_best: bool = True
    # jax.profiler trace of steps [profile_start, profile_start+profile_steps)
    # written to profile_dir (open with tensorboard-plugin-profile);
    # SURVEY.md §5.1.
    profile_dir: str | None = None
    profile_start: int = 12
    profile_steps: int = 5


def validate(model: nnx.Module, loader: Iterator, *, num_classes: int,
             eval_step=None, state=None) -> dict:
    """Run eval over a loader; returns StreamSegMetrics results dict.

    Accepts either a live model (split here) or a prebuilt (eval_step, state).
    Per-batch int32 counts accumulate into an int64 host matrix (overflow-
    safe for arbitrarily long eval streams; JAX defaults to 32-bit ints).
    """
    if eval_step is None:
        model.eval()
        graphdef, params, rest = nnx.split(model, nnx.Param, ...)
        eval_step = make_eval_step(graphdef, num_classes=num_classes)
        state = (params, rest)
    params, rest = state
    cm = np.zeros((num_classes, num_classes), np.int64)
    for batch in loader:
        counts, _ = eval_step(params, rest, batch)
        cm += np.asarray(counts)
    return StreamSegMetrics.from_confusion_matrix(cm)


def train_loop(
    *,
    state: TrainState,
    step_fn: Callable,
    train_iter: Iterator,
    cfg: LoopConfig,
    teacher_state=None,
    validate_fn: Callable[[TrainState], dict] | None = None,
    log_fn: Callable[[str], None] = print,
    visualizer=None,
    best_score: float = 0.0,
) -> tuple[TrainState, float]:
    """Run until cfg.total_itrs. Returns (final_state, best_score).

    validate_fn(state) -> metrics dict with 'Mean IoU'; checkpoints written
    with the reference's latest/best layout at each val interval. On SIGTERM
    a final 'latest' checkpoint is written before exiting (SURVEY.md §5.3 —
    automated crash/preemption recovery; resume with --ckpt
    --continue_training).
    """
    import signal

    from .checkpoint import checkpoint_path

    meter = AverageMeter()
    t_last = time.perf_counter()
    cur = int(state.step)

    stop = {"sigterm": False}
    prev_handler = None

    def _on_sigterm(signum, frame):
        stop["sigterm"] = True

    try:
        prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:
        prev_handler = None  # not in main thread (tests); skip handler

    while cur < cfg.total_itrs and not stop["sigterm"]:
        try:
            batch = next(train_iter)
        except StopIteration:
            log_fn("train iterator exhausted before total_itrs")
            break
        if cfg.profile_dir is not None and cur + 1 == cfg.profile_start:
            jax.profiler.start_trace(cfg.profile_dir)
        if teacher_state is not None:
            state, metrics = step_fn(state, batch, teacher_state)
        else:
            state, metrics = step_fn(state, batch)
        cur += 1
        if (cfg.profile_dir is not None
                and cur == cfg.profile_start + cfg.profile_steps):
            jax.block_until_ready(metrics["loss"])
            jax.profiler.stop_trace()
            log_fn(f"profiler trace written to {cfg.profile_dir}")

        if cur % cfg.print_interval == 0:
            jax.block_until_ready(metrics["loss"])
            now = time.perf_counter()
            # windowed rate: only this print interval (the first window eats
            # the compile; a cumulative average would hide steady-state rate)
            step_s = (now - t_last) / cfg.print_interval
            meter.update(step_s, cfg.print_interval)
            t_last = now
            n_img = batch[0].shape[0]
            parts = ", ".join(f"{k}={float(v):.4f}" for k, v in metrics.items())
            log_fn(f"Itrs {cur}/{cfg.total_itrs}: {parts} "
                   f"({n_img / max(step_s, 1e-9):.1f} img/s)")
            if visualizer is not None:
                for k, v in metrics.items():
                    visualizer.add_scalar(f"train/{k}", float(v), cur)
                visualizer.add_scalar("train/img_per_s",
                                      n_img / max(step_s, 1e-9), cur)

        if cur % cfg.val_interval == 0 or cur >= cfg.total_itrs:
            latest = checkpoint_path(cfg.ckpt_dir, "latest", cfg.model_name,
                                     cfg.dataset_name, cfg.output_stride)
            save_checkpoint(latest, cur_itrs=cur, params=state.params,
                            rest=state.rest, opt_state=state.opt_state,
                            best_score=best_score)
            if validate_fn is not None:
                results = validate_fn(state)
                log_fn(StreamSegMetrics.to_str(results))
                if visualizer is not None:
                    for k in ("Mean IoU", "Overall Acc", "Mean Acc",
                              "FreqW Acc"):
                        visualizer.add_scalar(f"val/{k}", results[k], cur)
                if cfg.save_best and results["Mean IoU"] > best_score:
                    best_score = results["Mean IoU"]
                    best = checkpoint_path(cfg.ckpt_dir, "best",
                                           cfg.model_name, cfg.dataset_name,
                                           cfg.output_stride)
                    save_checkpoint(best, cur_itrs=cur, params=state.params,
                                    rest=state.rest,
                                    opt_state=state.opt_state,
                                    best_score=best_score)
            t_last = time.perf_counter()

    if stop["sigterm"]:
        latest = checkpoint_path(cfg.ckpt_dir, "latest", cfg.model_name,
                                 cfg.dataset_name, cfg.output_stride)
        save_checkpoint(latest, cur_itrs=cur, params=state.params,
                        rest=state.rest, opt_state=state.opt_state,
                        best_score=best_score)
        log_fn(f"SIGTERM: checkpoint written at itrs {cur}; exiting")
    if prev_handler is not None:
        import signal

        signal.signal(signal.SIGTERM, prev_handler)
    return state, best_score
