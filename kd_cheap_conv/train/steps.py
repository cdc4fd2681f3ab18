"""Jitted train / KD / eval steps.

The KD step is the north-star hot loop (BASELINE.json:2): teacher forward
(or cached logits, config #1) + student forward/backward + fused loss, one
XLA program. NNX models are split once at build time (graphdef is static);
the jitted functions are pure over (params, rest-state, opt_state) pytrees.
Inside the jit we re-merge and use `nnx.value_and_grad`, which lifts BN
running-stat mutation across the grad trace (plain jax.value_and_grad cannot
mutate BatchStat variables created at the jit trace level).

The same step runs single-chip or SPMD-sharded over a mesh — batch-sharded
inputs make XLA insert the gradient all-reduce and global BN moments
(SURVEY.md §2.6, §5.8).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import jax
import jax.numpy as jnp
import optax

from .. import nnx
from ..kd.distill import KDConfig, kd_total_loss
from ..ops.losses import cross_entropy, focal_loss


@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["params", "rest", "opt_state", "step"],
                   meta_fields=[])
@dataclasses.dataclass(frozen=True)
class TrainState:
    params: Any          # nnx.Param state (student [+ adapters] params)
    rest: Any            # non-param state: BN stats, RNG counts
    opt_state: Any
    step: jax.Array      # scalar int32 — reference 'cur_itrs'

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)


def _split_train(model: nnx.Module):
    model.train()
    graphdef, params, rest = nnx.split(model, nnx.Param, ...)
    return graphdef, params, rest


def _task_fn(loss_type: str) -> Callable:
    return focal_loss if loss_type == "focal_loss" else cross_entropy


def make_train_step(model: nnx.Module, tx: optax.GradientTransformation, *,
                    loss_type: str = "cross_entropy"):
    """Plain supervised step (reference main.py hot loop, SURVEY.md §3.1).

    Returns (init_state_fn, step_fn). step_fn: (state, (images, labels)) ->
    (state, metrics dict). SPMD follows the input shardings: pass
    mesh-sharded batches and XLA inserts the gradient all-reduce.
    """
    graphdef, params0, rest0 = _split_train(model)
    task = _task_fn(loss_type)

    def init_state() -> TrainState:
        return TrainState(params=params0, rest=rest0,
                          opt_state=tx.init(params0),
                          step=jnp.zeros((), jnp.int32))

    @functools.partial(jax.jit, donate_argnums=0)
    def step_fn(state: TrainState, batch):
        images, labels = batch
        model = nnx.merge(graphdef, state.params, state.rest)

        def loss_fn(model):
            return task(model(images, class_major=True), labels,
                        channel_axis=1)

        loss, grads = nnx.value_and_grad(loss_fn)(model)
        updates, new_opt = tx.update(grads, state.opt_state, state.params)
        new_params = optax.apply_updates(state.params, updates)
        new_state = TrainState(params=new_params,
                               rest=nnx.state(model, nnx.Not(nnx.Param)),
                               opt_state=new_opt, step=state.step + 1)
        return new_state, {"loss": loss}

    return init_state, step_fn


def make_kd_train_step(
    student: nnx.Module,
    teacher: nnx.Module | None,
    tx: optax.GradientTransformation,
    cfg: KDConfig,
    *,
    adapters: nnx.Module | None = None,
    cached_teacher: bool = False,
):
    """KD step (SURVEY.md §3.2). If cached_teacher, batches carry
    (images, labels, teacher_logits) and the teacher forward is skipped
    (BASELINE.json config #1); otherwise (images, labels) and the frozen
    eval-mode teacher runs inside the same XLA program.

    Hint taps require `teacher` even in cached mode (feature maps aren't
    cached), so cached_teacher + hint_taps is rejected.

    Returns (init_state_fn, step_fn, teacher_state). The teacher's state is
    an explicit step argument (not a closure capture) so its weights are jit
    *parameters* — swappable without recompilation and never baked into the
    executable as constants. In cached mode teacher_state is an empty tuple;
    pass it through unchanged: step_fn(state, batch, teacher_state).

    The metrics carry the loss, its components and `grad_norm`, the global
    L2 norm of the gradients before the optimizer update.
    """
    if cached_teacher and cfg.hint_taps:
        raise ValueError("cached-teacher mode caches logits only; "
                         "hint taps need a live teacher")
    if not cached_teacher and teacher is None:
        raise ValueError("teacher required unless cached_teacher=True")

    graphdef, s_params, s_rest = _split_train(student)

    if teacher is not None and not cached_teacher:
        teacher.eval()
        t_graphdef, t_state = nnx.split(teacher)
    else:
        t_graphdef, t_state = None, ()

    if adapters is not None:
        a_graphdef, a_params = nnx.split(adapters, nnx.Param)
    else:
        a_graphdef, a_params = None, None

    params0 = {"student": s_params}
    if a_params is not None:
        params0["adapters"] = a_params

    need_taps = bool(cfg.hint_taps)

    def init_state() -> TrainState:
        # Copy buffers: the step donates its state, and a student built by
        # cloning the teacher ALIASES teacher arrays for non-replaced layers
        # — donating a buffer that also arrives via teacher_state is an XLA
        # error (`f(donate(a), a)`). One-time copy, zero steady-state cost.
        params = jax.tree.map(jnp.copy, params0)
        rest = jax.tree.map(jnp.copy, s_rest)
        return TrainState(params=params, rest=rest,
                          opt_state=tx.init(params),
                          step=jnp.zeros((), jnp.int32))

    @functools.partial(jax.jit, donate_argnums=0)
    def step_fn(state: TrainState, batch, teacher_state=()):
        if cached_teacher:
            images, labels, t_logits = batch  # cached logits arrive NHWC
            t_logits = jnp.transpose(t_logits, (0, 3, 1, 2))
            t_taps = None
        else:
            images, labels = batch
            t_model = nnx.merge(t_graphdef, teacher_state)
            with jax.named_scope("teacher"):
                if need_taps:
                    t_logits, t_taps = t_model(images, return_features=True,
                                               class_major=True)
                    t_taps = jax.lax.stop_gradient(t_taps)
                else:
                    t_logits = t_model(images, class_major=True)
                    t_taps = None
            t_logits = jax.lax.stop_gradient(t_logits)

        s_model = nnx.merge(graphdef, state.params["student"], state.rest)
        adp = (nnx.merge(a_graphdef, state.params["adapters"])
               if a_graphdef is not None else None)

        def _losses(s_model, adp):
            with jax.named_scope("student"):
                if need_taps:
                    s_logits, s_taps = s_model(images, return_features=True,
                                               class_major=True)
                else:
                    s_logits = s_model(images, class_major=True)
                    s_taps = None
            with jax.named_scope("kd_loss"):
                return kd_total_loss(
                    s_logits, t_logits, labels, cfg,
                    student_taps=s_taps, teacher_taps=t_taps, adapters=adp,
                    channel_axis=1)

        if adp is not None:
            (loss, aux), grads = nnx.value_and_grad(
                lambda m, a: _losses(m, a), has_aux=True,
                argnums=(0, 1))(s_model, adp)
            grads = {"student": grads[0], "adapters": grads[1]}
        else:
            (loss, aux), grads = nnx.value_and_grad(
                lambda m: _losses(m, None), has_aux=True)(s_model)
            grads = {"student": grads}

        with jax.named_scope("optimizer"):
            updates, new_opt = tx.update(grads, state.opt_state,
                                         state.params)
            new_params = optax.apply_updates(state.params, updates)
        new_state = TrainState(params=new_params,
                               rest=nnx.state(s_model, nnx.Not(nnx.Param)),
                               opt_state=new_opt, step=state.step + 1)
        return new_state, {"loss": loss, **aux,
                           "grad_norm": optax.global_norm(grads)}

    return init_state, step_fn, t_state


def make_eval_step(model_graphdef, *, num_classes: int):
    """Eval step: logits -> per-pixel argmax + per-batch confusion-matrix
    counts (SURVEY.md §3.4). Counts are int32 on device — exact for any
    single batch (<= a few 1e7 pixels) — and the CALLER accumulates them into
    an int64 host matrix: a full Cityscapes val epoch is ~1.05e9 pixels,
    within 2x of int32 overflow, and repeated evals would silently wrap an
    on-device int32 accumulator (JAX defaults to 32-bit integers)."""

    @jax.jit
    def eval_step(params, rest, batch):
        images, labels = batch
        m = nnx.merge(model_graphdef, params, rest)
        logits = m(images, class_major=True)
        preds = jnp.argmax(logits, axis=1).astype(jnp.int32)
        # reference _fast_hist masks 0 <= label < n_classes (not just 255)
        valid = (labels >= 0) & (labels < num_classes)
        # confusion matrix accumulation: index = true * C + pred
        idx = jnp.where(valid, labels * num_classes + preds, num_classes * num_classes)
        counts = jnp.bincount(idx.reshape(-1),
                              length=num_classes * num_classes + 1)[:-1]
        return counts.reshape(num_classes, num_classes), preds

    return eval_step
