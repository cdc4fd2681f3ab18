"""Optimizer: SGD(momentum 0.9, weight decay) with PolyLR and the reference's
two parameter groups — backbone at 1x LR, classifier/head at 10x
(SURVEY.md §2.4/§3.1). Progressive KD additionally freezes everything outside
the active stage (SURVEY.md §3.3) via a zero-update group.

By default the whole update runs on ONE flattened vector (ravel_pytree)
with a per-element lr-multiplier vector encoding the groups, so the update
is a handful of ops on one vector instead of hundreds of tiny per-leaf
kernels (leaf-wise optax.multi_transform). Math identical to torch SGD with
per-group lrs: grad += wd*p; v = mu*v + grad; p -= lr_t*mult*v.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import optax
from jax.flatten_util import ravel_pytree


def poly_schedule(base_lr: float, max_iters: int, power: float = 0.9):
    """lr = base_lr * (1 - step/max_iters)^power — reference PolyLR."""

    def schedule(step):
        import jax.numpy as jnp

        frac = jnp.clip(1.0 - step / max_iters, 0.0, 1.0)
        return base_lr * frac ** power

    return schedule


def step_schedule(base_lr: float, step_size: int, gamma: float = 0.1):
    """lr = base_lr * gamma^(step // step_size) — reference --lr_policy step
    (torch StepLR)."""

    def schedule(step):
        return base_lr * gamma ** (step // step_size)

    return schedule


def _sgd(lr_schedule, momentum, weight_decay):
    # torch SGD order: grad += wd * param, then momentum buffer, then lr
    return optax.chain(
        optax.add_decayed_weights(weight_decay) if weight_decay else optax.identity(),
        optax.sgd(learning_rate=lr_schedule, momentum=momentum, nesterov=False),
    )


def _dotted(path) -> str:
    parts = []
    for p in path:
        key = getattr(p, "key", getattr(p, "idx", getattr(p, "name", p)))
        parts.append(str(key))
    return ".".join(parts)


def make_optimizer(
    params,
    *,
    lr: float = 0.01,
    max_iters: int = 30_000,
    power: float = 0.9,
    momentum: float = 0.9,
    weight_decay: float = 1e-4,
    head_lr_mult: float = 10.0,
    lr_policy: str = "poly",
    step_size: int = 10_000,
    step_gamma: float = 0.1,
    fused: bool = True,
    trainable_prefixes: tuple[str, ...] | None = None,
    label_fn: Callable[[str], str] | None = None,
) -> optax.GradientTransformation:
    """Build the reference optimizer over an NNX param state pytree.

    Args:
      params: the nnx.Param state (pytree) the optimizer will be init'd with.
      trainable_prefixes: if given, params whose dotted path does not start
        with any prefix get zero updates (frozen) — the progressive
        schedule's per-stage mask (BASELINE.json config #4).
      label_fn: optional override mapping dotted path -> group label.
    """
    if lr_policy == "step":
        sched = step_schedule(lr, step_size, step_gamma)
        sched_head = step_schedule(lr * head_lr_mult, step_size, step_gamma)
    else:
        sched = poly_schedule(lr, max_iters, power)
        sched_head = poly_schedule(lr * head_lr_mult, max_iters, power)

    def default_label(dotted: str) -> str:
        if trainable_prefixes is not None and not any(
            dotted == p or dotted.startswith(p + ".")
            for p in trainable_prefixes
        ):
            return "frozen"
        return "backbone" if dotted.startswith("backbone") else "head"

    fn = label_fn or default_label
    labels = jax.tree_util.tree_map_with_path(
        lambda path, _: fn(_dotted(path)), params
    )
    if not fused:
        return optax.multi_transform(
            {
                "backbone": _sgd(sched, momentum, weight_decay),
                "head": _sgd(sched_head, momentum, weight_decay),
                "frozen": optax.set_to_zero(),
            },
            labels,
        )

    # --- fused flat-vector SGD (see module docstring) ---
    mult_map = {"backbone": 1.0, "head": float(head_lr_mult), "frozen": 0.0}
    mult_tree = jax.tree.map(
        lambda p, l: jnp.full(jnp.shape(p), mult_map[l], jnp.float32),
        params, labels)
    flat_mult, _ = ravel_pytree(mult_tree)

    class FusedSGDState(NamedTuple):
        momentum: jax.Array
        count: jax.Array

    def init(params):
        flat, _ = ravel_pytree(params)
        return FusedSGDState(momentum=jnp.zeros_like(flat, jnp.float32),
                             count=jnp.zeros((), jnp.int32))

    def update(grads, state, params=None):
        assert params is not None, "fused SGD needs params (weight decay)"
        gf, _ = ravel_pytree(grads)
        pf, unravel = ravel_pytree(params)
        gf = gf.astype(jnp.float32) + weight_decay * pf.astype(jnp.float32)
        v = momentum * state.momentum + gf
        lr_t = sched(state.count)
        upd_flat = (-lr_t) * flat_mult * v
        updates = unravel(upd_flat.astype(pf.dtype))
        return updates, FusedSGDState(momentum=v, count=state.count + 1)

    return optax.GradientTransformation(init, update)
