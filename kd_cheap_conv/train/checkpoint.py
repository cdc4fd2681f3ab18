"""Checkpoint / resume, mirroring the reference layout
(SURVEY.md §2.4/§5.4, BASELINE.json:5 "checkpoint layout").

Reference saves `{cur_itrs, model_state, optimizer_state, scheduler_state,
best_score}` to `checkpoints/latest_<model>_<dataset>_os<os>.pth` and
`best_...pth`, resumed via `--ckpt [--continue_training]`. Here the same
logical keys live in directories `latest_.../` and `best_.../`, each holding
one `checkpoint.npz` whose entries are named by the "/"-joined key path of
each leaf; `scheduler_state` is the PolyLR step (the schedule is a pure
function of it).

Also provides `import_torch_state_dict`: loads a reference-format `.pth`
(torch CPU) and maps it onto an NNX model for teacher init / parity tests
(SURVEY.md §7 "torch-checkpoint import path").
"""

from __future__ import annotations

import os
import re

import jax
import numpy as np

from .. import nnx


def _ckpt_name(prefix: str, model: str, dataset: str, output_stride: int) -> str:
    return f"{prefix}_{model}_{dataset}_os{output_stride}"


def checkpoint_path(root: str, prefix: str, model: str, dataset: str,
                    output_stride: int) -> str:
    return os.path.join(os.path.abspath(root),
                        _ckpt_name(prefix, model, dataset, output_stride))


_FILE = "checkpoint.npz"


def _key_name(entry) -> str:
    for attr in ("key", "idx", "name"):
        if hasattr(entry, attr):
            return str(getattr(entry, attr))
    raise TypeError(f"unsupported pytree key {entry!r}")


def _flat_named(tree) -> dict:
    """{"a/b/0": leaf} for every leaf of `tree`."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(_key_name(e) for e in path): leaf
            for path, leaf in leaves}


def save_checkpoint(path: str, *, cur_itrs: int, params, rest, opt_state,
                    best_score: float) -> None:
    """Save the reference's five keys. The file is written under a temporary
    name and renamed, so a reader never sees a partial checkpoint."""
    tree = {
        "cur_itrs": np.asarray(cur_itrs, np.int32),
        "model_state": {"params": params, "rest": rest},
        "optimizer_state": opt_state,
        "scheduler_state": {"step": np.asarray(cur_itrs, np.int32)},
        "best_score": np.asarray(best_score, np.float32),
    }
    arrays = {k: np.asarray(v) for k, v in _flat_named(tree).items()}
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, _FILE + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, os.path.join(path, _FILE))


def load_checkpoint(path: str, target=None):
    """Restore. With `target` (a pytree of the same structure) the result
    has `target`'s structure and every shape and dtype is checked; without
    it, nested dicts keyed by the saved path names come back."""
    with np.load(os.path.join(path, _FILE)) as f:
        arrays = {k: f[k] for k in f.files}
    if target is None:
        out: dict = {}
        for name, arr in arrays.items():
            node = out
            *parents, last = name.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[last] = arr
        return out
    leaves = []
    for name, want in _flat_named(target).items():
        if name not in arrays:
            raise ValueError(f"checkpoint {path} has no entry {name!r}")
        got = arrays[name]
        if got.shape != np.shape(want) or got.dtype != np.asarray(want).dtype:
            raise ValueError(
                f"checkpoint entry {name!r} is {got.dtype}{list(got.shape)}, "
                f"expected {np.asarray(want).dtype}{list(np.shape(want))}")
        leaves.append(got)
    return jax.tree_util.tree_unflatten(jax.tree.structure(target), leaves)


def restore_train_state(path: str, state):
    """Full --continue_training restore: params + BN stats + optimizer state
    (momentum AND the schedule count, so poly LR continues instead of
    restarting) + step + best_score (reference resume semantics,
    SURVEY.md §2.4 checkpoint row).

    `state` is the freshly init'd TrainState whose structure the checkpoint
    must match (same model/KD config). Returns (new_state, best_score).
    """
    import jax.numpy as jnp

    target = {
        "cur_itrs": np.zeros((), np.int32),
        "model_state": {"params": state.params, "rest": state.rest},
        "optimizer_state": state.opt_state,
        "scheduler_state": {"step": np.zeros((), np.int32)},
        "best_score": np.zeros((), np.float32),
    }
    restored = load_checkpoint(path, target=target)
    init_shardings = jax.tree.map(lambda leaf: getattr(leaf, "sharding", None),
                                  state)
    new_state = state.replace(
        params=restored["model_state"]["params"],
        rest=restored["model_state"]["rest"],
        opt_state=restored["optimizer_state"],
        step=jnp.asarray(restored["cur_itrs"], jnp.int32))

    def _placed_like(sharding, new):
        """Match the init'd state's placement: if the fresh state leaf
        carried a mesh (Named) sharding, place there explicitly; otherwise
        hand back host numpy — uncommitted, so jit places it exactly like
        the freshly-initialized state."""
        from jax.sharding import NamedSharding

        if isinstance(sharding, NamedSharding):
            return jax.device_put(jnp.asarray(new), sharding)
        return np.asarray(new)

    # is_leaf: sharding-snapshot leaves may be None (non-array leaves), which
    # pytree flattening would otherwise treat as an empty subtree
    new_state = jax.tree.map(_placed_like, init_shardings, new_state,
                             is_leaf=lambda x: x is None)
    return new_state, float(restored["best_score"])


# ---------------------------------------------------------------------------
# torch .pth import (teacher weights / parity oracle)
# ---------------------------------------------------------------------------

def _torch_key_to_path(key: str) -> list:
    """'backbone.layer1.0.conv1.weight' -> path segments with int indices."""
    return [int(p) if p.isdigit() else p for p in key.split(".")]


def import_torch_state_dict(model: nnx.Module, state_dict: dict, *,
                            strict: bool = False) -> tuple[int, list[str]]:
    """Map a torch state_dict (OIHW convs, NCHW stats) onto an NNX model.

    Handles: conv weight OIHW->HWIO (grouped included),
    BN weight/bias/running_mean/running_var -> scale/bias/mean/var.
    Returns (num_loaded, missing_keys). Key layout must structurally match —
    this is for checkpoints produced by reference-shaped torch models.
    """
    import jax.numpy as jnp

    loaded, missing = 0, []
    by_path = dict(_iter_params(model))
    for key, tensor in state_dict.items():
        if key.endswith("num_batches_tracked"):
            continue
        arr = np.asarray(tensor.detach().cpu().numpy() if hasattr(tensor, "detach")
                         else tensor)
        path = tuple(_torch_key_to_path(key))
        leaf, kind = _resolve(by_path, path)
        if leaf is None:
            missing.append(key)
            continue
        if kind == "conv_kernel":
            arr = arr.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        if leaf[...].shape != arr.shape:
            missing.append(f"{key} (shape {arr.shape} vs {leaf[...].shape})")
            continue
        leaf[...] = jnp.asarray(arr)
        loaded += 1
    if strict and missing:
        raise ValueError(f"unmapped torch keys: {missing[:10]}...")
    return loaded, missing


_TORCH_TO_NNX_LEAF = {
    # torch name -> (nnx attr on module, kind)
    "weight": None,  # context-dependent, resolved below
    "bias": ("bias", "bias"),
    "running_mean": ("mean", "stat"),
    "running_var": ("var", "stat"),
}


def _iter_params(model: nnx.Module):
    """Yield ((path..., leafname), (variable, kind)) for mappable leaves."""
    from ..models.layers import Conv2d

    for path, mod in nnx.iter_modules(model):
        if isinstance(mod, Conv2d):
            yield (*path, "weight"), (mod.kernel, "conv_kernel")
            if mod.bias is not None:
                yield (*path, "bias"), (mod.bias, "bias")
        elif isinstance(mod, nnx.BatchNorm):
            yield (*path, "weight"), (mod.scale, "bn_scale")
            yield (*path, "bias"), (mod.bias, "bias")
            yield (*path, "running_mean"), (mod.mean, "stat")
            yield (*path, "running_var"), (mod.var, "stat")


def _resolve(by_path: dict, path: tuple):
    hit = by_path.get(path)
    if hit is None:
        return None, None
    return hit
