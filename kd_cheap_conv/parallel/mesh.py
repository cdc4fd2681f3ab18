"""Mesh / sharding helpers — the build's first-class distribution layer.

The reference's only parallelism is single-process DataParallel
(SURVEY.md §2.6); the JAX equivalent is SPMD batch-axis sharding: one
`jax.sharding.Mesh` with a 'data' axis, batches sharded over it,
parameters replicated. Under `jit`, XLA emits the gradient all-reduce
(NCCL over NVLink on GPUs) and computes BN moments over the global batch
(sync-BN for free).
Multi-host runs extend the same program across hosts via
`jax.distributed.initialize` (SURVEY.md §5.8) — no code changes here.

These models are <60M params: no tensor/pipeline sharding is warranted
(SURVEY.md §2.6); the mesh is 1-D on purpose.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"


def make_mesh(devices=None, *, axis_name: str = DATA_AXIS) -> Mesh:
    """1-D data-parallel mesh over all (or the given) devices."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def batch_sharding(mesh: Mesh, *, axis_name: str = DATA_AXIS) -> NamedSharding:
    """Leading-axis (batch) sharding for NHWC images / NHW labels."""
    return NamedSharding(mesh, P(axis_name))


def shard_batch(batch, mesh: Mesh, *, axis_name: str = DATA_AXIS):
    """Place a host batch pytree onto the mesh, sharded along axis 0.

    Batch size must be divisible by mesh size (static shapes for XLA).
    """
    sharding = batch_sharding(mesh, axis_name=axis_name)
    n = mesh.devices.size

    def _put(x):
        assert x.shape[0] % n == 0, (
            f"batch dim {x.shape[0]} not divisible by mesh size {n}"
        )
        return jax.device_put(x, sharding)

    return jax.tree.map(_put, batch)


def replicate(tree, mesh: Mesh):
    """Fully replicate a pytree (params/opt state) over the mesh."""
    sharding = NamedSharding(mesh, P())
    return jax.tree.map(lambda x: jax.device_put(x, sharding), tree)
