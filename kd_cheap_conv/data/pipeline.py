"""Host input pipeline: threaded decode/augment workers + double-buffered
device prefetch (BASELINE.json:5 "fused host-side ... feeding HBM with
double-buffered prefetch").

The host side stays deliberately simple and deterministic: an epoch
permutation from a seeded Generator, a thread pool running the joint
transforms (PIL/numpy release the GIL for the heavy parts), and
`prefetch_to_device`, which keeps `buffer_size` batches resident on device
(sharded over the mesh when given) so the device never waits on H2D.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from queue import Queue
from typing import Iterator

import jax
import numpy as np

from ..parallel.mesh import batch_sharding


def make_loader(
    dataset,
    *,
    batch_size: int,
    shuffle: bool = True,
    drop_last: bool = True,
    seed: int = 0,
    num_workers: int = 8,
    num_epochs: int | None = None,
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Yields (images f32 NHWC, labels i32 NHW) numpy batches.

    Per-sample RNG is derived from (seed, epoch, index) so augmentations are
    reproducible and independent of worker scheduling (SURVEY.md §4 golden
    pipeline tests).
    """
    n = len(dataset)
    epoch = 0
    # num_workers=0 (the reference DataLoader's "in-process" convention)
    # maps to a single worker thread; ThreadPoolExecutor rejects 0.
    with ThreadPoolExecutor(max_workers=max(1, num_workers)) as pool:
        while num_epochs is None or epoch < num_epochs:
            order = np.arange(n)
            if shuffle:
                np.random.default_rng((seed, epoch)).shuffle(order)
            for start in range(0, n, batch_size):
                idxs = order[start:start + batch_size]
                if len(idxs) < batch_size and drop_last:
                    break

                def _get(i):
                    rng = np.random.default_rng((seed, epoch, int(i)))
                    return dataset.__getitem__(int(i), rng)

                samples = list(pool.map(_get, idxs))
                cols = list(zip(*samples))
                images = np.stack(cols[0]).astype(np.float32)
                labels = np.stack(cols[1]).astype(np.int32)
                if len(cols) == 2:
                    yield images, labels
                else:  # cached-teacher mode: (image, label, logits, ...)
                    extras = tuple(np.stack(c).astype(np.float32)
                                   for c in cols[2:])
                    yield (images, labels, *extras)
            epoch += 1


def prefetch_to_device(iterator, *, mesh=None, buffer_size: int = 2,
                       host_s2d: bool = False):
    """Wrap a host batch iterator with an async device-transfer queue.

    With a mesh, batches land sharded over the 'data' axis; otherwise on the
    default device. A background thread stays `buffer_size` batches ahead, so
    H2D copy overlaps with the running step (double buffering).

    host_s2d: space-to-depth-pack the image tensor on the host
    (ops.conv.s2d_pack) so the entry stems consume the 12-channel packed
    tensor directly (KDCC_HOST_S2D; the pack runs in the producer thread,
    overlapped with the device step). Applied only to 3-channel odd-sized
    image batches — cached-logit extras and labels pass through untouched.
    """
    sharding = batch_sharding(mesh) if mesh is not None else None
    q: Queue = Queue(maxsize=buffer_size)
    _SENTINEL = object()

    def _pack(batch):
        imgs = batch[0]
        if (imgs.ndim == 4 and imgs.shape[-1] == 3
                and imgs.shape[1] % 2 == 1 and imgs.shape[2] % 2 == 1):
            from ..ops.conv import s2d_pack

            return (s2d_pack(imgs), *batch[1:])
        return batch

    def _producer():
        try:
            for batch in iterator:
                if host_s2d:
                    batch = _pack(batch)
                first = jax.tree.leaves(batch)[0]
                if (sharding is not None
                        and first.shape[0] % sharding.mesh.size == 0):
                    batch = jax.tree.map(
                        lambda x: jax.device_put(x, sharding), batch)
                else:
                    # trailing partial batch (drop_last=False eval) can't
                    # shard over the data axis — place replicated/uncommitted
                    batch = jax.tree.map(jax.device_put, batch)
                q.put(batch)
        finally:
            q.put(_SENTINEL)

    t = threading.Thread(target=_producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            break
        yield item
