"""Cached-teacher-logits mode (BASELINE.json config #1; SURVEY.md §2.2
"Cached-teacher mode": teacher forward precomputed and stored, decoupling
teacher inference from the student train loop).

Workflow:
  1. `precompute_teacher_logits(teacher, dataset, path)` — run the eval-mode
     teacher over the (deterministically-transformed) dataset once on device,
     store logits per sample in a .npz (float16 to halve disk/IO).
  2. `CachedLogitsDataset(dataset, path)` — wraps the dataset so
     __getitem__ yields (image, label, teacher_logits); feed batches to
     `make_kd_train_step(..., cached_teacher=True)`.

Caveat: augmentations must be deterministic per index (our loader derives
per-sample RNG from (seed, epoch, index)) and the cache must be built with
the SAME seed/epoch stream, or logits won't match the pixels. The simple
contract used here: build the cache with transform applied at epoch 0 and
train with num_epochs=1-style iteration, or use deterministic (val-style)
transforms — the reference has the same constraint. The CLI exposes the
deterministic option as --cached_det_transform (main.py): the train set is
built with val-style resize+center-crop so multi-epoch cached training sees
stable pixels instead of replayed epoch-0 random augmentations.
"""

from __future__ import annotations

import numpy as np


def precompute_teacher_logits(teacher, dataset, path: str, *, batch_size: int = 8,
                              seed: int = 0, epoch: int = 0) -> str:
    """Run teacher over `dataset` (transform included) and save logits."""
    import jax
    import jax.numpy as jnp
    from .. import nnx

    teacher.eval()
    graphdef, state = nnx.split(teacher)

    @jax.jit
    def fwd(state, images):
        return nnx.merge(graphdef, state)(images)

    logits_all = []
    n = len(dataset)
    for start in range(0, n, batch_size):
        idxs = range(start, min(start + batch_size, n))
        samples = [
            dataset.__getitem__(i, np.random.default_rng((seed, epoch, int(i))))
            for i in idxs
        ]
        images = jnp.asarray(np.stack([s[0] for s in samples]), jnp.float32)
        out = np.asarray(fwd(state, images), np.float16)
        logits_all.extend(out)
    np.savez_compressed(path, logits=np.stack(logits_all),
                        seed=seed, epoch=epoch)
    return path


class CachedLogitsDataset:
    """Wraps a dataset to yield (image, label, teacher_logits)."""

    def __init__(self, dataset, path: str):
        self.dataset = dataset
        data = np.load(path)
        self.logits = data["logits"]
        self.seed = int(data["seed"])
        self.epoch = int(data["epoch"])
        if len(self.logits) != len(dataset):
            raise ValueError(
                f"cache has {len(self.logits)} entries, dataset has "
                f"{len(dataset)}")

    def __len__(self):
        return len(self.dataset)

    @property
    def num_classes(self):
        return getattr(self.dataset, "num_classes", self.logits.shape[-1])

    def __getitem__(self, idx, rng=None):
        # pin the per-sample rng to the cache's stream so pixels match logits
        rng = np.random.default_rng((self.seed, self.epoch, int(idx)))
        img, lbl = self.dataset.__getitem__(idx, rng)
        return img, lbl, self.logits[idx].astype(np.float32)
