"""Grain-backed loader (data.grain_pipeline): same contract as make_loader,
deterministic sampling, disjoint host shards, CLI smoke."""

import numpy as np

from kd_cheap_conv.data import SyntheticSegmentation
from kd_cheap_conv.data.grain_pipeline import make_grain_loader
from kd_cheap_conv.data.transforms import train_transform


def _ds(length=20):
    return SyntheticSegmentation(num_classes=6, size=64, length=length,
                                 transform=train_transform(33))


def test_grain_loader_shapes_and_determinism():
    ds = _ds()
    b1 = list(make_grain_loader(ds, batch_size=8, shuffle=True, seed=3,
                                num_epochs=1))
    assert len(b1) == 2  # 20 records, drop_last
    for images, labels in b1:
        assert images.shape == (8, 33, 33, 3) and images.dtype == np.float32
        assert labels.shape == (8, 33, 33) and labels.dtype == np.int32
    b2 = next(iter(make_grain_loader(ds, batch_size=8, shuffle=True, seed=3,
                                     num_epochs=1)))
    np.testing.assert_array_equal(b1[0][0], b2[0])
    np.testing.assert_array_equal(b1[0][1], b2[1])


def test_grain_loader_host_shards_disjoint():
    """Multi-host mode: each shard sees its own records (label content
    differs because the synthetic dataset derives content from the index)."""
    ds = _ds()

    def labels_of(shard):
        out = []
        for _, lbl in make_grain_loader(ds, batch_size=2, shuffle=False,
                                        num_epochs=1, shard_index=shard,
                                        shard_count=2):
            out.append(lbl)
        return np.concatenate(out)

    l0, l1 = labels_of(0), labels_of(1)
    assert l0.shape == l1.shape
    assert not np.array_equal(l0, l1)


def test_cli_grain_loader_smoke(tmp_path):
    import main as cli

    args = [
        "--dataset", "synthetic", "--model", "deeplabv3plus_mobilenet",
        "--num_classes", "6", "--crop_size", "33", "--batch_size", "8",
        "--val_batch_size", "8", "--total_itrs", "2", "--val_interval", "2",
        "--print_interval", "1", "--data_loader", "grain",
        "--ckpt_dir", str(tmp_path / "ck"), "--num_workers", "2",
    ]
    assert cli.main(args) == 0


class _BackendProbe:
    """A dataset whose samples record whether JAX has started a backend in
    the process that loads them."""

    def __len__(self):
        return 4

    def __getitem__(self, idx, rng=None):
        from jax._src import xla_bridge

        flag = int(xla_bridge.backends_are_initialized())
        return (np.zeros((3, 3, 3), np.float32),
                np.full((3, 3), flag, np.int32))


def test_grain_workers_never_start_a_jax_backend():
    """--data_loader grain runs its transforms in spawned worker processes;
    none of them may initialize JAX (on a GPU a second backend would take
    the card's memory)."""
    batches = list(make_grain_loader(_BackendProbe(), batch_size=2,
                                     shuffle=False, num_epochs=1,
                                     num_workers=2))
    assert len(batches) == 2
    assert all(int(lbl.max()) == 0 for _, lbl in batches)
