"""Data pipeline tests: transform parameterization golden checks, Cityscapes
label remap table, synthetic dataset determinism, loader batching, metrics.
"""

import numpy as np

from kd_cheap_conv.data import (
    ExtNormalize,
    ExtRandomCrop,
    ExtRandomHorizontalFlip,
    ExtRandomScale,
    ExtToArray,
    SyntheticSegmentation,
    make_loader,
)
from kd_cheap_conv.data.cityscapes import CLASSES, decode_target, encode_target
from kd_cheap_conv.data.transforms import train_transform
from kd_cheap_conv.data.voc import VOCSegmentation, voc_cmap
from kd_cheap_conv.utils import StreamSegMetrics


def _img_lbl(h=40, w=60):
    rng = np.random.RandomState(0)
    return (rng.randint(0, 255, (h, w, 3), dtype=np.uint8),
            rng.randint(0, 21, (h, w)).astype(np.uint8))


def test_random_scale_joint_and_nearest_labels():
    img, lbl = _img_lbl()
    rng = np.random.default_rng(0)
    i2, l2 = ExtRandomScale((2.0, 2.0))(img, lbl, rng)
    assert i2.shape == (80, 120, 3) and l2.shape == (80, 120)
    # nearest label scaling preserves the label set exactly
    assert set(np.unique(l2)) <= set(np.unique(lbl))


def test_random_crop_pads_with_ignore():
    img, lbl = _img_lbl(30, 30)
    rng = np.random.default_rng(0)
    i2, l2 = ExtRandomCrop(64)(img, lbl, rng)
    assert i2.shape == (64, 64, 3) and l2.shape == (64, 64)
    assert (l2 == 255).sum() > 0  # padded region is void
    assert (i2[-1, -1] == 0).all()  # image pads zeros


def test_flip_is_joint():
    img, lbl = _img_lbl()
    rng = np.random.default_rng(1)  # chosen so flip triggers
    t = ExtRandomHorizontalFlip(p=1.0)
    i2, l2 = t(img, lbl, rng)
    assert (i2 == img[:, ::-1]).all() and (l2 == lbl[:, ::-1]).all()


def test_normalize_values():
    img, lbl = _img_lbl()
    arr, _ = ExtToArray()(img, lbl)
    out, _ = ExtNormalize()(arr, lbl)
    want = (img / 255.0 - np.array([0.485, 0.456, 0.406])) / np.array(
        [0.229, 0.224, 0.225])
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-6)


def test_train_transform_golden_seed():
    # fixed seed -> exact crop/scale/flip parameters (golden pipeline test)
    img, lbl = _img_lbl(100, 100)
    rng1 = np.random.default_rng(42)
    rng2 = np.random.default_rng(42)
    t = train_transform(64)
    i1, l1 = t(img, lbl, rng1)
    i2, l2 = t(img, lbl, rng2)
    assert (i1 == i2).all() and (l1 == l2).all()
    assert i1.shape == (64, 64, 3) and l1.dtype == np.int32


def test_cityscapes_label_remap_table():
    # byte-exact id->train_id mapping (SURVEY.md §4)
    raw = np.arange(34, dtype=np.uint8)
    enc = encode_target(raw)
    want = {7: 0, 8: 1, 11: 2, 12: 3, 13: 4, 17: 5, 19: 6, 20: 7, 21: 8,
            22: 9, 23: 10, 24: 11, 25: 12, 26: 13, 27: 14, 28: 15, 31: 16,
            32: 17, 33: 18}
    for rid in range(34):
        assert enc[rid] == want.get(rid, 255), rid
    # 19 eval classes exactly
    assert sum(1 for c in CLASSES if c.train_id != 255 and c.id >= 0) == 19
    # decode road -> its color
    assert tuple(decode_target(np.array([[0]]))[0, 0]) == (128, 64, 128)


def test_voc_cmap_known_colors():
    cmap = voc_cmap()
    assert tuple(cmap[0]) == (0, 0, 0)        # background
    assert tuple(cmap[1]) == (128, 0, 0)      # aeroplane
    assert tuple(cmap[15]) == (192, 128, 128) # person
    assert VOCSegmentation.decode_target(np.array([[1]])).shape == (1, 1, 3)


def test_synthetic_deterministic_and_valid():
    ds = SyntheticSegmentation(num_classes=19, size=64, length=8)
    i1, l1 = ds[3]
    i2, l2 = ds[3]
    assert (i1 == i2).all() and (l1 == l2).all()
    classes = set(np.unique(l1))
    assert classes <= set(range(19)) | {255}


def test_loader_batches_and_reproducible():
    ds = SyntheticSegmentation(num_classes=21, size=64, length=10,
                               transform=train_transform(48))
    b1 = list(make_loader(ds, batch_size=4, seed=7, num_epochs=1))
    b2 = list(make_loader(ds, batch_size=4, seed=7, num_epochs=1))
    assert len(b1) == 2  # drop_last
    assert b1[0][0].shape == (4, 48, 48, 3)
    assert b1[0][1].dtype == np.int32
    np.testing.assert_array_equal(b1[0][0], b2[0][0])
    np.testing.assert_array_equal(b1[1][1], b2[1][1])


def test_stream_seg_metrics_hand_example():
    m = StreamSegMetrics(3)
    t = np.array([[0, 0, 1, 2]])
    p = np.array([[0, 1, 1, 2]])
    m.update(t, p)
    r = m.get_results()
    # cm: true0:{p0:1,p1:1}, true1:{p1:1}, true2:{p2:1}
    assert r["Overall Acc"] == 3 / 4
    np.testing.assert_allclose(r["Mean Acc"], (0.5 + 1 + 1) / 3)
    # IoU: c0: 1/2, c1: 1/2, c2: 1/1
    np.testing.assert_allclose(r["Mean IoU"], (0.5 + 0.5 + 1.0) / 3)


def test_stream_seg_metrics_ignores_255():
    m = StreamSegMetrics(3)
    t = np.array([[0, 255]])
    p = np.array([[0, 1]])
    m.update(t, p)
    assert m.confusion_matrix.sum() == 1


def _fake_voc_tree(tmp_path):
    """Tiny on-disk VOC2012 layout (2 images) for offline transform tests."""
    from PIL import Image

    base = tmp_path / "VOC2012"
    (base / "JPEGImages").mkdir(parents=True)
    (base / "SegmentationClass").mkdir()
    (base / "ImageSets" / "Segmentation").mkdir(parents=True)
    rng = np.random.RandomState(0)
    names = ("a", "b")
    for n in names:
        Image.fromarray(rng.randint(0, 255, (60, 80, 3), np.uint8)).save(
            base / "JPEGImages" / f"{n}.jpg")
        Image.fromarray(rng.randint(0, 21, (60, 80)).astype(np.uint8)).save(
            base / "SegmentationClass" / f"{n}.png")
    for split in ("train", "val"):
        (base / "ImageSets" / "Segmentation" / f"{split}.txt").write_text(
            "\n".join(names) + "\n")
    return str(tmp_path)


def test_cached_det_transform_yields_stable_pixels(tmp_path):
    """--cached_det_transform swaps the train pipeline to val-style
    deterministic transforms, so multi-epoch cached-teacher training sees
    the same pixels every epoch instead of replayed epoch-0 augmentations
    (kd/cached.py caveat; VERDICT r2 weak #5)."""
    from main import get_argparser, get_dataset

    root = _fake_voc_tree(tmp_path)
    base = ["--dataset", "voc", "--data_root", root, "--crop_size", "32"]
    cached = ["--kd", "--cached_logits", str(tmp_path / "c.npz")]

    opts = get_argparser().parse_args(base + cached + ["--cached_det_transform"])
    train, _, _ = get_dataset(opts)
    # different per-epoch RNG streams -> identical pixels and fixed size
    img0, lbl0 = train.__getitem__(0, np.random.default_rng((0, 0, 0)))
    img1, lbl1 = train.__getitem__(0, np.random.default_rng((0, 1, 0)))
    assert img0.shape == (32, 32, 3)
    np.testing.assert_array_equal(img0, img1)
    np.testing.assert_array_equal(lbl0, lbl1)

    # without the flag the train pipeline stays random (sanity: the two
    # epoch streams disagree on these 60x80 sources)
    opts = get_argparser().parse_args(base + cached)
    train, _, _ = get_dataset(opts)
    img0, _ = train.__getitem__(0, np.random.default_rng((0, 0, 0)))
    img1, _ = train.__getitem__(0, np.random.default_rng((0, 1, 0)))
    assert img0.shape != img1.shape or not np.array_equal(img0, img1)
