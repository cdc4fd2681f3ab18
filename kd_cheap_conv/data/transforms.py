"""Joint image+label transforms — the reference's `ext_transforms` pipeline
(SURVEY.md §2.3, BASELINE.json:5 "decode, random-scale/crop/flip, normalize,
label remap").

Host-side numpy/PIL: these run in loader workers feeding the device prefetch
queue; images interpolate bilinearly, labels nearest, crops pad-if-needed with
the ignore fill (255) on labels and 0 on images. Randomness is explicit — every
random transform takes a numpy Generator so golden tests can pin parameters
(SURVEY.md §4 "golden tests for the data pipeline").

Output convention is NHWC: ExtToArray yields float32 HWC in [0,1] and int32
HW labels (the reference's ExtToTensor yields CHW — layout is the one
deliberate departure; the models are channels-last).
"""

from __future__ import annotations

import numpy as np
from PIL import Image

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _to_pil(img: np.ndarray, label: bool = False) -> Image.Image:
    if label:
        return Image.fromarray(img.astype(np.uint8), mode="L")
    return Image.fromarray(img.astype(np.uint8))


class ExtCompose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, img, lbl, rng: np.random.Generator | None = None):
        if rng is None:
            rng = np.random.default_rng()
        for t in self.transforms:
            img, lbl = t(img, lbl, rng)
        return img, lbl


class ExtRandomScale:
    """Uniform scale in [lo, hi]; image bilinear, label nearest."""

    def __init__(self, scale_range=(0.5, 2.0)):
        self.lo, self.hi = scale_range

    def __call__(self, img, lbl, rng):
        s = float(rng.uniform(self.lo, self.hi))
        h, w = img.shape[:2]
        nh, nw = max(1, int(round(h * s))), max(1, int(round(w * s)))
        im = _to_pil(img).resize((nw, nh), Image.BILINEAR)
        lb = _to_pil(lbl, label=True).resize((nw, nh), Image.NEAREST)
        return np.asarray(im), np.asarray(lb)


class ExtResize:
    """Resize shorter side to `size` (int) or to exact (h, w)."""

    def __init__(self, size):
        self.size = size

    def __call__(self, img, lbl, rng=None):
        h, w = img.shape[:2]
        if isinstance(self.size, int):
            if h < w:
                nh, nw = self.size, max(1, int(round(w * self.size / h)))
            else:
                nh, nw = max(1, int(round(h * self.size / w))), self.size
        else:
            nh, nw = self.size
        im = _to_pil(img).resize((nw, nh), Image.BILINEAR)
        lb = _to_pil(lbl, label=True).resize((nw, nh), Image.NEAREST)
        return np.asarray(im), np.asarray(lb)


class ExtRandomCrop:
    """Random crop with pad-if-needed: image pads 0, label pads ignore (255)."""

    def __init__(self, size, pad_if_needed=True, ignore_index=255):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.pad_if_needed = pad_if_needed
        self.ignore_index = ignore_index

    def __call__(self, img, lbl, rng):
        th, tw = self.size
        h, w = img.shape[:2]
        if self.pad_if_needed and (h < th or w < tw):
            ph, pw = max(th - h, 0), max(tw - w, 0)
            img = np.pad(img, ((0, ph), (0, pw), (0, 0)))
            lbl = np.pad(lbl, ((0, ph), (0, pw)),
                         constant_values=self.ignore_index)
            h, w = img.shape[:2]
        i = int(rng.integers(0, h - th + 1))
        j = int(rng.integers(0, w - tw + 1))
        return img[i:i + th, j:j + tw], lbl[i:i + th, j:j + tw]


class ExtCenterCrop:
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img, lbl, rng=None):
        th, tw = self.size
        h, w = img.shape[:2]
        i = max((h - th) // 2, 0)
        j = max((w - tw) // 2, 0)
        return img[i:i + th, j:j + tw], lbl[i:i + th, j:j + tw]


class ExtRandomHorizontalFlip:
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, img, lbl, rng):
        if rng.random() < self.p:
            return img[:, ::-1].copy(), lbl[:, ::-1].copy()
        return img, lbl


class ExtToArray:
    """uint8 HWC [0,255] -> float32 HWC [0,1]; label -> int32 HW."""

    def __call__(self, img, lbl, rng=None):
        return (np.asarray(img, np.float32) / 255.0,
                np.asarray(lbl, np.int32))


class ExtNormalize:
    def __init__(self, mean=IMAGENET_MEAN, std=IMAGENET_STD):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, img, lbl, rng=None):
        return (img - self.mean) / self.std, lbl


class ExtToNormalizedArray:
    """Fused uint8 HWC -> normalized float32 HWC (== ExtToArray+ExtNormalize).

    Uses the native C kernel (native/hostops.c) when built — one pass, no
    float temporaries — with the numpy composition as fallback/oracle.
    """

    def __init__(self, mean=IMAGENET_MEAN, std=IMAGENET_STD):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, img, lbl, rng=None):
        lbl = np.asarray(lbl, np.int32)
        if img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
            from ..native import normalize_u8_f32

            out = normalize_u8_f32(img, self.mean, self.std)
            if out is not None:
                return out, lbl
        arr = np.asarray(img, np.float32) / 255.0
        return (arr - self.mean) / self.std, lbl


def train_transform(crop_size: int, scale_range=(0.5, 2.0)) -> ExtCompose:
    """The reference's train pipeline (SURVEY.md §2.3)."""
    return ExtCompose([
        ExtRandomScale(scale_range),
        ExtRandomCrop(crop_size, pad_if_needed=True),
        ExtRandomHorizontalFlip(),
        ExtToNormalizedArray(),
    ])


def val_transform(crop_size: int | None = None) -> ExtCompose:
    """Val pipeline; with crop_size set, resize+center-crop (--crop_val)."""
    ts = []
    if crop_size is not None:
        ts += [ExtResize(crop_size), ExtCenterCrop(crop_size)]
    ts += [ExtToNormalizedArray()]
    return ExtCompose(ts)
