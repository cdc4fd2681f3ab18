"""ctypes bindings for the native host-ops library (hostops.c).

`lib()` compiles on first use (gcc -O3 -fopenmp, cached as hostops.so next to
the source; the build output is not tracked by git) and returns the loaded
library, or None if no toolchain — all callers must keep a numpy fallback.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "hostops.c")
_SO = os.path.join(_HERE, "hostops.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    """Compile to a per-process temporary name, then rename into place, so
    processes that build at the same time never load a partial file."""
    tmp = f"{_SO}.tmp{os.getpid()}"
    for flags in (["-fopenmp"], []):   # fallback without OpenMP
        cmd = ["gcc", "-O3", *flags, "-shared", "-fPIC", "-o", tmp, _SRC]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            continue
        os.replace(tmp, _SO)
        return True
    return False


def lib():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SO) or (
            os.path.getmtime(_SO) < os.path.getmtime(_SRC)
        ):
            if not _build():
                return None
        try:
            L = ctypes.CDLL(_SO)
        except OSError:
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        L.remap_u8.argtypes = [u8p, u8p, u8p, ctypes.c_size_t]
        L.normalize_u8_f32.argtypes = [u8p, f32p, f32p, f32p, ctypes.c_size_t]
        L.hflip_u8.argtypes = [u8p, u8p, ctypes.c_size_t, ctypes.c_size_t,
                               ctypes.c_size_t]
        _lib = L
        return _lib


def _u8(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def remap_u8(labels: np.ndarray, table: np.ndarray) -> np.ndarray | None:
    L = lib()
    if L is None:
        return None
    labels = np.ascontiguousarray(labels, np.uint8)
    table = np.ascontiguousarray(table, np.uint8)
    out = np.empty_like(labels)
    L.remap_u8(_u8(labels), _u8(out), _u8(table), labels.size)
    return out


def normalize_u8_f32(img: np.ndarray, mean, std) -> np.ndarray | None:
    """Fused (img/255 - mean)/std for HWC uint8 with 3 channels."""
    L = lib()
    if L is None or img.ndim != 3 or img.shape[2] != 3:
        return None
    img = np.ascontiguousarray(img, np.uint8)
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    scale = np.ascontiguousarray(1.0 / (255.0 * std), np.float32)
    bias = np.ascontiguousarray(-mean / std, np.float32)
    out = np.empty(img.shape, np.float32)
    L.normalize_u8_f32(_u8(img), _f32(out), _f32(scale), _f32(bias),
                       img.shape[0] * img.shape[1])
    return out


def hflip_u8(arr: np.ndarray) -> np.ndarray | None:
    L = lib()
    if L is None:
        return None
    a = np.ascontiguousarray(arr, np.uint8)
    h, w = a.shape[:2]
    c = a.shape[2] if a.ndim == 3 else 1
    out = np.empty_like(a)
    L.hflip_u8(_u8(a), _u8(out), h, w, c)
    return out.reshape(arr.shape)
