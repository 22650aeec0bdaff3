"""Batch fetch + augment: ctypes binding over the native pipeline, with a
NumPy fallback implementing identical (deterministic) semantics.

Randomness contract (matches imagepipe.cpp): each sample's augmentation
derives from splitmix64(seed, epoch, dataset_index) only — thread-schedule
independent and resume-reproducible (SURVEY.md §5.3)."""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from ..native import build

_MASK = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK
    return x ^ (x >> 31)


def _lib():
    lib = build.load("imagepipe")
    if lib is not None:
        try:
            assert lib.vitrs_imagepipe_abi() == 1
        except Exception:
            return None
    return lib


def _reflect(i: np.ndarray, n: int) -> np.ndarray:
    i = np.abs(i)
    i = np.where(i >= n, 2 * n - 2 - i, i)
    return np.clip(i, 0, n - 1)


def _augment_numpy(images, indices, crop_pad, flip, seed, epoch, mean, std):
    n = len(indices)
    H, W, C = images.shape[1:]
    out = np.empty((n, H, W, C), np.float32)
    inv = 1.0 / std
    for i, idx in enumerate(indices):
        s = _splitmix64(seed ^ _splitmix64(epoch ^ _splitmix64(int(idx))))
        dy = dx = 0
        do_flip = 0
        if crop_pad > 0:
            s = _splitmix64(s)
            dy = int(s % (2 * crop_pad + 1)) - crop_pad
            s = _splitmix64(s)
            dx = int(s % (2 * crop_pad + 1)) - crop_pad
        if flip:
            s = _splitmix64(s)
            do_flip = int(s & 1)
        ys = _reflect(np.arange(H) + dy, H)
        xs = np.arange(W) + dx
        if do_flip:
            xs = (W - 1) - xs
        xs = _reflect(xs, W)
        img = images[idx][np.ix_(ys, xs)].astype(np.float32)
        out[i] = (img * (1.0 / 255.0) - mean) * inv
    return out


def _augment_numpy_u8(images, indices, crop_pad, flip, seed, epoch):
    """Geometry-only augment (crop/flip), uint8 in -> uint8 out.  Same
    per-sample RNG contract as `_augment_numpy` so a run is reproducible
    regardless of where normalization happens (host vs device)."""
    n = len(indices)
    H, W, C = images.shape[1:]
    out = np.empty((n, H, W, C), np.uint8)
    for i, idx in enumerate(indices):
        s = _splitmix64(seed ^ _splitmix64(epoch ^ _splitmix64(int(idx))))
        dy = dx = 0
        do_flip = 0
        if crop_pad > 0:
            s = _splitmix64(s)
            dy = int(s % (2 * crop_pad + 1)) - crop_pad
            s = _splitmix64(s)
            dx = int(s % (2 * crop_pad + 1)) - crop_pad
        if flip:
            s = _splitmix64(s)
            do_flip = int(s & 1)
        ys = _reflect(np.arange(H) + dy, H)
        xs = np.arange(W) + dx
        if do_flip:
            xs = (W - 1) - xs
        xs = _reflect(xs, W)
        out[i] = images[idx][np.ix_(ys, xs)]
    return out


def augment_batch(images: np.ndarray, indices: np.ndarray,
                  crop_pad: int = 0, flip: bool = False,
                  seed: int = 0, epoch: int = 0,
                  mean: Optional[np.ndarray] = None,
                  std: Optional[np.ndarray] = None,
                  nthreads: int = 0, out_uint8: bool = False) -> np.ndarray:
    """(num_total, H, W, C) uint8 + indices -> (n, H, W, C) float32.

    out_uint8=True skips host normalization and returns uint8 (4x less
    host->device traffic; the train step normalizes on device — the right
    trade for multi-host input pipelines)."""
    assert images.dtype == np.uint8 and images.ndim == 4
    if out_uint8:
        indices = np.ascontiguousarray(indices, np.int64)
        return _augment_numpy_u8(np.ascontiguousarray(images), indices,
                                 crop_pad, int(flip), seed, epoch)
    H, W, C = images.shape[1:]
    mean = np.asarray(mean if mean is not None else np.zeros(C), np.float32)
    std = np.asarray(std if std is not None else np.ones(C), np.float32)
    indices = np.ascontiguousarray(indices, np.int64)
    images = np.ascontiguousarray(images)
    lib = _lib()
    if lib is None:
        return _augment_numpy(images, indices, crop_pad, int(flip), seed,
                              epoch, mean, std)
    n = len(indices)
    out = np.empty((n, H, W, C), np.float32)
    if nthreads <= 0:
        nthreads = min(os.cpu_count() or 1, 16)
    rc = lib.vitrs_augment_batch(
        images.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int(n), ctypes.c_int(H), ctypes.c_int(W), ctypes.c_int(C),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int(crop_pad), ctypes.c_int(int(flip)),
        ctypes.c_uint64(seed & _MASK), ctypes.c_uint64(epoch & _MASK),
        mean.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        std.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int(nthreads))
    if rc != 0:
        raise RuntimeError(f"vitrs_augment_batch failed rc={rc}")
    return out


def native_available() -> bool:
    return _lib() is not None
