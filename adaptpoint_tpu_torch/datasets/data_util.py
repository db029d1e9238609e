"""Host-side data helpers: h5 reading for the classification and
part-segmentation datasets, and the scene datasets' voxel crops.

Counterpart of ``adaptpoint_tpu/datasets/data_util.py`` (reference
openpoints/dataset/data_util.py:100-195): ``load_h5_cached`` and
``load_h5_seg_cached``; ``voxelize`` (FNV-hashed voxel keys, one random
point a voxel in training), ``crop_pc`` (voxel downsampling, then a crop of
``voxel_max`` points nearest a random (train) or the middle (val) point, or
padding by random repeats, then a shuffle) and ``get_class_weights``. Each
draws from the ``np.random.Generator`` it is given in the JAX package's
order, so the two packages crop the same points. ``h5py`` is imported when a
file is read, not when the module is.
"""
from __future__ import annotations

import functools
import os
from typing import Optional, Tuple

import numpy as np

__all__ = ["load_h5_cached", "load_h5_seg_cached", "voxelize", "crop_pc",
           "get_class_weights"]


def _fnv_hash_vec(arr: np.ndarray) -> np.ndarray:
    """64-bit FNV-1 hash of each row of non-negative integer coordinates."""
    arr = arr.copy().astype(np.uint64)
    h = np.full(arr.shape[0], 14695981039346656037, dtype=np.uint64)
    for j in range(arr.shape[1]):
        h *= np.uint64(1099511628211)
        h = np.bitwise_xor(h, arr[:, j])
    return h


def voxelize(coord: np.ndarray, voxel_size: float = 0.05, mode: int = 0,
             rng: Optional[np.random.Generator] = None):
    """``mode`` 0 (train): the indices of one random point a voxel; 1
    (val): ``(idx_sort, voxel_idx, count)``, the points sorted by voxel
    key, each point's voxel and each voxel's size."""
    rng = rng or np.random.default_rng()
    discrete = np.floor(coord / voxel_size).astype(np.int64)
    discrete -= discrete.min(0)
    key = _fnv_hash_vec(discrete)
    idx_sort = np.argsort(key)
    key_sort = key[idx_sort]
    _, voxel_idx, count = np.unique(key_sort, return_inverse=True,
                                    return_counts=True)
    if mode == 0:
        starts = np.cumsum(np.insert(count, 0, 0)[:-1])
        idx_select = starts + rng.integers(0, count.max(), count.size) % count
        return idx_sort[idx_select]
    return idx_sort, voxel_idx, count


def crop_pc(coord, feat, label, split: str = "train",
            voxel_size: float = 0.04, voxel_max: Optional[int] = None,
            downsample: bool = True, variable: bool = False,
            shuffle: bool = True, rng: Optional[np.random.Generator] = None):
    """Voxel-downsample, then crop to (or pad up to) ``voxel_max`` points
    around a random (train) or the middle (val) point, shuffle, and move the
    cloud's minimum to the origin. Returns ``(coord f32, feat f32, label
    int64)``; ``feat`` / ``label`` may be None."""
    rng = rng or np.random.default_rng()
    if voxel_size and downsample:
        coord = coord - coord.min(0)
        uniq = voxelize(coord, voxel_size, mode=0, rng=rng)
        coord = coord[uniq]
        feat = feat[uniq] if feat is not None else None
        label = label[uniq] if label is not None else None
    if voxel_max is not None:
        n = len(coord)
        if n >= voxel_max:
            init = rng.integers(n) if "train" in split else n // 2
            crop_idx = np.argsort(
                ((coord - coord[init]) ** 2).sum(1))[:voxel_max]
        elif not variable:
            pad = rng.choice(n, voxel_max - n)
            crop_idx = np.hstack([np.arange(n), pad])
        else:
            crop_idx = np.arange(n)
        if shuffle:
            crop_idx = crop_idx[rng.permutation(len(crop_idx))]
        coord = coord[crop_idx]
        feat = feat[crop_idx] if feat is not None else None
        label = label[crop_idx] if label is not None else None
    coord = coord - coord.min(0)
    return (coord.astype(np.float32),
            feat.astype(np.float32) if feat is not None else None,
            label.astype(np.int64) if label is not None else None)


def get_class_weights(num_per_class, normalize: bool = False) -> np.ndarray:
    """``1 / (share + 0.02)`` of each class's share of the points; with
    ``normalize`` scaled to sum to the number of classes."""
    weight = np.asarray(num_per_class, np.float64) / float(sum(num_per_class))
    w = 1.0 / (weight + 0.02)
    if normalize:
        w = w * len(w) / w.sum()
    return w.astype(np.float32)


def load_h5_cached(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """``(data f32, label int64)`` of a ``{data, label}`` h5 file, read once
    per (path, mtime, size); the arrays are read-only."""
    st = os.stat(path)
    return _load(path, st.st_mtime_ns, st.st_size)


@functools.lru_cache(maxsize=64)
def _load(path, _mtime_ns, _size):
    import h5py
    with h5py.File(path, "r") as f:
        points = np.asarray(f["data"], np.float32)
        labels = np.asarray(f["label"]).astype(np.int64).reshape(-1)
    points.setflags(write=False)
    labels.setflags(write=False)
    return points, labels


def load_h5_seg_cached(path: str
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(data f32, label int64, pid int64)`` of a ``{data, label, pid}``
    part-segmentation h5 file, read once per (path, mtime, size); the
    arrays are read-only."""
    st = os.stat(path)
    return _load_seg(path, st.st_mtime_ns, st.st_size)


@functools.lru_cache(maxsize=64)
def _load_seg(path, _mtime_ns, _size):
    import h5py
    with h5py.File(path, "r") as f:
        out = (np.asarray(f["data"], np.float32),
               np.asarray(f["label"]).astype(np.int64).reshape(-1),
               np.asarray(f["pid"]).astype(np.int64))
    for a in out:
        a.setflags(write=False)
    return out
