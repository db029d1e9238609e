"""h5 reading for the classification and part-segmentation datasets.

Counterpart of ``adaptpoint_tpu/datasets/data_util.py`` ``load_h5_cached``
and ``load_h5_seg_cached`` (the scene-dataset helpers there wait for the
scene-segmentation slice). ``h5py`` is imported when a file is read, not
when the module is.
"""
from __future__ import annotations

import functools
import os
from typing import Tuple

import numpy as np

__all__ = ["load_h5_cached", "load_h5_seg_cached"]


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
