"""Voxel-grid barycenter subsampling on the host, for scene preprocessing.

Counterpart of ``adaptpoint_tpu/ops/cpu/grid_subsample.py`` (reference
openpoints/cpp/subsampling/grid_subsampling.cpp:1-106 and
openpoints/dataset/grid_sample.py:1-30). ``grid_subsampling.cpp`` beside
this file, the same code as the JAX package's, is compiled by ``g++`` at
first use into ``build/adaptpoint_tpu_torch/`` and loaded with ctypes
(``ops._build.load_host``); a failed build raises.
:func:`grid_subsample_plain` is the numpy version the tests hold it to.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .. import _build

__all__ = ["grid_subsample", "grid_subsample_plain"]

_SRC = Path(__file__).resolve().with_name("grid_subsampling.cpp")
_FP = ctypes.POINTER(ctypes.c_float)
_typed = set()


def _lib() -> ctypes.CDLL:
    lib = _build.load_host(_SRC)
    if id(lib) not in _typed:
        lib.grid_subsample.restype = ctypes.c_int64
        lib.grid_subsample.argtypes = [_FP, ctypes.c_int64, _FP,
                                       ctypes.c_int64, ctypes.c_float, _FP,
                                       _FP, ctypes.c_int64]
        _typed.add(id(lib))
    return lib


def grid_subsample_plain(points: np.ndarray, feats: Optional[np.ndarray],
                         sample_dl: float
                         ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """The voxels' barycenters in numpy, in the order the voxels first
    appear; sums in float64 as the library's."""
    vox = np.floor((points - points.min(axis=0)) / np.float32(sample_dl)
                   ).astype(np.int64)
    _, first_idx, inv = np.unique(vox, axis=0, return_index=True,
                                  return_inverse=True)
    order = np.argsort(first_idx)
    remap = np.empty_like(order)
    remap[order] = np.arange(len(order))
    inv = remap[inv.reshape(-1)]
    n_out = len(order)
    # the library's sum * (1 / count)
    inv_n = 1.0 / np.bincount(inv, minlength=n_out).astype(np.float64)
    out_p = np.stack([np.bincount(inv, weights=points[:, d], minlength=n_out)
                      for d in range(3)], axis=1) * inv_n[:, None]
    out_f = None
    if feats is not None:
        out_f = (np.stack([np.bincount(inv, weights=feats[:, d],
                                       minlength=n_out)
                           for d in range(feats.shape[1])], axis=1)
                 * inv_n[:, None]).astype(np.float32)
    return out_p.astype(np.float32), out_f


def grid_subsample(points: np.ndarray, feats: Optional[np.ndarray] = None,
                   sample_dl: float = 0.04
                   ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """points (N, 3) f32, optional feats (N, F) f32 -> the barycenters of
    the ``sample_dl`` voxels (M, 3) and their mean features (M, F) or
    None."""
    points = np.ascontiguousarray(points, np.float32)
    f = 0 if feats is None else feats.shape[1]
    if feats is not None:
        feats = np.ascontiguousarray(feats, np.float32)
    lib = _lib()
    n = points.shape[0]
    fptr = feats.ctypes.data_as(_FP) if feats is not None else None
    count = lib.grid_subsample(points.ctypes.data_as(_FP), n, fptr, f,
                               ctypes.c_float(sample_dl), None, None, 0)
    out_p = np.empty((count, 3), np.float32)
    out_f = np.empty((count, f), np.float32) if f else None
    lib.grid_subsample(points.ctypes.data_as(_FP), n, fptr, f,
                       ctypes.c_float(sample_dl), out_p.ctypes.data_as(_FP),
                       out_f.ctypes.data_as(_FP) if f else None, count)
    return out_p, out_f
