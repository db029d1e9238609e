"""The host kd-tree: kNN and sorted radius queries on the CPU, for the S3DIS
sphere protocol's schedule, spheres and projections.

Counterpart of ``adaptpoint_tpu/ops/cpu/kdtree_knn.py`` (reference: the
vendored nearest_neighbors package, openpoints/dataset/semantic_kitti/utils/
nearest_neighbors, and the sklearn ``KDTree`` of
openpoints/dataset/s3dis/s3dis_sphere.py:167). ``kdtree_knn.cpp`` beside
this file, the same code as the JAX package's, is compiled by ``g++`` at first
use into ``build/adaptpoint_tpu_torch/`` and loaded with ctypes
(``ops._build.load_host``). A failed build raises: the numpy functions
below break ties in another order than the tree, so they would change the
sphere schedule; they are the plain versions the tests hold the tree to.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .. import _build

__all__ = ["KDTree", "kdtree_knn", "knn_search", "knn_plain",
           "query_radius_plain"]

_SRC = Path(__file__).resolve().with_name("kdtree_knn.cpp")
_FP = ctypes.POINTER(ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int32)
_typed = set()


def _lib() -> ctypes.CDLL:
    lib = _build.load_host(_SRC)
    if id(lib) not in _typed:
        lib.kdtree_knn.restype = None
        lib.kdtree_knn.argtypes = [_FP, ctypes.c_int64, _FP, ctypes.c_int64,
                                   ctypes.c_int32, _IP, _FP]
        lib.kdtree_build.restype = ctypes.c_void_p
        lib.kdtree_build.argtypes = [_FP, ctypes.c_int64]
        lib.kdtree_free.restype = None
        lib.kdtree_free.argtypes = [ctypes.c_void_p]
        lib.kdtree_query.restype = None
        lib.kdtree_query.argtypes = [ctypes.c_void_p, _FP, ctypes.c_int64,
                                     ctypes.c_int32, _IP, _FP]
        lib.kdtree_radius.restype = ctypes.c_int64
        lib.kdtree_radius.argtypes = [ctypes.c_void_p, _FP, ctypes.c_float,
                                      ctypes.c_int64, _IP, _FP]
        _typed.add(id(lib))
    return lib


def knn_plain(support: np.ndarray, queries: np.ndarray, k: int
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Brute-force kNN: (idx (M, k) int32, d2 (M, k) f32), ascending; ties
    in ``argsort``'s order, which need not be the tree's."""
    d2 = ((queries[:, None, :] - support[None, :, :]) ** 2).sum(-1)
    idx = np.argsort(d2, axis=1)[:, :k].astype(np.int32)
    return idx, np.take_along_axis(d2, idx, 1).astype(np.float32)


def query_radius_plain(points: np.ndarray, query: np.ndarray, r: float,
                       max_out: Optional[int] = None) -> np.ndarray:
    """Brute-force radius query: the indices within ``r`` of ``query``
    sorted by (distance, index), at most ``max_out``."""
    d2 = ((points - query[None, :]) ** 2).sum(-1)
    idx = np.where(d2 <= np.float32(r) * np.float32(r))[0]
    order = np.argsort(d2[idx], kind="stable")
    return idx[order][:max_out].astype(np.int32)


def kdtree_knn(support: np.ndarray, queries: np.ndarray, k: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """support (N, 3), queries (M, 3) -> (idx (M, k) int32, d2 (M, k) f32),
    sorted ascending; a query with fewer than ``k`` points repeats its
    farthest."""
    support = np.ascontiguousarray(support, np.float32)
    queries = np.ascontiguousarray(queries, np.float32)
    m = queries.shape[0]
    out_idx = np.empty((m, k), np.int32)
    out_d2 = np.empty((m, k), np.float32)
    _lib().kdtree_knn(support.ctypes.data_as(_FP), support.shape[0],
                      queries.ctypes.data_as(_FP), m, k,
                      out_idx.ctypes.data_as(_IP), out_d2.ctypes.data_as(_FP))
    return out_idx, out_d2


def knn_search(support_pts: np.ndarray, query_pts: np.ndarray, k: int
               ) -> np.ndarray:
    """Batched host kNN (reference helper_tool.py:134-143 ``knn_batch``):
    support (B, N, 3), queries (B, M, 3) -> idx (B, M, k) int32; 2D inputs
    give (M, k)."""
    support_pts = np.asarray(support_pts, np.float32)
    query_pts = np.asarray(query_pts, np.float32)
    if support_pts.ndim == 2:
        return kdtree_knn(support_pts, query_pts, k)[0]
    return np.stack([kdtree_knn(s, q, k)[0]
                     for s, q in zip(support_pts, query_pts)])


class KDTree:
    """A kd-tree over (N, 3) points kept for many queries: ``query`` (kNN)
    and ``query_radius`` (sorted by distance, at most ``max_out``). Pickles
    as its points and rebuilds on load (O(N log N))."""

    def __init__(self, points: np.ndarray):
        self.points = np.ascontiguousarray(points, np.float32)
        self._lib = _lib()
        self._handle = self._lib.kdtree_build(
            self.points.ctypes.data_as(_FP), self.points.shape[0])

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.kdtree_free(self._handle)
            self._handle = None

    def __getstate__(self):
        return {"points": self.points}

    def __setstate__(self, state):
        self.__init__(state["points"])

    def query(self, queries: np.ndarray, k: int = 1):
        """(M, 3) -> (idx (M, k) int32, d2 (M, k) f32), ascending."""
        queries = np.ascontiguousarray(np.atleast_2d(queries), np.float32)
        m = queries.shape[0]
        out_idx = np.empty((m, k), np.int32)
        out_d2 = np.empty((m, k), np.float32)
        self._lib.kdtree_query(self._handle, queries.ctypes.data_as(_FP), m,
                               k, out_idx.ctypes.data_as(_IP),
                               out_d2.ctypes.data_as(_FP))
        return out_idx, out_d2

    def query_radius(self, query: np.ndarray, r: float,
                     max_out: Optional[int] = None) -> np.ndarray:
        """The indices within ``r`` of one (3,) query, sorted by (distance,
        index), at most ``max_out`` (default: all)."""
        query = np.ascontiguousarray(query, np.float32).reshape(-1)[:3]
        if max_out is None:
            max_out = self.points.shape[0]
        out_idx = np.empty(max_out, np.int32)
        out_d2 = np.empty(max_out, np.float32)
        n = self._lib.kdtree_radius(self._handle, query.ctypes.data_as(_FP),
                                    r, max_out, out_idx.ctypes.data_as(_IP),
                                    out_d2.ctypes.data_as(_FP))
        return out_idx[:n]
