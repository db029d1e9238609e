"""Exact k nearest neighbours: ``csrc/knn.cu`` and its plain version.

Replaces ``adaptpoint_tpu/ops/pallas/knn.py`` ``knn_pallas``
(``_knn_kernel``): for each query the ``min(k, N)`` nearest support points,
nearest first, ties to the lowest index; when ``k > N`` the remaining slots
repeat the nearest. Both versions return indices only; ``ops.knn_point``
recomputes the distances differentiably from the gathered rows, as the JAX
package does around its kernel. Bound on the H100: operations (M x N
distances, one pass over the support a query with a sorted list of the
nearest in registers); :func:`knn_variant` picks a thread or a warp a query
by (k, N, C), and past :func:`knn_max_points` (the support staged whole in
shared memory) the tiled instance, which streams the support through shared
memory in tiles of :func:`knn_tile_points` points. See the source's note.

The distance is the expanded form ``(|q|^2 + |x|^2) - 2 q.x`` of
``geometry.square_distance``, here written out with one elementwise op per
product and sum, in channel order. Each then rounds on its own in float32 on
either device, which is the arithmetic the kernel spells with
``__fmul_rn``/``__fadd_rn``: the two agree bit for bit, near-ties included.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build

__all__ = ["knn_idx_cuda", "knn_idx_plain", "expanded_sq_dist", "LAUNCHES",
           "LAUNCHES_TILED", "MAX_K", "knn_max_points", "knn_variant",
           "KnnVariant", "knn_tile_points", "TILED_MAX_CHANNELS",
           "tiled_smem_bytes"]

LAUNCHES = 0  # launches of the staged instances (thread and warp)
LAUNCHES_TILED = 0  # launches of the tiled instance
MAX_K = 32
_MAX_SMEM = 227 * 1024  # csrc/knn.cu kMaxSmem
_TWO_BLOCKS_SMEM = 115712  # csrc/knn.cu kTwoBlocksSmem
_WARPS = 8  # queries a warp-a-query block
_THREAD_MAX_K = 8  # the thread-a-query variant's longest list


def knn_max_points(c: int) -> int:
    """Largest support the kernel takes at ``c`` channels: N * (c + 1)
    floats of shared memory (csrc/knn.cu ``knn_max_points``)."""
    return _MAX_SMEM // ((c + 1) * 4)


def tiled_smem_bytes(t: int, c: int) -> int:
    """Shared memory of a tiled block: C + 1 planes of T + 1 floats and the
    block's 8 queries (csrc/knn.cu ``tiled_smem``)."""
    return ((c + 1) * (t + 1) + _WARPS * c) * 4


def knn_tile_points(c: int) -> int:
    """Points a tile of the tiled instance at ``c`` channels (csrc/knn.cu
    ``knn_tile_points``): the largest of 256, 128, 64, 32 that leaves room
    for two blocks an SM, else 32 where one block fits; 0 past
    TILED_MAX_CHANNELS."""
    if c < 1:
        return 0
    for t in (256, 128, 64, 32):
        if tiled_smem_bytes(t, c) <= _TWO_BLOCKS_SMEM:
            return t
    return 32 if tiled_smem_bytes(32, c) <= _MAX_SMEM else 0


# widest C the tiled instance takes (csrc/knn.cu knn_tiled_max_channels)
TILED_MAX_CHANNELS = (_MAX_SMEM - 33 * 4) // (33 * 4 + _WARPS * 4)


class KnnVariant(NamedTuple):
    """``thread`` (a thread a query), ``warp`` (a warp a query, the support
    staged whole) or ``tiled`` (a warp a query, the support in tiles), and
    the length of the sorted list each thread keeps."""
    kind: str
    list_len: int


def knn_variant(k: int, n: int, c: int) -> KnnVariant:
    """The kernel's variant for ``k`` neighbours among ``n`` support points
    of ``c`` channels: a thread a query with a list of k (1-4) or 8 at C = 3
    and k <= 8; else a warp a query, each lane's list min(k, ceil(n / 32))
    rounded up to a power of two, on the staged support up to
    ``knn_max_points(c)`` and on the tiled one past it. Raises ValueError
    outside 1 <= k <= MAX_K, 1 <= c <= TILED_MAX_CHANNELS and n >= 1."""
    if not 1 <= k <= MAX_K or not 1 <= c <= TILED_MAX_CHANNELS or n < 1:
        raise ValueError(f"the kNN kernel takes 1 <= k <= {MAX_K}, "
                         f"1 <= C <= {TILED_MAX_CHANNELS} and N >= 1, got "
                         f"k={k} N={n} C={c}")
    need = min(k, -(-n // 32))
    list_len = 1 << (need - 1).bit_length()
    if n > knn_max_points(c):
        return KnnVariant("tiled", list_len)
    if c == 3 and k <= _THREAD_MAX_K:
        return KnnVariant("thread", k if k <= 4 else 8)
    return KnnVariant("warp", list_len)


def _sum_sq(x: torch.Tensor) -> torch.Tensor:
    acc = x[..., 0] * x[..., 0]
    for c in range(1, x.shape[-1]):
        acc = acc + x[..., c] * x[..., c]
    return acc


def expanded_sq_dist(query: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """query (B, M, C), xyz (B, N, C) -> (B, M, N) f32, every product and sum
    a separate op so that nothing is fused or reordered."""
    q, x = query.float(), xyz.float()
    cross = q[:, :, None, 0] * x[:, None, :, 0]
    for c in range(1, q.shape[-1]):
        cross = cross + q[:, :, None, c] * x[:, None, :, c]
    return (_sum_sq(q)[:, :, None] + _sum_sq(x)[:, None, :]) - 2.0 * cross


def knn_idx_plain(k: int, xyz: torch.Tensor,
                  query: torch.Tensor) -> torch.Tensor:
    """xyz (B, N, C) support, query (B, M, C) -> idx (B, M, k) int32: k passes
    of min / first argmin / mask, as the JAX package extracts them."""
    N = xyz.shape[1]
    k_eff = min(k, N)
    cur = expanded_sq_dist(query, xyz)
    lane = torch.arange(N, device=xyz.device)
    idxs = []
    for _ in range(k_eff):
        d = cur.amin(dim=-1, keepdim=True)
        # the first index of the minimum (torch.min's choice on ties is not
        # specified)
        i = torch.argmax((cur == d).int(), dim=-1)
        idxs.append(i)
        cur = torch.where(lane == i[..., None], torch.inf, cur)
    idx = torch.stack(idxs, dim=-1).to(torch.int32)
    if k_eff < k:
        idx = torch.cat([idx, idx[..., :1].expand(-1, -1, k - k_eff)], dim=-1)
    return idx


@functools.cache
def _lib():
    lib = _build.load("knn")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.knn_launch.argtypes = [p, p, i, i, i, i, i, i, i, p, p]
    lib.knn_launch.restype = ctypes.c_int
    lib.knn_max_points.argtypes = [i]
    lib.knn_max_points.restype = ctypes.c_int
    lib.knn_tiled_launch.argtypes = [p, p, i, i, i, i, i, i, i, p, p]
    lib.knn_tiled_launch.restype = ctypes.c_int
    lib.knn_tile_points.argtypes = [i]
    lib.knn_tile_points.restype = ctypes.c_int
    lib.knn_tiled_max_channels.argtypes = []
    lib.knn_tiled_max_channels.restype = ctypes.c_int
    return lib


def knn_idx_cuda(k: int, xyz: torch.Tensor,
                 query: torch.Tensor) -> torch.Tensor:
    """The kernel on contiguous f32 CUDA tensors: xyz (B, N, C), query
    (B, M, C) -> idx (B, M, k) int32, ``1 <= k <= 32``; the tiled instance
    where N > knn_max_points(C)."""
    global LAUNCHES, LAUNCHES_TILED
    for name, t in (("xyz", xyz), ("query", query)):
        if t.device.type != "cuda":
            raise ValueError(f"the kNN kernel needs CUDA tensors, {name} is "
                             f"on {t.device}")
        if t.dtype != torch.float32 or t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (B, *, C) float32, "
                             f"got {tuple(t.shape)} {t.dtype}")
    B, N, C = xyz.shape
    M = query.shape[1]
    if query.shape[0] != B or query.shape[2] != C:
        raise ValueError(f"query {tuple(query.shape)} does not match xyz "
                         f"{tuple(xyz.shape)}")
    if min(B, M) < 1:
        raise ValueError(f"the kNN kernel takes non-empty clouds, got B={B} "
                         f"M={M}")
    _build.check_int32("knn", xyz=B * N * C, query=B * M * C, idx=B * M * k)
    var = knn_variant(k, N, C)
    lib = _lib()
    idx = torch.empty((B, M, k), dtype=torch.int32, device=xyz.device)
    stream = torch.cuda.current_stream(xyz.device).cuda_stream
    if var.kind == "tiled":
        err = lib.knn_tiled_launch(xyz.data_ptr(), query.data_ptr(), B, N, M,
                                   C, k, knn_tile_points(C), var.list_len,
                                   idx.data_ptr(), stream)
        _build.check(lib, err, "knn (tiled)")
        LAUNCHES_TILED += 1
        return idx
    err = lib.knn_launch(xyz.data_ptr(), query.data_ptr(), B, N, M, C, k,
                         int(var.kind == "warp"), var.list_len,
                         idx.data_ptr(), stream)
    _build.check(lib, err, "knn")
    LAUNCHES += 1
    return idx
