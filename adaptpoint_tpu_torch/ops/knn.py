"""Exact k nearest neighbours: ``csrc/knn.cu`` and its plain version.

Replaces ``adaptpoint_tpu/ops/pallas/knn.py`` ``knn_pallas``
(``_knn_kernel``): for each query the ``min(k, N)`` nearest support points,
nearest first, ties to the lowest index; when ``k > N`` the remaining slots
repeat the nearest. A NaN or +inf distance is never selected: a slot left
without a candidate repeats the nearest too (index 0 if the query has
none). Both versions return indices only; ``ops.knn_point`` recomputes the
distances differentiably from the gathered rows, as the JAX package does
around its kernel. Bound on the H100: operations (M x N distances).
:func:`knn_variant` picks the instance by (k, N, C): a thread or a warp a
query over the support staged whole in shared memory, with a sorted list of
the nearest in registers, and past :func:`knn_max_points` the tiled
instance, built like a matrix product (64 queries a block, a 4 x 4
micro-tile a thread, the support streamed through a ring of 64-channel
stages; :func:`knn_tiled_plan`), whose warps merge each tile's distances
into a list of the 32 nearest a query. See the source's note.

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
           "KnnVariant", "KnnTiledPlan", "knn_tiled_plan",
           "TILED_MAX_CHANNELS"]

LAUNCHES = 0  # launches of the staged instances (thread and warp)
LAUNCHES_TILED = 0  # launches of the tiled instance
MAX_K = 32
_MAX_SMEM = 227 * 1024  # csrc/knn.cu kMaxSmem
_THREAD_MAX_K = 8  # the thread-a-query variant's longest list


def knn_max_points(c: int) -> int:
    """Largest support the kernel takes at ``c`` channels: N * (c + 1)
    floats of shared memory (csrc/knn.cu ``knn_max_points``)."""
    return _MAX_SMEM // ((c + 1) * 4)


class KnnTiledPlan(NamedTuple):
    """The tiled instance's plan (csrc/knn.cu ``knn_tiled_plan``): queries
    a block, points a tile, channels a stage of the ring, stages, and the
    block's shared memory in bytes (the ring's stages of padded rows, the
    distance tile, the norms)."""
    queries: int
    points: int
    chunk: int
    stages: int
    smem_bytes: int


def knn_tiled_plan() -> KnnTiledPlan:
    """The plan, the same at every C: the ring takes C 64 channels at a
    time, so its shared memory does not grow with C."""
    tq, tp, ck, stages = 64, 64, 64, 2
    ring = stages * (tq + tp) * (ck + 4)  # rows padded by 4 floats
    dist = tq * (tp + 8)  # the distance tile, rows padded by 8 floats
    return KnnTiledPlan(tq, tp, ck, stages, (ring + dist + tq + tp) * 4)


# widest C the kernels take: the launchers' C is a 32-bit int, and the ring
# takes the channels 64 at a time, so the tiled instance has no other
# ceiling (a call's element counts are held to int32 by _build.check_int32)
TILED_MAX_CHANNELS = 2 ** 31 - 1


class KnnVariant(NamedTuple):
    """``thread`` (a thread a query), ``warp`` (a warp a query, the support
    staged whole) or ``tiled`` (64 queries a block, the support streamed in
    tiles), and the length of the sorted list each thread of a staged
    instance keeps; the tiled instance keeps one list of MAX_K a query, an
    entry a lane of a warp, whatever k and N."""
    kind: str
    list_len: int


def knn_variant(k: int, n: int, c: int) -> KnnVariant:
    """The kernel's variant for ``k`` neighbours among ``n`` support points
    of ``c`` channels: a thread a query with a list of k (1-4) or 8 at C = 3
    and k <= 8; else a warp a query, each lane's list min(k, ceil(n / 32))
    rounded up to a power of two, on the staged support up to
    ``knn_max_points(c)``; past it the tiled instance (its list of MAX_K).
    Raises ValueError
    outside 1 <= k <= MAX_K, 1 <= c <= TILED_MAX_CHANNELS and n >= 1."""
    if not 1 <= k <= MAX_K or not 1 <= c <= TILED_MAX_CHANNELS or n < 1:
        raise ValueError(f"the kNN kernel takes 1 <= k <= {MAX_K}, "
                         f"1 <= C <= {TILED_MAX_CHANNELS} and N >= 1, got "
                         f"k={k} N={n} C={c}")
    if n > knn_max_points(c):
        return KnnVariant("tiled", MAX_K)
    if c == 3 and k <= _THREAD_MAX_K:
        return KnnVariant("thread", k if k <= 4 else 8)
    need = min(k, -(-n // 32))
    return KnnVariant("warp", 1 << (need - 1).bit_length())


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
    of min / first argmin / mask, as the JAX package extracts them. A NaN or
    +inf distance is never selected: a pass that finds no finite distance
    left, like a slot past N, repeats the nearest (index 0 if the query has
    none), as the kernels do."""
    N = xyz.shape[1]
    k_eff = min(k, N)
    cur = expanded_sq_dist(query, xyz)
    cur = torch.where(torch.isnan(cur), torch.inf, cur)
    lane = torch.arange(N, device=xyz.device)
    idxs = []
    for _ in range(k_eff):
        d = cur.amin(dim=-1, keepdim=True)
        # the first index of the minimum (torch.min's choice on ties is not
        # specified)
        i = torch.argmax((cur == d).int(), dim=-1)
        idxs.append(torch.where(d[..., 0] < torch.inf, i, -1))
        cur = torch.where(lane == i[..., None], torch.inf, cur)
    idx = torch.stack(idxs, dim=-1)
    first = idx[..., :1].clamp(min=0)
    idx = torch.where(idx < 0, first, idx).to(torch.int32)
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
    lib.knn_tiled_launch.argtypes = [p, p, i, i, i, i, i, p, p]
    lib.knn_tiled_launch.restype = ctypes.c_int
    lib.knn_tiled_plan.argtypes = [p]
    lib.knn_tiled_plan.restype = None
    return lib


def lib_tiled_plan() -> KnnTiledPlan:
    """The library's own plan (csrc/knn.cu ``knn_tiled_plan``), to hold
    against the host's copy; builds the library."""
    out = (ctypes.c_int * 5)()
    _lib().knn_tiled_plan(ctypes.addressof(out))
    return KnnTiledPlan(*out)


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
                                   C, k, idx.data_ptr(), stream)
        _build.check(lib, err, "knn (tiled)")
        LAUNCHES_TILED += 1
        return idx
    err = lib.knn_launch(xyz.data_ptr(), query.data_ptr(), B, N, M, C, k,
                         int(var.kind == "warp"), var.list_len,
                         idx.data_ptr(), stream)
    _build.check(lib, err, "knn")
    LAUNCHES += 1
    return idx
