"""Ball group, forward and backward: the CUDA kernels and their plain versions.

Forward (``csrc/ballgroup.cu``) replaces
``adaptpoint_tpu/ops/pallas/ballgroup.py`` ``_ball_group_call``
(``_fwd_kernel``, the forward of ``ball_group_pallas``). Bound on the H100:
bytes -- the (B, K, M, 3+C) grouped output dominates. A block owns a tile of
centers of one cloud (the cloud staged in shared memory, a warp a center for
the ball query); then a warp a slot assembles the tile's rows of that slot,
one contiguous span of the output, in shared memory and streams it out in
16-byte stores.

Backward (``csrc/ballgroup_bwd.cu``) replaces ``_ball_group_bwd``
(``_bwd_kernel``), the VJP: the scatter-add of the cotangents of ``new_xyz``,
``fi`` and ``dpfj`` onto the support points, exact f32. Bound: bytes again
(``g_dpfj`` is read once), and the L2's reductions. A warp a center reads
its slots' rows once, sums runs of equal neighbour index in registers and
sends each run out as 16-byte vector reductions (one coalesced warp
reduction where C <= 32); its two outputs are zeroed by two memsets first.

:func:`fwd_tiling` picks the forward's launch shape on the host;
:func:`fwd_smem_bytes` and :func:`bwd_smem_bytes` are the host's copies of
the kernels' shared memory. :class:`BallGroup` ties the two
kernels into one differentiable op; ``idx`` is marked non-differentiable and
``query_idx`` gets no gradient.

Outputs keep the JAX package's layout: ``new_xyz (B,M,3)``, ``fi (B,M,C)``,
``dpfj (B,K,M,3+C)`` = ``[dp || fj]`` and ``idx (B,M,K)`` int32.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build
from .geometry import ball_query, index_points, inv_radius, radius_sq

__all__ = ["ball_group_cuda", "ball_group_plain", "ball_group_bwd_cuda",
           "ball_group_bwd_plain", "BallGroup", "FwdTiling", "fwd_tiling",
           "fwd_smem_bytes", "bwd_smem_bytes",
           "LAUNCHES", "LAUNCHES_BWD"]

LAUNCHES = 0      # kernel launches of ball_group_cuda
LAUNCHES_BWD = 0  # kernel launches of ball_group_bwd_cuda

_SMS = 132  # streaming multiprocessors of the H100 SXM
_SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90
# the most a block may use for two blocks to share an SM: (228 KB - 2 x 1 KB
# the hardware keeps per block) / 2
_SMEM_TWO_BLOCKS = 115712
_FWD_WARPS = 8  # warps of a forward block, each with its span buffer
_FWD_TILES = (32, 16, 8, 4)  # centers a forward block, most first
_CAP_MAX = 3072  # floats of a span buffer at most (12 KB)
# floats of a slot span a forward block aims at: longer spans (more centers
# a block) lengthen a block's ball query before its first store
_SPAN = 1100


def ball_group_plain(radius: float, nsample: int, xyz: torch.Tensor,
                     query_idx: torch.Tensor, feats: torch.Tensor,
                     relative: bool = True, normalize_dp: bool = False):
    """Center gather + ball query + ``[dp || fj]`` grouping, exact in f32.

    ``dp`` is ``(x_j - q) * f32(1/r)`` when ``normalize_dp``: the TPU kernel's
    multiply (the JAX package's XLA composite divides, which can differ by
    one ulp)."""
    new_xyz = index_points(xyz, query_idx)
    fi = index_points(feats, query_idx)
    idx = ball_query(radius, nsample, xyz, new_xyz)
    dp = index_points(xyz, idx)  # (B, M, K, 3)
    if relative:
        dp = dp - new_xyz[:, :, None, :]
        if normalize_dp:
            dp = dp * torch.tensor(inv_radius(radius), dtype=torch.float32,
                                   device=xyz.device)
    fj = index_points(feats, idx)
    dpfj = torch.cat([dp, fj], dim=-1).permute(0, 2, 1, 3).contiguous()
    return new_xyz, fi, dpfj, idx


def ball_group_bwd_plain(radius: float, idx: torch.Tensor,
                         query_idx: torch.Tensor, g_new, g_fi, g_dpfj,
                         n: int, relative: bool = True,
                         normalize_dp: bool = False):
    """VJP of :func:`ball_group_plain` written out as scatter-adds.

    ``idx (B,M,K)``, ``query_idx (B,M)``; cotangents ``g_new (B,M,3)``,
    ``g_fi (B,M,C)``, ``g_dpfj (B,K,M,3+C)``, of which ``g_new`` and ``g_fi``
    may be ``None`` (zero). Returns ``(g_xyz (B,n,3), g_feats (B,n,C))`` in
    f32. Every slot adds its own cotangent, pad-repeated ones included."""
    B, K, M, W = g_dpfj.shape
    C = W - 3
    dev = g_dpfj.device
    g_xyz = torch.zeros((B, n, 3), dtype=torch.float32, device=dev)
    g_feats = torch.zeros((B, n, C), dtype=torch.float32, device=dev)
    g_dp = g_dpfj[..., :3].float()
    if relative and normalize_dp:
        g_dp = g_dp * torch.tensor(inv_radius(radius), dtype=torch.float32,
                                   device=dev)
    # slot (k, m) of g_dpfj belongs to neighbour idx[b, m, k]
    rows = idx.long().permute(0, 2, 1).reshape(B, K * M)
    g_xyz.scatter_add_(1, rows[..., None].expand(-1, -1, 3),
                       g_dp.reshape(B, K * M, 3))
    g_feats.scatter_add_(1, rows[..., None].expand(-1, -1, C),
                         g_dpfj[..., 3:].float().reshape(B, K * M, C))
    q = query_idx.long()
    g_q = torch.zeros((B, M, 3), dtype=torch.float32, device=dev) \
        if g_new is None else g_new.float()
    if relative:
        g_q = g_q - g_dp.sum(dim=1)
    g_xyz.scatter_add_(1, q[..., None].expand(-1, -1, 3), g_q)
    if g_fi is not None:
        g_feats.scatter_add_(1, q[..., None].expand(-1, -1, C), g_fi.float())
    return g_xyz, g_feats


def _a128(x: int) -> int:
    return (x + 127) // 128 * 128


def fwd_smem_bytes(tm: int, K: int, N: int, use_xs: bool, cap: int) -> int:
    """Shared memory of one forward block, as ``ball_group_smem_bytes``
    computes it (csrc/ballgroup.cu ``fwd_layout``; ``chip_smoke.py`` holds
    the two equal): the tile's slot table, each center's coordinates, with
    ``use_xs`` the cloud's N points, 16 bytes each, and a span buffer of
    ``cap`` floats for each of the 8 warps."""
    return (_a128(tm * K * 4) + _a128(tm * 16)
            + (_a128(N * 16) if use_xs else 0) + _FWD_WARPS * _a128(cap * 4))


def bwd_smem_bytes(K: int) -> int:
    """Shared memory of one backward block, as ``ball_group_bwd_smem_bytes``
    computes it (csrc/ballgroup_bwd.cu ``bwd_smem``): each of its 8 warps'
    K neighbour indices, then each warp's buffer of 128 channels."""
    return (8 * K * 4 + 15) // 16 * 16 + 8 * 128 * 4


class FwdTiling(NamedTuple):
    """The forward's launch shape: ``tm`` centers a block, ``use_xs`` the
    cloud staged in shared memory, ``cap`` floats a warp's span buffer (a
    slot's ``tm (3 + C)`` floats and the alignment pad, or less: then the
    span goes through it in windows), ``vec`` channels a lane loads at once
    (4, or 1)."""
    tm: int
    use_xs: bool
    cap: int
    vec: int


@functools.lru_cache(maxsize=64)
def fwd_tiling(B: int, N: int, M: int, C: int, K: int,
               aligned: bool = True) -> FwdTiling:
    """The forward's tiling: the most centers a block (32 down to 4) whose
    slot span stays within _SPAN floats and that still give two blocks an SM
    of work, fewer where the slot table and the span buffers would not fit a
    block; the cloud staged where two blocks still fit an SM. Raises
    ValueError on a shape the kernel does not take."""
    if min(B, N, M, K) < 1 or C < 0:
        raise ValueError(f"the ball group takes B, N, M, K >= 1 and C >= 0; "
                         f"got B={B} N={N} M={M} C={C} K={K}")

    def cap(tm):
        return min((tm * (C + 3) + 3 + 3) // 4 * 4, _CAP_MAX)

    tm = next((t for t in _FWD_TILES if t * (C + 3) <= _SPAN
               and B * -(-M // t) >= 2 * _SMS), 4)
    while fwd_smem_bytes(tm, K, N, False, cap(tm)) > _SMEM_LIMIT:
        if tm == 1:
            raise ValueError(f"K={K} slots do not fit a block's shared "
                             f"memory")
        tm //= 2
    use_xs = fwd_smem_bytes(tm, K, N, True, cap(tm)) <= _SMEM_TWO_BLOCKS
    return FwdTiling(tm, use_xs, cap(tm),
                     4 if aligned and C % 4 == 0 and C > 0 else 1)


@functools.cache
def _lib():
    lib = _build.load("ballgroup")
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    lib.ball_group_launch.argtypes = [p, p, p, i, i, i, i, i, f, f, i,
                                      i, i, i, i, p, p, p, p, p]
    lib.ball_group_launch.restype = i
    lib.ball_group_smem_bytes.argtypes = [i, i, i, i, i]
    lib.ball_group_smem_bytes.restype = ll
    return lib


@functools.cache
def _lib_bwd():
    lib = _build.load("ballgroup_bwd")
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    lib.ball_group_bwd_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, f, i,
                                          p, p, p]
    lib.ball_group_bwd_launch.restype = i
    lib.ball_group_bwd_smem_bytes.argtypes = [i]
    lib.ball_group_bwd_smem_bytes.restype = ll
    return lib


def _check_inputs(xyz, query_idx, feats, feat_dtypes=(torch.float32,)):
    for name, t in (("xyz", xyz), ("query_idx", query_idx), ("feats", feats)):
        if t.device.type != "cuda":
            raise ValueError(f"the kernel needs CUDA tensors, {name} is on "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if xyz.dtype != torch.float32 or xyz.dim() != 3 or xyz.shape[2] != 3:
        raise ValueError(f"xyz must be (B, N, 3) float32, got "
                         f"{tuple(xyz.shape)} {xyz.dtype}")
    B, N, _ = xyz.shape
    if (feats.dtype not in feat_dtypes or feats.dim() != 3
            or feats.shape[:2] != (B, N)):
        raise ValueError(f"feats must be (B, N, C) of {feat_dtypes}, got "
                         f"{tuple(feats.shape)} {feats.dtype}")
    if (query_idx.dtype != torch.int32 or query_idx.dim() != 2
            or query_idx.shape[0] != B):
        raise ValueError(f"query_idx must be (B, M) int32, got "
                         f"{tuple(query_idx.shape)} {query_idx.dtype}")


def ball_group_cuda(radius: float, nsample: int, xyz: torch.Tensor,
                    query_idx: torch.Tensor, feats: torch.Tensor,
                    relative: bool = True, normalize_dp: bool = False):
    """The forward kernel on CUDA tensors; same outputs as
    :func:`ball_group_plain`, detached from their inputs (the differentiable
    op is :class:`BallGroup`). ``query_idx`` must lie in ``[0, N)``: checking it would cost a device
    sync on every launch, and the model only passes FPS indices."""
    global LAUNCHES
    _check_inputs(xyz, query_idx, feats)
    B, N, _ = xyz.shape
    M = query_idx.shape[1]
    C = feats.shape[2]
    K = int(nsample)
    if K < 1 or M < 1:
        raise ValueError(f"empty ball group: M={M} K={K}")
    _build.check_int32("ball_group", feats=B * N * C,
                       dpfj=B * K * M * (3 + C))
    tl = fwd_tiling(B, N, M, C, K, feats.data_ptr() % 16 == 0)
    dev = xyz.device
    new_xyz = torch.empty((B, M, 3), dtype=torch.float32, device=dev)
    fi = torch.empty((B, M, C), dtype=torch.float32, device=dev)
    dpfj = torch.empty((B, K, M, 3 + C), dtype=torch.float32, device=dev)
    idx = torch.empty((B, M, K), dtype=torch.int32, device=dev)
    scale = inv_radius(radius) if (relative and normalize_dp) else 1.0
    lib = _lib()
    err = lib.ball_group_launch(
        xyz.data_ptr(), query_idx.data_ptr(), feats.data_ptr(), B, N, M, C, K,
        radius_sq(radius), scale, int(bool(relative)), tl.tm, int(tl.use_xs),
        tl.cap, tl.vec, new_xyz.data_ptr(), fi.data_ptr(), dpfj.data_ptr(),
        idx.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "ball_group")
    LAUNCHES += 1
    return new_xyz, fi, dpfj, idx


def _cotangent(g, shape, name, dev):
    """A cotangent as a contiguous f32 CUDA tensor of ``shape``, or ``None``."""
    if g is None:
        return None
    if g.device != dev or tuple(g.shape) != shape:
        raise ValueError(f"{name} must be {shape} on {dev}, got "
                         f"{tuple(g.shape)} on {g.device}")
    return g.float().contiguous()


def ball_group_bwd_cuda(radius: float, idx: torch.Tensor,
                        query_idx: torch.Tensor, g_new, g_fi, g_dpfj, n: int,
                        relative: bool = True, normalize_dp: bool = False,
                        need_xyz: bool = True, need_feats: bool = True,
                        channels=None):
    """The backward kernel on CUDA tensors; same outputs as
    :func:`ball_group_bwd_plain`. Any cotangent may be ``None`` (zero) or a
    non-contiguous view; the channel count comes from ``channels``,
    ``g_dpfj`` or ``g_fi``. ``need_xyz`` / ``need_feats`` False returns
    ``None`` for that gradient."""
    global LAUNCHES_BWD
    for name, t in (("idx", idx), ("query_idx", query_idx)):
        if t.device.type != "cuda":
            raise ValueError(f"the kernel needs CUDA tensors, {name} is on "
                             f"{t.device}")
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32")
    if idx.dim() != 3 or query_idx.shape != idx.shape[:2]:
        raise ValueError(f"idx must be (B, M, K) and query_idx (B, M), got "
                         f"{tuple(idx.shape)} and {tuple(query_idx.shape)}")
    B, M, K = idx.shape
    if channels is not None:
        C = int(channels)
    elif g_dpfj is not None:
        C = g_dpfj.shape[-1] - 3
    elif g_fi is not None:
        C = g_fi.shape[-1]
    else:
        raise ValueError("channels, g_dpfj or g_fi must give the channel "
                         "count")
    _build.check_int32("ball_group_bwd", g_dpfj=B * K * M * (3 + C),
                       g_feats=B * int(n) * C)
    dev = idx.device
    g_new = _cotangent(g_new, (B, M, 3), "g_new", dev)
    g_fi = _cotangent(g_fi, (B, M, C), "g_fi", dev)
    g_dpfj = _cotangent(g_dpfj, (B, K, M, 3 + C), "g_dpfj", dev)
    if n < 1:
        raise ValueError(f"no support points: n={n}")
    g_xyz = torch.empty((B, n, 3), dtype=torch.float32, device=dev) \
        if need_xyz else None
    g_feats = torch.empty((B, n, C), dtype=torch.float32, device=dev) \
        if need_feats else None
    if not need_xyz and not (need_feats and C):  # nothing to sum
        return g_xyz, g_feats
    scale = inv_radius(radius) if (relative and normalize_dp) else 1.0

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _lib_bwd()
    err = lib.ball_group_bwd_launch(
        idx.data_ptr(), query_idx.data_ptr(), ptr(g_new), ptr(g_fi),
        ptr(g_dpfj), B, n, M, C, K, scale, int(bool(relative)), ptr(g_xyz),
        ptr(g_feats), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "ball_group_bwd")
    LAUNCHES_BWD += 1
    return g_xyz, g_feats


class BallGroup(torch.autograd.Function):
    """``ball_group_cuda`` with ``ball_group_bwd_cuda`` as its backward."""

    @staticmethod
    def forward(ctx, xyz, query_idx, feats, radius, nsample, relative,
                normalize_dp):
        new_xyz, fi, dpfj, idx = ball_group_cuda(
            radius, nsample, xyz, query_idx, feats, relative, normalize_dp)
        ctx.save_for_backward(idx, query_idx)
        ctx.args = (radius, xyz.shape[1], feats.shape[2], relative,
                    normalize_dp)
        if ctx.needs_input_grad[0]:
            ctx.mark_non_differentiable(idx)
        else:
            # new_xyz depends on xyz alone: without a gradient there it is a
            # constant, and whatever is computed from it stays off the graph
            ctx.mark_non_differentiable(idx, new_xyz)
        # an unused output's cotangent arrives as None, not as zeros
        ctx.set_materialize_grads(False)
        return new_xyz, fi, dpfj, idx

    @staticmethod
    def backward(ctx, g_new, g_fi, g_dpfj, _g_idx):
        idx, query_idx = ctx.saved_tensors
        radius, n, channels, relative, normalize_dp = ctx.args
        need_xyz, _, need_feats = ctx.needs_input_grad[:3]
        g_xyz, g_feats = ball_group_bwd_cuda(
            radius, idx, query_idx, g_new, g_fi, g_dpfj, n, relative,
            normalize_dp, need_xyz, need_feats, channels)
        return g_xyz, None, g_feats, None, None, None, None
