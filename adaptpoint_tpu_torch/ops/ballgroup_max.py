"""Max-pooled ball group, forward and backward: the CUDA kernels and their plain versions.

Forward (``csrc/ballgroup_max.cu``) replaces
``adaptpoint_tpu/ops/pallas/ballgroup.py`` ``_bg_max_call``
(``_fwd_max_kernel``), backward ``_bg_max_bwd`` (``_bwd_max_kernel``): the
two halves of ``ball_group_maxpool_pallas`` as the augmentor's
``PointsetGrouper`` calls it (``splits=1, grad_splits=1``). Bound on the
H100: bytes (the features are read once, only (B, M, C) outputs are
written: the (B, K, M, C) grouped tensor never exists). The forward gives a
block a tile of centers of one cloud (the cloud staged in shared memory, a
warp a center for the ball query, 16 bytes of channels a thread for the
max); the backward a cloud, a slice of channels and its rows, summed in
shared memory and written once. :func:`fwd_tiling` and :func:`bwd_tiling`
pick the launch shapes on the host; see the source's note.

The TPU kernel's rounding is part of the function, and both versions here
reproduce it:

- ``new_xyz`` exact; ``fi = bf16(f[q])``; ``fmax``/``fmin`` the max and min
  over the K slots of ``bf16(f[idx])``; ``amax``/``amin`` the first slot that
  holds each (``torch.argmax``'s first-index rule);
- the backward sends ``bf16(g_fmax * [amax == k] + g_fmin * [amin == k])`` to
  slot k's neighbour (one rounding of the sum), and ``g_fi`` and ``g_new``
  unrounded to the center's row; ``xyz`` gets only ``g_new``.

Features may be f32 or bf16 (the bf16 policy's). bf16 features give ``fi``,
``fmax``, ``fmin`` and the feature gradient in bf16, the feature gradient
summed in f32 and rounded once: the values the JAX package gives under its
bf16 policy by casting the features up and the results down
(``adaptpoint_tpu/ops/__init__.py`` ``ball_group_max``), with no cast here.

:class:`BallGroupMax` ties the two into one differentiable op whatever the
device: the kernels for CUDA tensors, the plain versions otherwise.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build
from .ballgroup import (_SMEM_LIMIT, _SMEM_TWO_BLOCKS, _SMS, _a128,
                        _check_inputs)
from .geometry import ball_query, index_points, radius_sq
from .saeval import _bf16

__all__ = ["ball_group_max_cuda", "ball_group_max_plain",
           "ball_group_max_bwd_cuda", "ball_group_max_bwd_plain",
           "BallGroupMax", "FwdTiling", "BwdTiling", "fwd_tiling",
           "bwd_tiling", "fwd_smem_bytes", "bwd_smem_bytes", "LAUNCHES",
           "LAUNCHES_BWD"]

LAUNCHES = 0      # kernel launches of ball_group_max_cuda
LAUNCHES_BWD = 0  # kernel launches of ball_group_max_bwd_cuda

# the feature types the kernels take, by the code the C entry points read
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# channels a backward block may sum, widest first
_BWD_SLICES = (32, 16, 8, 4)


def ball_group_max_plain(radius: float, nsample: int, xyz, query_idx, feats):
    """xyz (B,N,3), query_idx (B,M), feats (B,N,C) of one float type ->
    ``(new_xyz (B,M,3), fi, fmax, fmin (B,M,C) of the features' type, amax,
    amin (B,M,C) uint8, idx (B,M,K) int32)``."""
    new_xyz = index_points(xyz, query_idx)
    idx = ball_query(radius, nsample, xyz, new_xyz)
    fb = _bf16(feats)
    fj = index_points(fb, idx)  # (B, M, K, C)
    amax = torch.argmax(fj, dim=2)
    amin = torch.argmin(fj, dim=2)
    fmax = torch.gather(fj, 2, amax[:, :, None]).squeeze(2)
    fmin = torch.gather(fj, 2, amin[:, :, None]).squeeze(2)
    return (new_xyz, index_points(fb, query_idx), fmax, fmin,
            amax.to(torch.uint8), amin.to(torch.uint8), idx)


def ball_group_max_bwd_plain(idx, query_idx, amax, amin, g_new, g_fi, g_fmax,
                             g_fmin, n: int):
    """VJP of :func:`ball_group_max_plain` as scatter-adds. Any cotangent may
    be ``None`` (zero). ``g_feats (B,n,C)`` takes the feature cotangents'
    type and is summed in f32 (float64 stays float64) and rounded once;
    ``g_xyz (B,n,3)`` takes ``g_new``'s type."""
    B, M, K = idx.shape
    C = amax.shape[-1]
    ref = next(g for g in (g_fmax, g_fmin, g_fi, g_new) if g is not None)
    dt, dev = ref.dtype, ref.device
    acc = torch.promote_types(dt, torch.float32)
    slot = torch.arange(K, device=dev)[:, None]  # (K, 1) over (B, M, K, C)
    g_slot = torch.zeros((B, M, K, C), dtype=acc, device=dev)
    for g, win in ((g_fmax, amax), (g_fmin, amin)):
        if g is not None:
            g_slot = g_slot + torch.where(win.long()[:, :, None, :] == slot,
                                          g.to(acc)[:, :, None, :], 0.0)
    g_feats = torch.zeros((B, n, C), dtype=acc, device=dev)
    rows = idx.long().reshape(B, M * K)
    g_feats.scatter_add_(1, rows[..., None].expand(-1, -1, C),
                         _bf16(g_slot).reshape(B, M * K, C))
    q = query_idx.long()[..., None]
    if g_fi is not None:
        g_feats.scatter_add_(1, q.expand(-1, -1, C), g_fi.to(acc))
    g_xyz = torch.zeros((B, n, 3), device=dev,
                        dtype=acc if g_new is None else g_new.dtype)
    if g_new is not None:
        g_xyz.scatter_add_(1, q.expand(-1, -1, 3), g_new)
    return g_xyz, g_feats.to(dt)


def _vec(dtype: torch.dtype, C: int, aligned: bool) -> int:
    """Channels a thread loads at once: 16 bytes of them where the rows and
    pointers allow it, else one."""
    v = 16 // dtype.itemsize
    return v if aligned and C % v == 0 else 1


def fwd_smem_bytes(tm: int, K: int, N: int, use_xs: bool) -> int:
    """Shared memory of one forward block, as ``ball_group_max_smem_bytes``
    computes it (csrc/ballgroup_max.cu ``fwd_layout``; ``chip_smoke.py``
    holds the two equal): the tile's slot table, each center's index and
    walk, and with ``use_xs`` the cloud's N points, 16 bytes each."""
    return (_a128(tm * K * 4) + _a128(tm * 8)
            + (_a128(N * 16) if use_xs else 0))


def bwd_smem_bytes(s: int, r: int) -> int:
    """Shared memory of one backward block, as
    ``ball_group_max_bwd_smem_bytes`` computes it: ``r`` rows of ``s``
    channels in f32, a row padded by one."""
    return _a128(r * (s + 1) * 4)


class FwdTiling(NamedTuple):
    """The forward's launch shape: ``tm`` centers a block, ``use_xs`` the
    cloud staged in shared memory, ``vec`` channels a thread loads at once
    (16 bytes of them, or 1)."""
    tm: int
    use_xs: bool
    vec: int


class BwdTiling(NamedTuple):
    """The backward's launch shape: ``s`` channels (a power of two) and ``r``
    rows a block."""
    s: int
    r: int


def _check_shape(B: int, N: int, M: int, C: int, K: int, dtype) -> None:
    if not (1 <= K <= 255) or min(B, N, M, C) < 1:
        raise ValueError(f"the max-pooled ball group takes 1 <= K <= 255 and "
                         f"B, N, M, C >= 1; got K={K} B={B} N={N} M={M} "
                         f"C={C}")
    if dtype not in DTYPES:
        raise ValueError(f"the max-pooled ball group takes f32 or bf16 "
                         f"features, got {dtype}")


@functools.lru_cache(maxsize=64)
def fwd_tiling(B: int, N: int, M: int, C: int, K: int, dtype: torch.dtype,
               aligned: bool = True) -> FwdTiling:
    """The forward's tiling: the most centers a block (32, 16 or 8) that
    still give four blocks an SM of work, the cloud staged where two blocks
    still fit an SM. Raises ValueError on a shape the kernel does not take."""
    _check_shape(B, N, M, C, K, dtype)
    tm = next((t for t in (32, 16) if B * -(-M // t) >= 4 * _SMS), 8)
    use_xs = fwd_smem_bytes(tm, K, N, True) <= _SMEM_TWO_BLOCKS
    return FwdTiling(tm, use_xs, _vec(dtype, C, aligned))


@functools.lru_cache(maxsize=64)
def bwd_tiling(N: int, C: int, s: int = 0) -> BwdTiling:
    """The backward's tiling: the widest slice of 32, 16, 8 or 4 channels
    (no wider than C rounded up to a power of two) whose N rows fit two
    blocks an SM, or ``s`` channels when given; where 4 channels' rows do
    not fit, the rows split into ranges a block, each range re-reading
    every center."""
    if min(N, C) < 1:
        raise ValueError(f"bad backward shape N={N} C={C}")
    if s and (s < 4 or s > 256 or s & (s - 1)):
        raise ValueError(f"a slice is a power of two from 4 to 256 "
                         f"channels, got {s}")
    if not s:
        s = next((w for w in _BWD_SLICES
                  if bwd_smem_bytes(w, N) <= _SMEM_TWO_BLOCKS), 4)
        s = max(4, min(s, 1 << (C - 1).bit_length()))
    return BwdTiling(s, min(N, _SMEM_TWO_BLOCKS // ((s + 1) * 4)))


@functools.cache
def _lib():
    lib = _build.load("ballgroup_max")
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    lib.ball_group_max_launch.argtypes = [p, p, p, i, i, i, i, i, i, f, i,
                                          i, i, p, p, p, p, p, p, p, p]
    lib.ball_group_max_launch.restype = i
    lib.ball_group_max_bwd_launch.argtypes = [p, p, p, p, p, p, p, p, i, i,
                                              i, i, i, i, i, i, p, p, p]
    lib.ball_group_max_bwd_launch.restype = i
    lib.ball_group_max_smem_bytes.argtypes = [i, i, i, i]
    lib.ball_group_max_smem_bytes.restype = ll
    lib.ball_group_max_bwd_smem_bytes.argtypes = [i, i]
    lib.ball_group_max_bwd_smem_bytes.restype = ll
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def ball_group_max_cuda(radius: float, nsample: int, xyz, query_idx, feats):
    """The forward kernel on contiguous CUDA tensors (f32 xyz, f32 or bf16
    feats, int32 query_idx in ``[0, N)``); same outputs as
    :func:`ball_group_max_plain`, detached from the inputs."""
    global LAUNCHES
    B, N, M, C, K = (*xyz.shape[:2], query_idx.shape[-1], feats.shape[-1],
                     int(nsample))
    _check_shape(B, N, M, C, K, feats.dtype)
    _check_inputs(xyz, query_idx, feats, tuple(DTYPES))
    tl = fwd_tiling(B, N, M, C, K, feats.dtype, feats.data_ptr() % 16 == 0)
    dev, dt = xyz.device, feats.dtype
    new_xyz = torch.empty((B, M, 3), dtype=torch.float32, device=dev)
    fi, fmax, fmin = (torch.empty((B, M, C), dtype=dt, device=dev)
                      for _ in range(3))
    amax, amin = (torch.empty((B, M, C), dtype=torch.uint8, device=dev)
                  for _ in range(2))
    idx = torch.empty((B, M, K), dtype=torch.int32, device=dev)
    lib = _lib()
    err = lib.ball_group_max_launch(
        xyz.data_ptr(), query_idx.data_ptr(), feats.data_ptr(), DTYPES[dt],
        B, N, M, C, K, radius_sq(radius), tl.tm, int(tl.use_xs), tl.vec,
        new_xyz.data_ptr(), fi.data_ptr(), fmax.data_ptr(), fmin.data_ptr(),
        amax.data_ptr(), amin.data_ptr(), idx.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "ball_group_max")
    LAUNCHES += 1
    return new_xyz, fi, fmax, fmin, amax, amin, idx


def _cotangent(g, shape, dtype, name, dev):
    """A cotangent as a contiguous CUDA tensor of ``shape`` and ``dtype``,
    or ``None``."""
    if g is None:
        return None
    if g.device != dev or tuple(g.shape) != shape or g.dtype != dtype:
        raise ValueError(f"{name} must be {shape} {dtype} on {dev}, got "
                         f"{tuple(g.shape)} {g.dtype} on {g.device}")
    return g.contiguous()


def ball_group_max_bwd_cuda(idx, query_idx, amax, amin, g_new, g_fi, g_fmax,
                            g_fmin, n: int, need_xyz: bool = True,
                            need_feats: bool = True,
                            feat_dtype: torch.dtype = torch.float32):
    """The backward kernel; same outputs as :func:`ball_group_max_bwd_plain`
    (``None`` for a gradient not asked for). ``g_new`` is f32, ``g_fi``,
    ``g_fmax``, ``g_fmin`` and the feature gradient ``feat_dtype`` (the
    forward's features' type); cotangents may be ``None`` or
    non-contiguous; the rest are CUDA tensors of the forward's shapes."""
    global LAUNCHES_BWD
    B, M, K = idx.shape
    C = amax.shape[-1]
    dev = idx.device
    _check_shape(B, n, M, C, K, feat_dtype)
    for name, t, dtype in (("idx", idx, torch.int32),
                           ("query_idx", query_idx, torch.int32),
                           ("amax", amax, torch.uint8),
                           ("amin", amin, torch.uint8)):
        if t.device.type != "cuda" or t.dtype != dtype \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} CUDA "
                             f"tensor, got {t.dtype} on {t.device}")
    if query_idx.shape != (B, M) or amax.shape != (B, M, C) \
            or amin.shape != (B, M, C):
        raise ValueError("idx, query_idx, amax and amin do not match")

    g_new = _cotangent(g_new, (B, M, 3), torch.float32, "g_new", dev)
    g_fi, g_fmax, g_fmin = (_cotangent(g, (B, M, C), feat_dtype, name, dev)
                            for g, name in ((g_fi, "g_fi"), (g_fmax, "g_fmax"),
                                            (g_fmin, "g_fmin")))
    tl = bwd_tiling(n, C)
    g_xyz = torch.empty((B, n, 3), dtype=torch.float32, device=dev) \
        if need_xyz else None
    g_feats = torch.empty((B, n, C), dtype=feat_dtype, device=dev) \
        if need_feats else None
    if g_xyz is None and g_feats is None:
        return None, None
    lib = _lib()
    err = lib.ball_group_max_bwd_launch(
        idx.data_ptr(), query_idx.data_ptr(), _ptr(g_new), _ptr(g_fi),
        _ptr(g_fmax), _ptr(g_fmin), amax.data_ptr(), amin.data_ptr(),
        DTYPES[feat_dtype], B, n, M, C, K, tl.s, tl.r, _ptr(g_xyz),
        _ptr(g_feats), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "ball_group_max_bwd")
    LAUNCHES_BWD += 1
    return g_xyz, g_feats


class BallGroupMax(torch.autograd.Function):
    """The max-pooled ball group with its first-winner backward: the kernels
    when ``use_kernels``, the plain versions otherwise. Returns ``(new_xyz,
    fi, fmax, fmin)``, the last three in the features' type; ``query_idx``
    gets no gradient."""

    @staticmethod
    def forward(ctx, xyz, query_idx, feats, radius, nsample, use_kernels):
        fwd = ball_group_max_cuda if use_kernels else ball_group_max_plain
        new_xyz, fi, fmax, fmin, amax, amin, idx = fwd(
            radius, nsample, xyz, query_idx, feats)
        ctx.save_for_backward(idx, query_idx, amax, amin)
        ctx.n, ctx.use_kernels = xyz.shape[1], use_kernels
        ctx.feat_dtype = feats.dtype
        if not ctx.needs_input_grad[0]:
            # a constant of xyz alone: keep what is computed from it off the
            # graph
            ctx.mark_non_differentiable(new_xyz)
        ctx.set_materialize_grads(False)
        return new_xyz, fi, fmax, fmin

    @staticmethod
    def backward(ctx, g_new, g_fi, g_fmax, g_fmin):
        idx, query_idx, amax, amin = ctx.saved_tensors
        need_xyz, _, need_feats = ctx.needs_input_grad[:3]
        if ctx.use_kernels:
            g_xyz, g_feats = ball_group_max_bwd_cuda(
                idx, query_idx, amax, amin, g_new, g_fi, g_fmax, g_fmin,
                ctx.n, need_xyz, need_feats, ctx.feat_dtype)
        elif all(g is None for g in (g_new, g_fi, g_fmax, g_fmin)):
            g_xyz = g_feats = None
        else:
            g_xyz, g_feats = ball_group_max_bwd_plain(
                idx, query_idx, amax, amin, g_new, g_fi, g_fmax, g_fmin,
                ctx.n)
        return (g_xyz if need_xyz else None, None,
                g_feats if need_feats else None, None, None, None)
