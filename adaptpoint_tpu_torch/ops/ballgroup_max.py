"""Max-pooled ball group, forward and backward: the CUDA kernels and their plain versions.

Forward (``csrc/ballgroup_max.cu``) replaces
``adaptpoint_tpu/ops/pallas/ballgroup.py`` ``_bg_max_call``
(``_fwd_max_kernel``), backward ``_bg_max_bwd`` (``_bwd_max_kernel``): the
two halves of ``ball_group_maxpool_pallas`` as the augmentor's
``PointsetGrouper`` calls it (``splits=1, grad_splits=1``). Bound on the
H100: bytes (the features are read once, only (B, M, C) outputs are
written: the (B, K, M, C) grouped tensor never exists). One warp per query
center, the ball-group kernel's selection, lanes over channels; see the
source's note.

The TPU kernel's rounding is part of the function, and both versions here
reproduce it:

- ``new_xyz`` exact; ``fi = bf16(f[q])``; ``fmax``/``fmin`` the max and min
  over the K slots of ``bf16(f[idx])``; ``amax``/``amin`` the first slot that
  holds each (``torch.argmax``'s first-index rule);
- the backward sends ``bf16(g_fmax * [amax == k] + g_fmin * [amin == k])`` to
  slot k's neighbour (one rounding of the sum), and ``g_fi`` and ``g_new``
  unrounded to the center's row; ``xyz`` gets only ``g_new``.

:class:`BallGroupMax` ties the two into one differentiable op whatever the
device: the kernels for CUDA tensors, the plain versions otherwise.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ballgroup import _check_inputs, _cotangent
from .geometry import ball_query, index_points, radius_sq
from .saeval import _bf16

__all__ = ["ball_group_max_cuda", "ball_group_max_plain",
           "ball_group_max_bwd_cuda", "ball_group_max_bwd_plain",
           "BallGroupMax", "LAUNCHES", "LAUNCHES_BWD"]

LAUNCHES = 0      # kernel launches of ball_group_max_cuda
LAUNCHES_BWD = 0  # kernel launches of ball_group_max_bwd_cuda


def ball_group_max_plain(radius: float, nsample: int, xyz, query_idx, feats):
    """xyz (B,N,3), query_idx (B,M), feats (B,N,C) of one float type ->
    ``(new_xyz (B,M,3), fi, fmax, fmin (B,M,C), amax, amin (B,M,C) uint8,
    idx (B,M,K) int32)``."""
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
    be ``None`` (zero); the rest share one float type, which the gradients
    ``(g_xyz (B,n,3), g_feats (B,n,C))`` take."""
    B, M, K = idx.shape
    C = amax.shape[-1]
    ref = next(g for g in (g_fmax, g_fmin, g_fi, g_new) if g is not None)
    dt, dev = ref.dtype, ref.device
    slot = torch.arange(K, device=dev)[:, None]  # (K, 1) over (B, M, K, C)
    g_slot = torch.zeros((B, M, K, C), dtype=dt, device=dev)
    for g, win in ((g_fmax, amax), (g_fmin, amin)):
        if g is not None:
            g_slot = g_slot + torch.where(win.long()[:, :, None, :] == slot,
                                          g[:, :, None, :], 0.0)
    g_feats = torch.zeros((B, n, C), dtype=dt, device=dev)
    rows = idx.long().reshape(B, M * K)
    g_feats.scatter_add_(1, rows[..., None].expand(-1, -1, C),
                         _bf16(g_slot).reshape(B, M * K, C))
    q = query_idx.long()[..., None]
    if g_fi is not None:
        g_feats.scatter_add_(1, q.expand(-1, -1, C), g_fi)
    g_xyz = torch.zeros((B, n, 3), dtype=dt, device=dev)
    if g_new is not None:
        g_xyz.scatter_add_(1, q.expand(-1, -1, 3), g_new)
    return g_xyz, g_feats


@functools.cache
def _lib():
    lib = _build.load("ballgroup_max")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ball_group_max_launch.argtypes = [p, p, p, i, i, i, i, i, f,
                                          p, p, p, p, p, p, p, p]
    lib.ball_group_max_launch.restype = ctypes.c_int
    lib.ball_group_max_bwd_launch.argtypes = [p, p, p, p, p, p, p, p,
                                              i, i, i, i, i, p, p, p]
    lib.ball_group_max_bwd_launch.restype = ctypes.c_int
    return lib


def ball_group_max_cuda(radius: float, nsample: int, xyz, query_idx, feats):
    """The forward kernel on contiguous CUDA tensors (f32 xyz and feats, int32
    query_idx in ``[0, N)``); same outputs as :func:`ball_group_max_plain`,
    detached from the inputs."""
    global LAUNCHES
    _check_inputs(xyz, query_idx, feats)
    B, N, _ = xyz.shape
    M = query_idx.shape[1]
    C = feats.shape[2]
    K = int(nsample)
    if not (1 <= K <= 255) or M < 1 or C < 1:
        raise ValueError(f"the max-pooled ball group takes 1 <= K <= 255, "
                         f"M >= 1, C >= 1; got K={K} M={M} C={C}")
    dev = xyz.device
    new_xyz = torch.empty((B, M, 3), dtype=torch.float32, device=dev)
    fi, fmax, fmin = (torch.empty((B, M, C), dtype=torch.float32, device=dev)
                      for _ in range(3))
    amax, amin = (torch.empty((B, M, C), dtype=torch.uint8, device=dev)
                  for _ in range(2))
    idx = torch.empty((B, M, K), dtype=torch.int32, device=dev)
    lib = _lib()
    err = lib.ball_group_max_launch(
        xyz.data_ptr(), query_idx.data_ptr(), feats.data_ptr(), B, N, M, C,
        K, radius_sq(radius), new_xyz.data_ptr(), fi.data_ptr(),
        fmax.data_ptr(), fmin.data_ptr(), amax.data_ptr(), amin.data_ptr(),
        idx.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "ball_group_max")
    LAUNCHES += 1
    return new_xyz, fi, fmax, fmin, amax, amin, idx


def ball_group_max_bwd_cuda(idx, query_idx, amax, amin, g_new, g_fi, g_fmax,
                            g_fmin, n: int, need_xyz: bool = True,
                            need_feats: bool = True):
    """The backward kernel; same outputs as :func:`ball_group_max_bwd_plain`
    (``None`` for a gradient not asked for). Cotangents may be ``None`` or
    non-contiguous; the rest are CUDA tensors of the forward's shapes."""
    global LAUNCHES_BWD
    B, M, K = idx.shape
    C = amax.shape[-1]
    dev = idx.device
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

    g_new = _cotangent(g_new, (B, M, 3), "g_new", dev)
    g_fi, g_fmax, g_fmin = (_cotangent(g, (B, M, C), name, dev)
                            for g, name in ((g_fi, "g_fi"), (g_fmax, "g_fmax"),
                                            (g_fmin, "g_fmin")))
    g_xyz = torch.empty((B, n, 3), dtype=torch.float32, device=dev) \
        if need_xyz else None
    g_feats = torch.empty((B, n, C), dtype=torch.float32, device=dev) \
        if need_feats else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _lib()
    err = lib.ball_group_max_bwd_launch(
        idx.data_ptr(), query_idx.data_ptr(), ptr(g_new), ptr(g_fi),
        ptr(g_fmax), ptr(g_fmin), amax.data_ptr(), amin.data_ptr(), B, n, M,
        C, K, ptr(g_xyz), ptr(g_feats),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "ball_group_max_bwd")
    LAUNCHES_BWD += 1
    return g_xyz, g_feats


class BallGroupMax(torch.autograd.Function):
    """The max-pooled ball group with its first-winner backward: the kernels
    when ``use_kernels``, the plain versions otherwise. Returns ``(new_xyz,
    fi, fmax, fmin)``; ``query_idx`` gets no gradient."""

    @staticmethod
    def forward(ctx, xyz, query_idx, feats, radius, nsample, use_kernels):
        fwd = ball_group_max_cuda if use_kernels else ball_group_max_plain
        new_xyz, fi, fmax, fmin, amax, amin, idx = fwd(
            radius, nsample, xyz, query_idx, feats)
        ctx.save_for_backward(idx, query_idx, amax, amin)
        ctx.n, ctx.use_kernels = xyz.shape[1], use_kernels
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
                ctx.n, need_xyz, need_feats)
        elif all(g is None for g in (g_new, g_fi, g_fmax, g_fmin)):
            g_xyz = g_feats = None
        else:
            g_xyz, g_feats = ball_group_max_bwd_plain(
                idx, query_idx, amax, amin, g_new, g_fi, g_fmax, g_fmin,
                ctx.n)
        return (g_xyz if need_xyz else None, None,
                g_feats if need_feats else None, None, None, None)
