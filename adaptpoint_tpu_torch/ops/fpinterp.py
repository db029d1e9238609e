"""3-NN weighted gather of the feature-propagation decode: the CUDA kernels and their plain versions.

Forward (``csrc/fpinterp.cu``) replaces ``adaptpoint_tpu/ops/pallas/fpinterp.py``
``_call_fwd`` (``_fwd_kernel``), backward its VJP ``_bwd`` (``_bwd_kernel``):
``out[b, n, :] = sum_j w[b, n, j] * feat[b, idx[b, n, j], :]`` for bf16
features, f32 weights and an f32 result, as ``ops.three_interpolation``
takes it for bf16 features. Bound on the H100: bytes (the (B, N, C) f32
output dominates). One warp per output row, lanes over channels; see the
source's note.

The TPU kernel's rounding is part of the function, and both versions here
reproduce it:

- duplicate neighbours of a row are merged first, in the TPU kernel's order
  (``0 + w0`` at ``i0``, then ``+ w1`` at ``i1``, then ``+ w2`` at ``i2``);
  each merged weight is split ``hi = bf16(W)``, ``lo = bf16(W - hi)``;
- ``out = ((hi0 f0 + hi1 f1) + hi2 f2) + ((lo0 f0 + lo1 f1) + lo2 f2)``:
  every product is exact in f32 and the order is fixed, so the kernel and
  the plain version agree bit for bit;
- the backward rounds the cotangent to bf16 once (``gb``), adds
  ``hi gb + lo gb`` onto each distinct neighbour's row in f32 and rounds
  ``d_feat`` to bf16 once at the end; ``d_w[n, j] = sum_c gb[n, c]
  feat[idx_j, c]``, the whole sum for a duplicate slot too.

The backward kernel's d_feat is one launch of ``csrc/scatter_rows.cuh``'s
scatter (launch shape from ``ops.scatter_rows.choose``): each row's f32 sum
taken from 0 in ascending source-row order, the same bits from run to run;
:func:`weighted_gather3_bwd_ordered` is the plain function of that order.
Small scatters take the L2-reduction design instead (a memset, the kernel
and a rounding pass; no fixed order). ``d_w``, when asked for, is a second
launch.

:class:`WeightedGather3` ties the two into one differentiable op whatever the
device: the kernels for CUDA tensors, the plain versions otherwise. ``d_w``
is computed only where the weights ask for a gradient.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, scatter_rows
from .geometry import index_points

__all__ = ["weighted_gather3_cuda", "weighted_gather3_plain",
           "weighted_gather3_bwd_cuda", "weighted_gather3_bwd_plain",
           "weighted_gather3_bwd_ordered", "WeightedGather3", "LAUNCHES",
           "LAUNCHES_BWD"]

LAUNCHES = 0      # kernel launches of weighted_gather3_cuda
LAUNCHES_BWD = 0  # kernel launches of weighted_gather3_bwd_cuda


def _split_weights(idx: torch.Tensor, w: torch.Tensor):
    """``(hi, lo)``, each (B, N, 3) f32 holding bf16 values: the merged
    weights of each row's distinct neighbours split in two (0 for a slot that
    repeats an earlier slot's index)."""
    i0, i1, i2 = idx.unbind(-1)
    w0, w1, w2 = w.unbind(-1)
    zero = torch.zeros_like(w0)
    merged = torch.stack([
        (w0 + torch.where(i1 == i0, w1, zero)) + torch.where(i2 == i0, w2,
                                                             zero),
        torch.where(i1 == i0, zero, w1 + torch.where(i2 == i1, w2, zero)),
        torch.where((i2 == i0) | (i2 == i1), zero, w2)], dim=-1)
    hi = merged.to(torch.bfloat16).float()
    lo = (merged - hi).to(torch.bfloat16).float()
    return hi, lo


def weighted_gather3_plain(feat: torch.Tensor, idx: torch.Tensor,
                           w: torch.Tensor) -> torch.Tensor:
    """feat (B, M, C) bf16, idx (B, N, 3) int in ``[0, M)``, w (B, N, 3) f32
    -> (B, N, C) f32."""
    hi, lo = _split_weights(idx, w)
    f = index_points(feat, idx).float()  # (B, N, 3, C)
    s_hi = (hi[..., 0:1] * f[:, :, 0] + hi[..., 1:2] * f[:, :, 1]) \
        + hi[..., 2:3] * f[:, :, 2]
    s_lo = (lo[..., 0:1] * f[:, :, 0] + lo[..., 1:2] * f[:, :, 1]) \
        + lo[..., 2:3] * f[:, :, 2]
    return s_hi + s_lo


def weighted_gather3_bwd_plain(feat: torch.Tensor, idx: torch.Tensor,
                               w: torch.Tensor, g: torch.Tensor,
                               need_feat: bool = True, need_w: bool = True):
    """VJP of :func:`weighted_gather3_plain` for the f32 cotangent ``g``
    (B, N, C): ``(d_feat (B, M, C) bf16, d_w (B, N, 3) f32)``, ``None`` for
    one not asked for."""
    B, M, C = feat.shape
    N = idx.shape[1]
    gb = g.to(torch.bfloat16).float()
    d_feat = d_w = None
    if need_feat:
        hi, lo = _split_weights(idx, w)
        terms = hi[..., None] * gb[:, :, None, :] \
            + lo[..., None] * gb[:, :, None, :]  # (B, N, 3, C)
        acc = torch.zeros((B, M, C), dtype=torch.float32, device=feat.device)
        rows = idx.long().reshape(B, N * 3, 1).expand(-1, -1, C)
        acc.scatter_add_(1, rows, terms.reshape(B, N * 3, C))
        d_feat = acc.to(torch.bfloat16)
    if need_w:
        f = index_points(feat, idx).float()  # (B, N, 3, C)
        d_w = (gb[:, :, None, :] * f).sum(dim=-1)
    return d_feat, d_w


def weighted_gather3_bwd_ordered(idx: torch.Tensor, w: torch.Tensor,
                                 g: torch.Tensor, m: int) -> torch.Tensor:
    """``d_feat`` of :func:`weighted_gather3_bwd_plain` with each row's f32
    sum taken from 0 in ascending source-row order (a row names each
    distinct neighbour in one slot), the kernel's order: it equals the
    kernel bit for bit. For checks; the port does not call it."""
    B, N, _ = idx.shape
    hi, lo = _split_weights(idx, w)
    gb = g.to(torch.bfloat16).float()
    terms = (hi[..., None] * gb[:, :, None, :]
             + lo[..., None] * gb[:, :, None, :])
    i0, i1, i2 = idx.long().unbind(-1)
    drop = torch.full_like(i0, -1)  # a slot repeating an earlier one
    dest = torch.stack([i0, torch.where(i1 == i0, drop, i1),
                        torch.where((i2 == i0) | (i2 == i1), drop, i2)], -1)
    return scatter_rows.scatter_rows_ordered(
        terms.reshape(B, N * 3, -1), dest.reshape(B, N * 3), m
    ).to(torch.bfloat16)


@functools.cache
def _lib():
    lib = _build.load("fpinterp")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.weighted_gather3_launch.argtypes = [p, p, p, i, i, i, i, p, p]
    lib.weighted_gather3_launch.restype = ctypes.c_int
    lib.weighted_gather3_bwd_launch.argtypes = [p, p, p, p, i, i, i, i,
                                                p, p, p, i, i, i, i, i, p]
    lib.weighted_gather3_bwd_launch.restype = ctypes.c_int
    lib.weighted_gather3_bwd_smem_bytes.argtypes = [i, i, i, i, i, i]
    lib.weighted_gather3_bwd_smem_bytes.restype = ctypes.c_longlong
    return lib


def _check(feat, idx, w):
    for name, t, dtype in (("feat", feat, torch.bfloat16),
                           ("idx", idx, torch.int32), ("w", w, torch.float32)):
        if t.device.type != "cuda" or t.dtype != dtype \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} CUDA "
                             f"tensor, got {t.dtype} on {t.device}")
    if feat.dim() != 3 or idx.dim() != 3 or idx.shape[2] != 3 \
            or idx.shape[0] != feat.shape[0] or w.shape != idx.shape:
        raise ValueError(f"feat (B, M, C), idx and w (B, N, 3) expected, got "
                         f"{tuple(feat.shape)}, {tuple(idx.shape)}, "
                         f"{tuple(w.shape)}")
    if min(feat.shape) < 1 or idx.shape[1] < 1:
        raise ValueError(f"empty weighted gather: {tuple(feat.shape)} by "
                         f"{tuple(idx.shape)}")


def weighted_gather3_cuda(feat: torch.Tensor, idx: torch.Tensor,
                          w: torch.Tensor) -> torch.Tensor:
    """The forward kernel on CUDA tensors (no autograd: see
    :class:`WeightedGather3`). ``idx`` must lie in ``[0, M)``: checking would
    cost a device sync on every launch."""
    global LAUNCHES
    _check(feat, idx, w)
    B, M, C = feat.shape
    N = idx.shape[1]
    out = torch.empty((B, N, C), dtype=torch.float32, device=feat.device)
    lib = _lib()
    err = lib.weighted_gather3_launch(
        feat.data_ptr(), idx.data_ptr(), w.data_ptr(), B, M, N, C,
        out.data_ptr(), torch.cuda.current_stream(feat.device).cuda_stream)
    _build.check(lib, err, "weighted_gather3")
    LAUNCHES += 1
    return out


def weighted_gather3_bwd_cuda(feat: torch.Tensor, idx: torch.Tensor,
                              w: torch.Tensor, g: torch.Tensor,
                              need_feat: bool = True, need_w: bool = True):
    """The backward kernel; same outputs as
    :func:`weighted_gather3_bwd_plain`."""
    global LAUNCHES_BWD
    _check(feat, idx, w)
    B, M, C = feat.shape
    N = idx.shape[1]
    g = g.float().contiguous()
    if g.shape != (B, N, C) or g.device != feat.device:
        raise ValueError(f"g must be ({B}, {N}, {C}) on {feat.device}, got "
                         f"{tuple(g.shape)} on {g.device}")
    dev = feat.device
    scratch = d_feat = d_w = None
    tl = scatter_rows.choose(B, 3 * N, M, C, True, 4, g.data_ptr() % 16 == 0)
    if need_feat:
        d_feat = torch.empty((B, M, C), dtype=torch.bfloat16, device=dev)
        if tl.design == scatter_rows.L2RED:
            scratch = torch.empty((B, M, C), dtype=torch.float32, device=dev)
    if need_w:
        d_w = torch.empty((B, N, 3), dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _lib()
    err = lib.weighted_gather3_bwd_launch(
        feat.data_ptr(), idx.data_ptr(), w.data_ptr(), g.data_ptr(), B, M, N,
        C, ptr(scratch), ptr(d_feat), ptr(d_w), *tl,
        torch._C._cuda_getCurrentRawStream(feat.get_device()))
    if err:
        _build.check(lib, err, "weighted_gather3_bwd")
    LAUNCHES_BWD += 1
    return d_feat, d_w


class WeightedGather3(torch.autograd.Function):
    """The weighted gather with its backward: the kernels when
    ``use_kernels``, the plain versions otherwise. ``idx`` gets no gradient;
    ``d_w`` is computed only where ``w`` asks for one."""

    @staticmethod
    def forward(ctx, feat, idx, w, use_kernels):
        fwd = weighted_gather3_cuda if use_kernels else weighted_gather3_plain
        ctx.save_for_backward(feat, idx, w)
        ctx.use_kernels = use_kernels
        return fwd(feat, idx, w)

    @staticmethod
    def backward(ctx, g):
        feat, idx, w = ctx.saved_tensors
        need_feat, _, need_w = ctx.needs_input_grad[:3]
        bwd = weighted_gather3_bwd_cuda if ctx.use_kernels \
            else weighted_gather3_bwd_plain
        d_feat, d_w = bwd(feat, idx, w, g, need_feat, need_w)
        return d_feat, None, d_w, None
