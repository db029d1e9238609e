"""Row gather with a scatter-add backward: ``csrc/gather.cu`` and its plain version.

Replaces ``adaptpoint_tpu/ops/pallas/gather.py`` ``gather_rows_pallas``
(``_fwd_kernel``) and its VJP ``_bwd`` (``_bwd_kernel``):
``out[b, m, :] = pts[b, idx[b, m], :]`` exactly, for float32 and bfloat16
rows, and ``g_pts[b, idx[b, m], :] += g[b, m, :]`` with f32 sums cast to the
primal type. Bound on the H100: bytes, and at the train step's resampling
shape (about 1 MB) the launch itself; see the source's note. The wrappers'
host path is one combined check, the allocation and the ctypes call, with
the stream read as a raw handle. The backward is one launch of
``csrc/scatter_rows.cuh``'s scatter at the launch shape
``ops.scatter_rows.choose`` gives: each row summed in ascending slot order,
the same bits from run to run; :func:`gather_rows_bwd_ordered` is the plain
function of that order. Small scatters (the resampling shape) take the
L2-reduction design instead: a memset, the kernel and, for bf16, a rounding
pass, with no fixed order where indices repeat.

``gather_rows`` is differentiable on both devices: a CUDA tensor goes through
:class:`GatherRows` (both directions are kernels), a CPU tensor through
``gather_rows_plain`` and PyTorch's own autograd.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, scatter_rows
from .geometry import index_points

__all__ = ["gather_rows_cuda", "gather_rows_bwd_cuda", "gather_rows_plain",
           "gather_rows_bwd_plain", "gather_rows_bwd_ordered", "GatherRows",
           "LAUNCHES", "LAUNCHES_BWD"]

LAUNCHES = 0      # kernel launches of gather_rows_cuda
LAUNCHES_BWD = 0  # kernel launches of gather_rows_bwd_cuda

_DTYPES = (torch.float32, torch.bfloat16)


def gather_rows_plain(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (B, N, C), idx (B, M) int -> (B, M, C). An index outside
    ``[0, N)`` raises on the CPU (the JAX package's one-hot kernel yields a zero
    row there; the model never passes one, and the CUDA kernels do not
    look)."""
    if (points.device.type == "cpu" and idx.numel()
            and (int(idx.min()) < 0 or int(idx.max()) >= points.shape[1])):
        raise IndexError(f"gather_rows: idx outside [0, {points.shape[1]})")
    return index_points(points, idx)


def gather_rows_bwd_plain(g: torch.Tensor, idx: torch.Tensor,
                          n: int) -> torch.Tensor:
    """Scatter-add of ``g (B, M, C)`` onto ``(B, n, C)`` rows ``idx (B, M)``:
    f32 sums, duplicates all added, cast back to ``g``'s type."""
    B, M, C = g.shape
    acc = torch.zeros((B, n, C), dtype=torch.float32, device=g.device)
    acc.scatter_add_(1, idx.long()[..., None].expand(-1, -1, C), g.float())
    return acc.to(g.dtype)


def gather_rows_bwd_ordered(g: torch.Tensor, idx: torch.Tensor,
                            n: int) -> torch.Tensor:
    """:func:`gather_rows_bwd_plain` with each row's f32 sum taken from 0 in
    ascending slot order, the kernel's order: it equals the kernel bit for
    bit. For checks; the port does not call it."""
    return scatter_rows.scatter_rows_ordered(g.float(), idx, n).to(g.dtype)


# the C entry points, bound at the first launch: a launch reads a module
# global instead of building its function object and argument types again
_fwd_entry = _bwd_entry = None


def _bind():
    global _fwd_entry, _bwd_entry
    lib = _build.load("gather")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gather_rows_launch.argtypes = [p, p, i, i, i, i, i, p, p]
    lib.gather_rows_launch.restype = ctypes.c_int
    lib.gather_rows_bwd_launch.argtypes = [p, p, i, i, i, i, i, p, p, i, i,
                                           i, i, i, p]
    lib.gather_rows_bwd_launch.restype = ctypes.c_int
    lib.gather_rows_bwd_smem_bytes.argtypes = [i, i, i, i, i, i]
    lib.gather_rows_bwd_smem_bytes.restype = ctypes.c_longlong
    _fwd_entry, _bwd_entry = lib.gather_rows_launch, lib.gather_rows_bwd_launch
    return _fwd_entry, _bwd_entry


def _check(rows: torch.Tensor, idx: torch.Tensor, what: str) -> None:
    """Device, type, shape and contiguity, as one test on the launch path;
    the message is built only when it fails."""
    if (rows.is_cuda and idx.is_cuda and rows.dtype in _DTYPES
            and idx.dtype == torch.int32 and rows.dim() == 3
            and idx.dim() == 2 and rows.is_contiguous()
            and idx.is_contiguous() and rows.get_device() == idx.get_device()
            and idx.shape[0] == rows.shape[0] and idx.shape[1] > 0
            and rows.numel() > 0):
        return
    if not (rows.is_cuda and idx.is_cuda) \
            or rows.get_device() != idx.get_device():
        raise ValueError(f"the gather kernels need CUDA tensors on one "
                         f"device, {what} is on {rows.device}, idx on "
                         f"{idx.device}")
    if rows.dim() != 3 or rows.dtype not in _DTYPES:
        raise ValueError(f"{what} must be (B, *, C) float32 or bfloat16, got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    if (idx.dim() != 2 or idx.dtype != torch.int32
            or idx.shape[0] != rows.shape[0]):
        raise ValueError(f"idx must be (B, M) int32, got {tuple(idx.shape)} "
                         f"{idx.dtype}")
    if not (rows.is_contiguous() and idx.is_contiguous()):
        raise ValueError(f"{what} and idx must be contiguous")
    raise ValueError(f"empty gather: {tuple(rows.shape)} by "
                     f"{tuple(idx.shape)}")


def gather_rows_cuda(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The forward kernel on CUDA tensors (no autograd: see
    :class:`GatherRows`). ``idx`` must lie in ``[0, N)``: checking would cost
    a device sync on every launch."""
    global LAUNCHES
    _check(points, idx, "points")
    B, N, C = points.shape
    M = idx.shape[1]
    out = torch.empty((B, M, C), dtype=points.dtype, device=points.device)
    err = (_fwd_entry or _bind()[0])(
        points.data_ptr(), idx.data_ptr(), B, N, M, C, points.element_size(),
        out.data_ptr(),
        torch._C._cuda_getCurrentRawStream(points.get_device()))
    if err:
        _build.check(_build.load("gather"), err, "gather_rows")
    LAUNCHES += 1
    return out


def gather_rows_bwd_cuda(g: torch.Tensor, idx: torch.Tensor,
                         n: int) -> torch.Tensor:
    """The scatter-add kernel: ``g (B, M, C)``, ``idx (B, M)`` ->
    ``(B, n, C)`` of ``g``'s type."""
    global LAUNCHES_BWD
    _check(g, idx, "g")
    B, M, C = g.shape
    if idx.shape[1] != M or n < 1:
        raise ValueError(f"g {tuple(g.shape)} does not match idx "
                         f"{tuple(idx.shape)} or n={n}")
    out = torch.empty((B, n, C), dtype=g.dtype, device=g.device)
    tl = scatter_rows.choose(B, M, n, C, False, g.element_size(),
                             g.data_ptr() % 16 == 0)
    scratch = None  # the f32 buffer of the L2RED design's bf16 instance
    if tl.design == scatter_rows.L2RED and g.dtype != torch.float32:
        scratch = torch.empty((B, n, C), dtype=torch.float32,
                              device=g.device).data_ptr()
    err = (_bwd_entry or _bind()[1])(
        g.data_ptr(), idx.data_ptr(), B, n, M, C, g.element_size(),
        scratch, out.data_ptr(), *tl,
        torch._C._cuda_getCurrentRawStream(g.get_device()))
    if err:
        _build.check(_build.load("gather"), err, "gather_rows_bwd")
    LAUNCHES_BWD += 1
    return out


class GatherRows(torch.autograd.Function):
    """``gather_rows_cuda`` with ``gather_rows_bwd_cuda`` as its backward."""

    @staticmethod
    def forward(ctx, points, idx):
        ctx.save_for_backward(idx)
        ctx.n = points.shape[1]
        return gather_rows_cuda(points, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return gather_rows_bwd_cuda(g.contiguous(), idx, ctx.n), None
