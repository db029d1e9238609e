"""Flash self-attention, forward and backward: ``csrc/attention.cu`` and its
plain versions.

Replaces ``adaptpoint_tpu/ops/pallas/attention.py`` ``mha_pallas``: the
forward ``_mha_call`` (``_fwd_kernel``) and the flash-recompute backward
``_mha_bwd`` (``_bwd_kernel``), over flattened heads ``q, k, v (BH, N, d)``:

    S  = bf16(q) bf16(k)^T / scale          f32 accumulate
    P  = softmax(S)                          f32, max-subtracted, normalised
    out = bf16(P) bf16(v)                    f32
    dv = bf16(P)^T bf16(do);  dP = bf16(do) bf16(v)^T
    dS = P (dP - rowsum(dP * P)) / scale;  dq = bf16(dS) bf16(k)
    dk = bf16(dS)^T bf16(q)                  dq, dk, dv in q's type

The operand rounding is part of the function. ``mha_plain`` /
``mha_bwd_plain`` spell it with f32 matmuls of bf16-rounded values (exact
products, f32 sums) and hold the (N, N) logits in memory; the kernels keep
them in registers. Bound on the H100 at (128, 2048, 16): the exps, 2 an
element forward (P is normalised before it is rounded, so the forward makes
a pass for the row sums and one for P) and 1 backward, and the instructions
issued around them, not bytes or tensor-core operations; see the source's
note. The forward is one kernel
(after a cast to bf16 for f32 inputs); the backward is a pre-pass, one
kernel over key blocks, and a sum of the key blocks' dq slices in a fixed
order: no atomics, bit-reproducible.

:class:`FusedSelfAttention` ties the kernels into one differentiable op for
CUDA tensors; :class:`PlainSelfAttention` does the same with the plain
versions for CPU tensors, so the CPU tests pin the backward the kernels
implement rather than PyTorch's autograd of the forward (which would round
the cotangents at other places).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["mha_cuda", "mha_bwd_cuda", "mha_plain", "mha_bwd_plain",
           "FusedSelfAttention", "PlainSelfAttention", "LAUNCHES",
           "LAUNCHES_BWD", "HEAD_DIMS"]

LAUNCHES = 0      # launches of the forward kernel (mha_cuda)
LAUNCHES_BWD = 0  # launches of the backward kernels (mha_bwd_cuda)
HEAD_DIMS = (16, 32, 64)
_DTYPES = (torch.float32, torch.bfloat16)


def _b(x: torch.Tensor) -> torch.Tensor:
    """Rounded to bf16, held in f32."""
    return x.to(torch.bfloat16).float()


def _softmax_plain(q, k, scale: float) -> torch.Tensor:
    s = torch.matmul(_b(q), _b(k).transpose(1, 2)) / scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return p / p.sum(dim=-1, keepdim=True)


def mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float) -> torch.Tensor:
    """softmax(q k^T / scale) v with bf16 operands: (BH, N, d) -> f32."""
    return torch.matmul(_b(_softmax_plain(q, k, scale)), _b(v))


def mha_bwd_plain(q, k, v, scale: float, do: torch.Tensor):
    """The flash backward written out on whole matrices: ``(dq, dk, dv)`` in
    q's, k's and v's types."""
    p = _softmax_plain(q, k, scale)
    pb, dob = _b(p), _b(do)
    dv = torch.matmul(pb.transpose(1, 2), dob)
    dp = torch.matmul(dob, _b(v).transpose(1, 2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True)) / scale
    dsb = _b(ds)
    dq = torch.matmul(dsb, _b(k))
    dk = torch.matmul(dsb.transpose(1, 2), _b(q))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@functools.cache
def _lib():
    lib = _build.load("attention")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mha_fwd_launch.argtypes = [p, p, p, i, p, i, i, i, f, p, p, p, p, p]
    lib.mha_fwd_launch.restype = ctypes.c_int
    lib.mha_bwd_launch.argtypes = [p, p, p, i, p, p, p, p, p, i, i, i, f,
                                   p, p, p, p, p, p, p]
    lib.mha_bwd_launch.restype = ctypes.c_int
    lib.mha_bwd_key_blocks.argtypes = [i, i]
    lib.mha_bwd_key_blocks.restype = ctypes.c_int
    return lib


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"the attention kernels need CUDA tensors, "
                             f"{name} is on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned")
    if (q.dim() != 3 or q.dtype not in _DTYPES or q.shape[2] not in HEAD_DIMS
            or min(q.shape) < 1):
        raise ValueError(f"q must be (BH, N, d) float32 or bfloat16 with d "
                         f"in {HEAD_DIMS}, got {tuple(q.shape)} {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q ({tuple(q.shape)} "
                             f"{q.dtype}), got {tuple(t.shape)} {t.dtype}")


def _bf16_scratch(q):
    """(3, BH, N, d) bf16 for the kernels' cast of f32 inputs, else None."""
    if q.dtype == torch.bfloat16:
        return None
    return torch.empty((3, *q.shape), dtype=torch.bfloat16, device=q.device)


def _ptr(t):
    return None if t is None else t.data_ptr()


def mha_cuda(q, k, v, scale: float, for_backward: bool = False):
    """The forward kernel: ``out (BH, N, d)`` f32, and with ``for_backward``
    also what the backward kernels need, ``(o32, row_off, row_inv)``: o32 =
    P v with P to 16 bits, and per row ``row_off = -log2(e) max_j S_ij`` and
    ``row_inv = 1 / sum_j exp(S_ij - max)``, from which the backward forms
    the forward's P."""
    global LAUNCHES
    _check(q, k, v)
    BH, N, D = q.shape
    dev = q.device
    out = torch.empty((BH, N, D), dtype=torch.float32, device=dev)
    row_off = torch.empty((BH, N), dtype=torch.float32, device=dev)
    row_inv = torch.empty((BH, N), dtype=torch.float32, device=dev)
    o32 = torch.empty_like(out) if for_backward else None
    qkv16 = _bf16_scratch(q)
    lib = _lib()
    err = lib.mha_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        int(q.dtype == torch.bfloat16), _ptr(qkv16), BH, N, D,
        float(scale), out.data_ptr(), _ptr(o32),
        row_off.data_ptr(), row_inv.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "mha")
    LAUNCHES += 1
    return (out, (o32, row_off, row_inv)) if for_backward else out


def mha_bwd_cuda(q, k, v, scale: float, do: torch.Tensor, saved):
    """The backward kernels: ``(dq, dk, dv)`` in q's type. ``saved`` is the
    ``(o32, row_off, row_inv)`` that ``mha_cuda(..., for_backward=True)``
    returned for the same q, k, v and scale."""
    global LAUNCHES_BWD
    _check(q, k, v)
    if (do.device != q.device or do.shape != q.shape
            or do.dtype != torch.float32 or not do.is_contiguous()
            or do.data_ptr() % 16):
        raise ValueError(f"do must be a contiguous, 16-byte aligned float32 "
                         f"{tuple(q.shape)} on {q.device}, got "
                         f"{tuple(do.shape)} {do.dtype}")
    o32, row_off, row_inv = saved
    BH, N, D = q.shape
    for name, t, shape in (("o32", o32, (BH, N, D)), ("row_off", row_off,
                                                      (BH, N)),
                           ("row_inv", row_inv, (BH, N))):
        if (t is None or t.device != q.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"saved {name} must be a contiguous float32 "
                             f"{shape} on {q.device}")
    dev = q.device
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    lib = _lib()
    qkv16 = _bf16_scratch(q)
    dob = torch.empty((BH, N, D), dtype=torch.bfloat16, device=dev)
    stats = torch.empty((BH, N, 4), dtype=torch.float32, device=dev)
    ws = torch.empty((BH, lib.mha_bwd_key_blocks(N, D), N, D),
                     dtype=torch.float32, device=dev)
    err = lib.mha_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        int(q.dtype == torch.bfloat16), _ptr(qkv16), do.data_ptr(),
        o32.data_ptr(), row_off.data_ptr(), row_inv.data_ptr(), BH, N, D,
        float(scale), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        dob.data_ptr(), stats.data_ptr(), ws.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "mha_bwd")
    LAUNCHES_BWD += 1
    return dq, dk, dv


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy where its data does not start on 16 bytes (the
    kernels copy 16 bytes at a time)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


class FusedSelfAttention(torch.autograd.Function):
    """``mha_cuda`` with ``mha_bwd_cuda`` as its backward (CUDA tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.scale = float(scale)
        need = any(ctx.needs_input_grad[:3])
        q, k, v = _aligned(q), _aligned(k), _aligned(v)
        got = mha_cuda(q, k, v, ctx.scale, for_backward=need)
        out, saved = got if need else (got, ())
        ctx.save_for_backward(q, k, v, *saved)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, *saved = ctx.saved_tensors
        dq, dk, dv = mha_bwd_cuda(q, k, v, ctx.scale,
                                  _aligned(do.float().contiguous()),
                                  tuple(saved))
        return dq, dk, dv, None


class PlainSelfAttention(torch.autograd.Function):
    """``mha_plain`` with ``mha_bwd_plain`` as its backward: what a CPU tensor
    takes, so that the CPU tests pin the backward the kernels implement."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.scale = float(scale)
        ctx.save_for_backward(q, k, v)
        return mha_plain(q, k, v, ctx.scale)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        return (*mha_bwd_plain(q, k, v, ctx.scale, do), None)
