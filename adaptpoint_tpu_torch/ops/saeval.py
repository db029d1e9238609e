"""Fused eval SetAbstraction: the CUDA kernel ``csrc/saeval.cu`` and its plain version.

Replaces ``adaptpoint_tpu/ops/pallas/saeval.py`` ``sa_eval_pallas``
(``_sa_eval_kernel``): ball group + conv (BN folded) + ReLU + conv (BN
folded) + max over K, forward only. Bound on the H100: operations -- the two
convs over B*M*K rows. The kernel stages the grouped rows of a tile of
centers in shared memory as bf16, runs both convs on the tensor cores (wmma,
f32 accumulate) and keeps the max over K in shared memory, so nothing grouped
reaches device memory; see the source's note.

The TPU kernel's rounding is part of the function (``splits=1``), and both
versions here reproduce it: ``fi = bf16(f)``; gathered xyz is the two-split
sum ``bf16(x) + bf16(x - bf16(x))``; ``new_xyz`` is exact;
``h = relu(bf16(gg) . bf16(w1) + b1)``; ``out = max_k bf16(h) . bf16(w2) + b2``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from . import _build
from .ballgroup import _check_inputs
from .geometry import ball_query, index_points, inv_radius, radius_sq

__all__ = ["sa_eval_cuda", "sa_eval_plain", "pack_weights", "PackedWeights",
           "LAUNCHES"]

LAUNCHES = 0  # kernel launches of sa_eval_cuda

_SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def sa_eval_plain(radius: float, nsample: int, xyz, query_idx, feats,
                  w1, b1, w2, b2, relative: bool = True,
                  normalize_dp: bool = False):
    """xyz (B,N,3), query_idx (B,M), feats (B,N,C) f32; w1 (3+C, mid),
    b1 (mid,), w2 (mid, cout), b2 (cout,) with BN folded in.
    Returns (new_xyz (B,M,3), fi (B,M,C), out (B,M,cout)) f32."""
    new_xyz = index_points(xyz, query_idx)
    idx = ball_query(radius, nsample, xyz, new_xyz)
    hi = _bf16(xyz)
    gx = index_points(hi + _bf16(xyz - hi), idx)  # (B, M, K, 3)
    if relative:
        gx = gx - new_xyz[:, :, None, :]
        if normalize_dp:
            gx = gx * torch.tensor(inv_radius(radius), dtype=torch.float32,
                                   device=xyz.device)
    fb = _bf16(feats)
    gg = _bf16(torch.cat([gx, index_points(fb, idx)], dim=-1))
    h = torch.relu(torch.matmul(gg, _bf16(w1)) + b1)
    o = torch.matmul(_bf16(h), _bf16(w2)) + b2
    return new_xyz, index_points(fb, query_idx), o.amax(dim=2)


@functools.cache
def _lib():
    lib = _build.load("saeval")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sa_eval_launch.argtypes = [p, p, p, p, p, p, p,
                                   i, i, i, i, i, i, i, i, i, i,
                                   f, f, i, p, p, p, p]
    lib.sa_eval_launch.restype = ctypes.c_int
    lib.sa_eval_smem_bytes.argtypes = [i, i, i, i, i]
    lib.sa_eval_smem_bytes.restype = ctypes.c_longlong
    return lib


def _round16(x: int) -> int:
    return (x + 15) // 16 * 16


def _padded(t: torch.Tensor, shape, dtype) -> torch.Tensor:
    out = torch.zeros(shape, dtype=dtype, device=t.device)
    out[tuple(slice(0, s) for s in t.shape)] = t.to(dtype)
    return out


class PackedWeights(NamedTuple):
    """Folded weights in the kernel's layout: bf16 ``w1 (Wp, midp)`` and
    ``w2 (midp, coutp)``, f32 ``b1 (midp,)`` and ``b2 (coutp,)``, zero padded
    to multiples of 16; ``cin = 3 + C``, ``mid`` and ``cout`` unpadded."""
    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    cin: int
    mid: int
    cout: int


def pack_weights(w1, b1, w2, b2) -> PackedWeights:
    """Pack folded f32 weights ``w1 (3+C, mid)``, ``b1 (mid,)``,
    ``w2 (mid, cout)``, ``b2 (cout,)`` for :func:`sa_eval_cuda`."""
    if w1.dim() != 2 or w2.dim() != 2 or w2.shape[0] != w1.shape[1] \
            or b1.shape != (w1.shape[1],) or b2.shape != (w2.shape[1],):
        raise ValueError(f"weights do not chain: w1 {tuple(w1.shape)} b1 "
                         f"{tuple(b1.shape)} w2 {tuple(w2.shape)} b2 "
                         f"{tuple(b2.shape)}")
    for name, t in (("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)):
        if t.dtype != torch.float32 or t.device != w1.device:
            raise ValueError(f"{name} must be float32 on {w1.device}")
    cin, mid, cout = w1.shape[0], w1.shape[1], w2.shape[1]
    Wp, midp, coutp = _round16(cin), _round16(mid), _round16(cout)
    return PackedWeights(_padded(w1, (Wp, midp), torch.bfloat16),
                         _padded(b1, (midp,), torch.float32),
                         _padded(w2, (midp, coutp), torch.bfloat16),
                         _padded(b2, (coutp,), torch.float32), cin, mid, cout)


@functools.lru_cache(maxsize=64)
def _centers_per_block(K: int, Wp: int, midp: int, coutp: int) -> int:
    """128 rows of round16(K) a block, fewer if shared memory runs out."""
    lib = _lib()
    tm = 128 // _round16(K)
    while tm > 1 and lib.sa_eval_smem_bytes(tm, K, Wp, midp, coutp) > _SMEM_LIMIT:
        tm //= 2
    if lib.sa_eval_smem_bytes(tm, K, Wp, midp, coutp) > _SMEM_LIMIT:
        raise ValueError(f"SA stage too wide for one block: K={K} Wp={Wp} "
                         f"mid={midp} cout={coutp}")
    return tm


def sa_eval_cuda(radius: float, nsample: int, xyz, query_idx, feats,
                 w1=None, b1=None, w2=None, b2=None, relative: bool = True,
                 normalize_dp: bool = False,
                 packed: Optional[PackedWeights] = None):
    """The kernel on CUDA tensors; same outputs as :func:`sa_eval_plain`.
    ``packed`` (from :func:`pack_weights`) replaces ``w1, b1, w2, b2``."""
    global LAUNCHES
    _check_inputs(xyz, query_idx, feats)
    if packed is None:
        packed = pack_weights(w1, b1, w2, b2)
    B, N, _ = xyz.shape
    M = query_idx.shape[1]
    C = feats.shape[2]
    K = int(nsample)
    if packed.cin != C + 3 or packed.w1.device != xyz.device:
        raise ValueError(f"weights for {packed.cin} input channels on "
                         f"{packed.w1.device}, features have C={C} on "
                         f"{xyz.device}")
    if K < 1 or M < 1 or K > 128:
        raise ValueError(f"the fused SA kernel takes 1 <= K <= 128 and "
                         f"M >= 1, got M={M} K={K}")
    Wp, midp = packed.w1.shape
    coutp = packed.w2.shape[1]
    tm = _centers_per_block(K, Wp, midp, coutp)
    dev = xyz.device
    new_xyz = torch.empty((B, M, 3), dtype=torch.float32, device=dev)
    fi = torch.empty((B, M, C), dtype=torch.float32, device=dev)
    out = torch.empty((B, M, packed.cout), dtype=torch.float32, device=dev)
    scale = inv_radius(radius) if (relative and normalize_dp) else 1.0
    lib = _lib()
    err = lib.sa_eval_launch(
        xyz.data_ptr(), query_idx.data_ptr(), feats.data_ptr(),
        packed.w1.data_ptr(), packed.b1.data_ptr(), packed.w2.data_ptr(),
        packed.b2.data_ptr(), B, N, M, C, K, tm, Wp, midp, coutp, packed.cout,
        radius_sq(radius), scale, int(bool(relative)), new_xyz.data_ptr(),
        fi.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "sa_eval")
    LAUNCHES += 1
    return new_xyz, fi, out
