"""Ball-group forward: the CUDA kernel ``csrc/ballgroup.cu`` and its plain version.

Replaces ``adaptpoint_tpu/ops/pallas/ballgroup.py`` ``_ball_group_call``
(``_fwd_kernel``, the forward of ``ball_group_pallas``). Bound on the H100:
bytes -- the (B, K, M, 3+C) grouped output dominates. The kernel gives one
warp to each query center, finds its neighbours with ``__ballot_sync`` and
``__popc`` ranks, stops at the K-th, and writes each neighbour's row once,
coalesced over channels; see the source's note.

Outputs keep the JAX package's layout: ``new_xyz (B,M,3)``, ``fi (B,M,C)``,
``dpfj (B,K,M,3+C)`` = ``[dp || fj]`` and ``idx (B,M,K)`` int32.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .geometry import ball_query, index_points, inv_radius, radius_sq

__all__ = ["ball_group_cuda", "ball_group_plain", "LAUNCHES"]

LAUNCHES = 0  # kernel launches of ball_group_cuda


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


@functools.cache
def _lib():
    lib = _build.load("ballgroup")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ball_group_launch.argtypes = [p, p, p, i, i, i, i, i, f, f, i,
                                      p, p, p, p, p]
    lib.ball_group_launch.restype = ctypes.c_int
    return lib


def _check_inputs(xyz, query_idx, feats):
    if torch.is_grad_enabled() and (xyz.requires_grad or feats.requires_grad):
        raise NotImplementedError(
            "the CUDA kernels have no backward yet: run them under "
            "torch.no_grad() or inference_mode()")
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
    if (feats.dtype != torch.float32 or feats.dim() != 3
            or feats.shape[:2] != (B, N)):
        raise ValueError(f"feats must be (B, N, C) float32, got "
                         f"{tuple(feats.shape)} {feats.dtype}")
    if (query_idx.dtype != torch.int32 or query_idx.dim() != 2
            or query_idx.shape[0] != B):
        raise ValueError(f"query_idx must be (B, M) int32, got "
                         f"{tuple(query_idx.shape)} {query_idx.dtype}")


def ball_group_cuda(radius: float, nsample: int, xyz: torch.Tensor,
                    query_idx: torch.Tensor, feats: torch.Tensor,
                    relative: bool = True, normalize_dp: bool = False):
    """The kernel on CUDA tensors; same outputs as :func:`ball_group_plain`.
    ``query_idx`` must lie in ``[0, N)``: checking it would cost a device
    sync on every launch, and the model only passes FPS indices."""
    global LAUNCHES
    _check_inputs(xyz, query_idx, feats)
    B, N, _ = xyz.shape
    M = query_idx.shape[1]
    C = feats.shape[2]
    K = int(nsample)
    if K < 1 or M < 1:
        raise ValueError(f"empty ball group: M={M} K={K}")
    dev = xyz.device
    new_xyz = torch.empty((B, M, 3), dtype=torch.float32, device=dev)
    fi = torch.empty((B, M, C), dtype=torch.float32, device=dev)
    dpfj = torch.empty((B, K, M, 3 + C), dtype=torch.float32, device=dev)
    idx = torch.empty((B, M, K), dtype=torch.int32, device=dev)
    scale = inv_radius(radius) if (relative and normalize_dp) else 1.0
    lib = _lib()
    err = lib.ball_group_launch(
        xyz.data_ptr(), query_idx.data_ptr(), feats.data_ptr(), B, N, M, C, K,
        radius_sq(radius), scale, int(bool(relative)), new_xyz.data_ptr(),
        fi.data_ptr(), dpfj.data_ptr(), idx.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "ball_group")
    LAUNCHES += 1
    return new_xyz, fi, dpfj, idx
