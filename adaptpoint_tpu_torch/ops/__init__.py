"""Dispatching op layer: the CUDA kernels for CUDA tensors, plain PyTorch for CPU ones.

Counterpart of ``adaptpoint_tpu/ops/__init__.py``. The tensor's device is
the only thing that selects a branch: a CUDA tensor launches the kernel (or
the wrapper raises), a CPU tensor runs the plain version. There is no
environment switch, no work threshold and no fallback.
"""
from __future__ import annotations

import torch

from . import ballgroup, fps, saeval
from .ballgroup import ball_group_plain
from .geometry import (ball_query, fps_prefix_idx, index_points,
                       furthest_point_sample as furthest_point_sample_plain)
from .saeval import sa_eval_plain

__all__ = ["furthest_point_sample", "ball_group", "sa_eval", "ball_query",
           "index_points", "fps_prefix_idx", "launch_counts",
           "reset_launch_counts", "KERNEL_MODULES"]

# name -> module holding the wrapper and its LAUNCHES counter
KERNEL_MODULES = {"fps": fps, "ball_group": ballgroup, "sa_eval": saeval}


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """xyz (B, N, 3) -> idx (B, npoint) int32 (semantics: ``geometry``)."""
    if _on_cuda(xyz):
        return fps.furthest_point_sample_cuda(xyz.contiguous(), npoint)
    return furthest_point_sample_plain(xyz, npoint)


def ball_group(radius: float, nsample: int, xyz, query_idx, feats,
               relative: bool = True, normalize_dp: bool = False):
    """(new_xyz (B,M,3), fi (B,M,C), dpfj (B,K,M,3+C), idx (B,M,K))."""
    if _on_cuda(xyz):
        return ballgroup.ball_group_cuda(
            radius, nsample, xyz.contiguous(), query_idx.int().contiguous(),
            feats.contiguous(), relative, normalize_dp)
    return ball_group_plain(radius, nsample, xyz, query_idx, feats, relative,
                            normalize_dp)


def sa_eval(radius: float, nsample: int, xyz, query_idx, feats, w1, b1, w2,
            b2, relative: bool = True, normalize_dp: bool = False,
            packed=None):
    """Fused eval SA stage: (new_xyz, fi = bf16(f), out (B,M,cout)).
    ``packed`` (``saeval.pack_weights`` of the same weights) spares the
    kernel's weight packing on CUDA."""
    if _on_cuda(xyz):
        return saeval.sa_eval_cuda(
            radius, nsample, xyz.contiguous(), query_idx.int().contiguous(),
            feats.contiguous(), w1, b1, w2, b2, relative, normalize_dp,
            packed)
    return sa_eval_plain(radius, nsample, xyz, query_idx, feats, w1, b1, w2,
                         b2, relative, normalize_dp)


def launch_counts() -> dict:
    """Kernel launches so far, by kernel name."""
    return {name: mod.LAUNCHES for name, mod in KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    for mod in KERNEL_MODULES.values():
        mod.LAUNCHES = 0
