"""Dispatching op layer: the CUDA kernels for CUDA tensors, plain PyTorch for CPU ones.

Counterpart of ``adaptpoint_tpu/ops/__init__.py``. The tensor's device is
the only thing that selects a branch: a CUDA tensor launches the kernel (or
the wrapper raises), a CPU tensor runs the plain version. There is no
environment switch, no work threshold and no fallback.
"""
from __future__ import annotations

import torch

from . import ballgroup, fpsample, gather, saeval
from .ballgroup import ball_group_plain
from .gather import gather_rows_plain
from .geometry import (ball_query, fps_prefix_idx, index_points, knn_point,
                       square_distance, three_interpolation, three_nn,
                       furthest_point_sample as furthest_point_sample_plain)
from .saeval import sa_eval_plain

__all__ = ["furthest_point_sample", "ball_group", "sa_eval", "gather_rows",
           "fps", "ball_query", "index_points", "fps_prefix_idx",
           "square_distance", "knn_point", "three_nn", "three_interpolation",
           "launch_counts", "reset_launch_counts", "KERNEL_MODULES"]

# kernel name -> (module holding its wrapper, name of its launch counter)
KERNEL_MODULES = {"fps": (fpsample, "LAUNCHES"),
                  "ball_group": (ballgroup, "LAUNCHES"),
                  "ball_group_bwd": (ballgroup, "LAUNCHES_BWD"),
                  "sa_eval": (saeval, "LAUNCHES"),
                  "gather_rows": (gather, "LAUNCHES"),
                  "gather_rows_bwd": (gather, "LAUNCHES_BWD")}


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """xyz (B, N, 3) -> idx (B, npoint) int32 (semantics: ``geometry``).
    Indices carry no gradient: the input is detached first."""
    xyz = xyz.detach()
    if _on_cuda(xyz):
        return fpsample.furthest_point_sample_cuda(xyz.contiguous(), npoint)
    return furthest_point_sample_plain(xyz, npoint)


def ball_group(radius: float, nsample: int, xyz, query_idx, feats,
               relative: bool = True, normalize_dp: bool = False):
    """(new_xyz (B,M,3), fi (B,M,C), dpfj (B,K,M,3+C), idx (B,M,K)).
    Differentiable in ``xyz`` and ``feats`` on both devices: the backward
    kernel on CUDA, PyTorch's autograd of the plain version on the CPU."""
    if _on_cuda(xyz):
        return ballgroup.BallGroup.apply(
            xyz.contiguous(), query_idx.int().contiguous(),
            feats.contiguous(), float(radius), int(nsample), bool(relative),
            bool(normalize_dp))
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


def gather_rows(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Exact row gather: points (B, N, C) f32 or bf16, idx (B, M) int ->
    (B, M, C); its gradient is the scatter-add onto the gathered rows."""
    if _on_cuda(points):
        return gather.GatherRows.apply(points.contiguous(),
                                       idx.int().contiguous())
    return gather_rows_plain(points, idx)


def fps(data: torch.Tensor, number: int) -> torch.Tensor:
    """FPS on ``data[..., :3]`` then the row gather: (B, N, C) -> (B, number, C)."""
    idx = furthest_point_sample(data[..., :3], number)
    return gather_rows(data, idx)


def launch_counts() -> dict:
    """Kernel launches so far, by kernel name."""
    return {name: getattr(mod, attr)
            for name, (mod, attr) in KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    for mod, attr in KERNEL_MODULES.values():
        setattr(mod, attr, 0)
