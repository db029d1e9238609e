"""Point-cloud geometry primitives: the plain PyTorch versions.

Counterpart of ``adaptpoint_tpu/ops/geometry.py``. These are the reference
semantics every kernel of the port is held to, and what the dispatching ops
run on a CPU tensor. Layout is channels-last: points ``(B, N, 3)``, features
``(B, N, C)``.

Distances are written out as ``dx*dx + dy*dy + dz*dz`` in separate
elementwise ops, so each product and sum rounds on its own in float32: the
same arithmetic as the reference CUDA kernels and the JAX package, which the
strict ``d2 < r*r`` ball test and the first-occurrence FPS argmax depend on.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["index_points", "furthest_point_sample", "ball_query",
           "fps_prefix_idx", "radius_sq", "inv_radius"]


def radius_sq(radius: float) -> float:
    """``f32(r) * f32(r)`` rounded in float32 (not a double square)."""
    r = np.float32(radius)
    return float(r * r)


def inv_radius(radius: float) -> float:
    """``f32(1/r)``: the reciprocal taken in double, then rounded to f32."""
    return float(np.float32(1.0 / radius))


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Direct-form squared distance over the last axis (size 3)."""
    dx = a[..., 0] - b[..., 0]
    dy = a[..., 1] - b[..., 1]
    dz = a[..., 2] - b[..., 2]
    return dx * dx + dy * dy + dz * dz


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (B, N, C), idx (B, ...) int -> (B, ..., C)."""
    B, C = points.shape[0], points.shape[-1]
    flat = idx.reshape(B, -1).long()
    out = torch.gather(points, 1, flat[..., None].expand(-1, -1, C))
    return out.reshape(tuple(idx.shape) + (C,))


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Iterative furthest point sampling. xyz (B, N, 3) -> idx (B, npoint) int32.

    The first index is 0; the running min-distance starts at 1e10; each step
    takes the first index of the maximum (``torch.argmax`` returns the first
    occurrence, as ``jnp.argmax`` and the reference ``sampling_gpu.cu`` do).
    """
    B, N, _ = xyz.shape
    x = xyz.float()
    out = torch.zeros((B, npoint), dtype=torch.int32, device=xyz.device)
    mind = torch.full((B, N), 1e10, dtype=torch.float32, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    last = torch.zeros(B, dtype=torch.long, device=xyz.device)
    for j in range(1, npoint):
        sel = x[rows, last][:, None, :]  # (B, 1, 3)
        mind = torch.minimum(mind, _sq_dist(x, sel))
        last = torch.argmax(mind, dim=1)
        out[:, j] = last.to(torch.int32)
    return out


def ball_query(radius: float, nsample: int, xyz: torch.Tensor,
               new_xyz: torch.Tensor) -> torch.Tensor:
    """First ``nsample`` support points with ``d2 < f32(r)**2`` in index order.

    Empty slots repeat the first in-ball index; an empty ball gives index 0
    (the reference ``ball_query_gpu.cu`` memset rule).
    xyz (B, N, 3), new_xyz (B, M, 3) -> idx (B, M, nsample) int32.
    """
    N = xyz.shape[1]
    d2 = _sq_dist(new_xyz[:, :, None, :], xyz[:, None, :, :])  # (B, M, N)
    inball = d2 < radius_sq(radius)
    ar = torch.arange(N, device=xyz.device).expand_as(d2)
    key = torch.where(inball, ar, ar + N)
    k_eff = min(nsample, N)
    kkey = torch.topk(key, k_eff, dim=-1, largest=False, sorted=True).values
    idx = torch.where(kkey < N, kkey, kkey - N)
    first = idx[..., :1]
    out = torch.where(kkey < N, idx, first)
    if k_eff < nsample:
        out = torch.cat([out, first.expand(-1, -1, nsample - k_eff)], dim=-1)
    return out.to(torch.int32)


def fps_prefix_idx(batch: int, npoint: int, device) -> torch.Tensor:
    """FPS of a cloud already in FPS selection order is the identity prefix.

    FPS is greedy, so every encoder stage after the first subsample receives
    its points in selection order and re-selects ``arange(npoint)``
    (counterpart: ``adaptpoint_tpu/ops/__init__.py`` ``fps_prefix_idx``).
    """
    return torch.arange(npoint, dtype=torch.int32,
                        device=device).expand(batch, npoint)
