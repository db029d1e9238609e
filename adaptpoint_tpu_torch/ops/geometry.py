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
           "fps_prefix_idx", "radius_sq", "inv_radius", "square_distance",
           "knn_point", "three_nn", "three_interpolate",
           "three_interpolation"]


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
    # the ball test is an f32 test whatever the inputs' type
    d2 = _sq_dist(new_xyz.float()[:, :, None, :],
                  xyz.float()[:, None, :, :])  # (B, M, N)
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


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distance in the expanded form
    ``|a|^2 + |b|^2 - 2ab``: src (B, N, C), dst (B, M, C) -> (B, N, M), f32."""
    src, dst = src.float(), dst.float()
    cross = torch.einsum("bnc,bmc->bnm", src, dst)
    s2 = (src ** 2).sum(dim=-1)[:, :, None]
    d2 = (dst ** 2).sum(dim=-1)[:, None, :]
    return s2 + d2 - 2.0 * cross


def knn_point(nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor):
    """The ``nsample`` nearest of xyz (B, N, C) to each of new_xyz (B, M, C).

    Returns ``(d2, idx)``, both (B, M, nsample), nearest first, ties to the
    lowest index (k passes of min / first argmin / mask, as the JAX package
    extracts them). A cloud smaller than ``nsample`` repeats its nearest."""
    N = xyz.shape[1]
    k_eff = min(nsample, N)
    cur = square_distance(new_xyz, xyz)
    lane = torch.arange(N, device=xyz.device)
    ds, idxs = [], []
    for _ in range(k_eff):
        d, i = torch.min(cur, dim=-1)
        # torch.min's index on ties is not specified: take the first
        i = torch.argmax((cur == d[..., None]).int(), dim=-1)
        ds.append(d)
        idxs.append(i)
        cur = torch.where(lane == i[..., None], torch.inf, cur)
    d2k = torch.stack(ds, dim=-1)
    idx = torch.stack(idxs, dim=-1).to(torch.int32)
    if k_eff < nsample:
        reps = nsample - k_eff
        idx = torch.cat([idx, idx[..., :1].expand(-1, -1, reps)], dim=-1)
        d2k = torch.cat([d2k, d2k[..., :1].expand(-1, -1, reps)], dim=-1)
    return d2k, idx


def three_nn(unknown: torch.Tensor, known: torch.Tensor):
    """3 nearest known (B, M, 3) points of each unknown (B, N, 3) point:
    euclidean distances (B, N, 3) and int32 indices (B, N, 3)."""
    d2, idx = knn_point(3, known, unknown)
    return torch.sqrt(torch.clamp(d2, min=0.0)), idx


def three_interpolate(features: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """features (B, M, C), idx (B, N, 3), weight (B, N, 3) -> (B, N, C)."""
    return (index_points(features, idx) * weight[..., None]).sum(dim=2)


def three_interpolation(unknown_xyz: torch.Tensor, known_xyz: torch.Tensor,
                        known_feat: torch.Tensor) -> torch.Tensor:
    """Feature-propagation upsampling: 3-NN, weights from reciprocal
    distances (eps 1e-8) normalised to sum 1."""
    dist, idx = three_nn(unknown_xyz, known_xyz)
    recip = 1.0 / (dist + 1e-8)
    weight = recip / recip.sum(dim=2, keepdim=True)
    return three_interpolate(known_feat, idx, weight)
