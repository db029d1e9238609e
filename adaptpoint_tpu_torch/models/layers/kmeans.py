"""Batched k-means (Lloyd iterations) for the k-means patch embedding.

Counterpart of ``adaptpoint_tpu/models/layers/kmeans.py``: centroids seeded
by FPS over the first three dims (all of them below three), then a fixed
number of iterations of nearest-centroid assignment (``argmin`` of the
expanded-form squared distance, ties to the lowest index) and the mean of
each cluster (its count floored at 1, so an empty cluster goes to the
origin). The FPS and the seeding gather are the kernels on CUDA tensors
(rows 1 and 14); the iterations are plain PyTorch on either device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ... import ops
from ...ops.geometry import square_distance

__all__ = ["kmeans"]


def kmeans(points: torch.Tensor, n_clusters: int, n_iters: int = 10):
    """points (B, N, C) -> (assignments (B, N) int32, centroids (B, K, C))."""
    seed_space = points[..., :3] if points.shape[-1] >= 3 else points
    init_idx = ops.furthest_point_sample(seed_space, n_clusters)
    centroids = ops.index_points(points, init_idx)  # (B, K, C)
    for _ in range(int(n_iters)):
        assign = square_distance(points, centroids).argmin(dim=-1)
        onehot = F.one_hot(assign, n_clusters).to(points.dtype)  # (B, N, K)
        num = torch.einsum("bnk,bnc->bkc", onehot, points)
        den = onehot.sum(dim=1)[..., None].clamp(min=1.0)
        centroids = num / den
    assign = square_distance(points, centroids).argmin(dim=-1)
    return assign.to(torch.int32), centroids
