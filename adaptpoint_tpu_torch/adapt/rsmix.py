"""RSMix: rigid-subset CutMix for point clouds, on the host in numpy.

Counterpart of ``adaptpoint_tpu/adapt/rsmix.py`` (reference
openpoints/online_aug/rsmix_provider.py:63-221), kept as a copy: a
Beta(beta, beta) cut radius, a random pairing permutation, the ball (within
the radius, the first ``n_sample`` in index order) or kNN subsets around a
random query point of each cloud, the erased subset replaced by as many
points of the partner's subset moved by the query offset, and lambda the
share of points replaced. The same ``np.random.Generator`` gives the same
mixed batch as the JAX package's function; the batch then goes to the
device once.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np

__all__ = ["rsmix"]


def _ball_subset(xyz: np.ndarray, query: np.ndarray, radius: float,
                 nsample: int) -> np.ndarray:
    """Indices with d2 <= radius^2 in ascending index order, capped at
    nsample; empty -> empty array (reference uses sentinel N)."""
    d2 = ((xyz - query) ** 2).sum(-1)
    idx = np.nonzero(d2 <= radius * radius)[0]
    return idx[:nsample]


def _knn_subset(xyz: np.ndarray, query: np.ndarray, k: int) -> np.ndarray:
    d2 = ((xyz - query) ** 2).sum(-1)
    return np.argpartition(d2, min(k, len(d2) - 1))[:k]


def _ctrl_count(erase_idx: np.ndarray, add_idx: np.ndarray,
                rng: np.random.Generator) -> np.ndarray:
    """Resize add_idx to len(erase_idx) (parity: pts_num_ctrl,
    rsmix_provider.py:146-161)."""
    ne, na = len(erase_idx), len(add_idx)
    if ne >= na:
        if ne == na:
            return add_idx
        extra = add_idx[rng.integers(0, na, size=ne - na)]
        return np.append(add_idx, extra)
    return np.sort(rng.choice(add_idx, size=ne, replace=False))


def rsmix(data_batch: np.ndarray, label_batch: np.ndarray, beta: float = 1.0,
          n_sample: int = 512, knn: bool = False,
          rng: np.random.Generator = None
          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """data (B,N,C) with xyz in [...,:3]; labels (B,).

    Returns (mixed (B,N,C), lam (B,), label_a (B,), label_b (B,)).
    """
    rng = rng or np.random.default_rng()
    B, N, C = data_batch.shape
    cut_rad = rng.beta(beta, beta)
    perm = rng.choice(B, B, replace=False)
    label_a = np.asarray(label_batch).reshape(-1)
    label_b = label_a[perm]
    data_rand = data_batch[perm]

    idx1 = rng.integers(0, N, B)
    idx2 = rng.integers(0, N, B)
    out = np.empty_like(data_batch)
    lam = np.zeros(B, np.float32)
    k = min(int(math.ceil(cut_rad * n_sample)), n_sample)

    for i in range(B):
        q1 = data_batch[i, idx1[i], :3]
        q2 = data_rand[i, idx2[i], :3]
        if knn:
            erase = _knn_subset(data_batch[i, :, :3], q1, k)
            add = _knn_subset(data_rand[i, :, :3], q2, k)
        else:
            erase = _ball_subset(data_batch[i, :, :3], q1, cut_rad, n_sample)
            add = _ball_subset(data_rand[i, :, :3], q2, cut_rad, n_sample)

        if len(erase) == 0:
            out[i] = data_batch[i]
            lam[i] = 0.0
            continue
        erase = np.unique(erase)
        if len(add) == 0:
            kept = np.delete(data_batch[i], erase, axis=0)
            dup = data_batch[i][rng.integers(0, len(kept), size=len(erase))]
            out[i] = np.concatenate([kept, dup], axis=0)
            lam[i] = 0.0
            continue
        add = np.unique(add)
        add_ctrl = _ctrl_count(erase, add, rng)
        kept = np.delete(data_batch[i], erase, axis=0)
        to_add = data_rand[i][add_ctrl].copy()
        to_add[:, :3] = to_add[:, :3] + (q1 - q2)
        out[i] = np.concatenate([kept, to_add], axis=0)
        lam[i] = len(add_ctrl) / (len(add_ctrl) + len(kept))
    return out, lam, label_a, label_b
