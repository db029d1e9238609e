"""Synthetic classification dataset (no download): ``SyntheticCls``.

Counterpart of ``adaptpoint_tpu/datasets/synthetic.py``: each class is a
parametric shape family (sphere shell, box surface, cylinder, plane, cross
of lines) with a stretch per group of five classes and per-point noise,
drawn once from ``default_rng((seed, split))``, so a model can fit it.
"""
from __future__ import annotations

import numpy as np

from .build import DATASETS
from .scanobjectnn import ClsPointsBase

__all__ = ["SyntheticCls"]


def _make_cloud(rng: np.random.Generator, cls: int,
                num_points: int) -> np.ndarray:
    t = rng.random((num_points, 3)).astype(np.float32) * 2 - 1
    k = cls % 5
    if k == 0:  # sphere shell
        p = t / (np.linalg.norm(t, axis=1, keepdims=True) + 1e-6)
    elif k == 1:  # box surface
        ax = rng.integers(0, 3, num_points)
        p = t.copy()
        p[np.arange(num_points), ax] = np.sign(p[np.arange(num_points), ax])
    elif k == 2:  # cylinder
        p = t.copy()
        n = np.linalg.norm(p[:, :2], axis=1, keepdims=True) + 1e-6
        p[:, :2] /= n
    elif k == 3:  # plane
        p = t.copy()
        p[:, 2] *= 0.05
    else:  # cross of lines
        p = t * np.eye(3)[rng.integers(0, 3, num_points)]
    # a stretch per group of five classes survives unit-sphere normalisation
    stretch = np.array([1.0, 1.0 / (1.0 + 0.7 * (cls // 5)), 1.0], np.float32)
    return (p * stretch
            + rng.standard_normal((num_points, 3)).astype(np.float32) * 0.02)


@DATASETS.register_module()
class SyntheticCls(ClsPointsBase):
    def __init__(self, split: str = "train", num_points: int = 1024,
                 num_classes: int = 15, size: int = 64, transform=None,
                 seed: int = 0, **kwargs):
        self.split = split
        self.num_points = num_points
        self.num_classes = num_classes
        self.transform = transform
        rng = np.random.default_rng((seed, 0 if split == "train" else 1))
        self.labels = np.arange(size) % num_classes
        self.points = np.stack([_make_cloud(rng, int(c), num_points)
                                for c in self.labels])
        self.classes = [f"class{i}" for i in range(num_classes)]
