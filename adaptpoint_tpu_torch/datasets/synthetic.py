"""Synthetic datasets (no download): ``SyntheticCls`` and
``SyntheticPartSeg``.

Counterpart of ``adaptpoint_tpu/datasets/synthetic.py``: each class is a
parametric shape family (sphere shell, box surface, cylinder, plane, cross
of lines) with a stretch per group of five classes and per-point noise,
drawn once from ``default_rng((seed, split))``, so a model can fit it.
``SyntheticPartSeg`` lays four such categories out as ShapeNetPart does:
each owns two part labels, the two halves of the cloud along x.
"""
from __future__ import annotations

import numpy as np

from .build import DATASETS
from .scanobjectnn import ClsPointsBase

__all__ = ["SyntheticCls", "SyntheticPartSeg"]


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


@DATASETS.register_module()
class SyntheticPartSeg:
    """Four shape categories, part label ``2 * category + (x > 0)``; the
    samples carry ``pos``, ``y``, ``cls`` and ``x = [pos || height]``."""

    classes = [f"class{i}" for i in range(4)]
    cls2parts = [[0, 1], [2, 3], [4, 5], [6, 7]]
    num_classes = 8  # part labels
    gravity_dim = 1

    def __init__(self, split: str = "train", num_points: int = 128,
                 size: int = 32, transform=None, seed: int = 0, **kwargs):
        self.split = split
        self.num_points = num_points
        self.transform = transform
        rng = np.random.default_rng((seed, 0 if split == "train" else 1))
        self.labels = np.arange(size) % 4
        self.points = np.stack([_make_cloud(rng, int(c), num_points)
                                for c in self.labels])

    def __len__(self):
        return self.points.shape[0]

    def get(self, idx: int, rng: np.random.Generator):
        pc = np.array(self.points[idx], np.float32)
        cls = int(self.labels[idx])
        seg = (pc[:, 0] > 0).astype(np.int64) + self.cls2parts[cls][0]
        data = {"pos": pc, "y": seg, "cls": np.int64(cls)}
        if self.transform is not None:
            data = self.transform(data, rng)
        if "heights" not in data:
            g = self.gravity_dim
            data["heights"] = (pc[:, g:g + 1]
                               - pc[:, g:g + 1].min()).astype(np.float32)
        data["x"] = np.concatenate([data["pos"], data["heights"]], axis=1)
        data.pop("heights", None)
        return data
