"""In-memory fake-cloud datasets built from one epoch of generator outputs.

Counterpart of ``adaptpoint_tpu/adapt/form_dataset.py`` (``FormDatasetCls``
for classification, ``FormDatasetShapeNet`` for part segmentation). They
hold numpy arrays on the host, as the reference's epoch buffer does;
samples are served unchanged (no transform, no shuffle).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

__all__ = ["FormDatasetCls", "FormDatasetShapeNet", "Form_dataset_cls",
           "Form_dataset_shapenet"]


class FormDatasetCls:
    def __init__(self, pointcloud: Sequence[np.ndarray],
                 label: Sequence[np.ndarray],
                 x: Optional[Sequence[np.ndarray]] = None):
        self.pointcloud = np.concatenate(pointcloud)
        self.label = np.concatenate(label)
        self.x = np.concatenate(x) if x is not None else None
        if self.pointcloud.shape[0] != self.label.shape[0]:
            raise ValueError(f"{self.pointcloud.shape[0]} clouds but "
                             f"{self.label.shape[0]} labels")

    def __len__(self):
        return self.pointcloud.shape[0]

    def get(self, idx: int, rng=None):
        data = {"pos": self.pointcloud[idx], "y": np.int64(self.label[idx])}
        if self.x is not None:
            data["x"] = self.x[idx]
        return data


class FormDatasetShapeNet:
    """An epoch's fake part-segmentation clouds: ``pos`` (the generator's
    clouds), ``y`` (part labels), ``heights`` and ``cls`` of the real batches
    they came from, each a sequence of per-batch arrays."""

    def __init__(self, pos: Sequence[np.ndarray], y: Sequence[np.ndarray],
                 heights: Sequence[np.ndarray], cls: Sequence[np.ndarray]):
        self.pos = np.concatenate(pos)
        self.y = np.concatenate(y)
        self.heights = np.concatenate(heights)
        self.cls = np.concatenate(cls)
        if self.pos.shape[0] != self.y.shape[0]:
            raise ValueError(f"{self.pos.shape[0]} clouds but "
                             f"{self.y.shape[0]} label rows")

    def __len__(self):
        return self.pos.shape[0]

    def get(self, idx: int, rng=None):
        return {"pos": self.pos[idx], "y": self.y[idx],
                "heights": self.heights[idx], "cls": self.cls[idx]}


# the reference's names
Form_dataset_cls = FormDatasetCls
Form_dataset_shapenet = FormDatasetShapeNet
