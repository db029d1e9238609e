"""In-memory fake-cloud dataset built from one epoch of generator outputs.

Counterpart of ``adaptpoint_tpu/adapt/form_dataset.py`` ``FormDatasetCls``.
It holds numpy arrays on the host, as the reference's epoch buffer does;
samples are served unchanged (no transform, no shuffle).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

__all__ = ["FormDatasetCls", "Form_dataset_cls"]


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


Form_dataset_cls = FormDatasetCls  # the reference's name
