"""ScanObjectNN (hardest variant), the classification dataset of the cfgs.

Counterpart of ``adaptpoint_tpu/datasets/scanobjectnn.py`` (reference
openpoints/dataset/scanobjectnn/scanobjectnn.py:11-100): the h5 split, the
test split's FPS to 1024 points computed once and kept beside it as a
pickle, the train-time point shuffle and the height feature appended to
``x``. The data is not in the repository (``data_dir``).
"""
from __future__ import annotations

import logging
import os
import pickle

import numpy as np

from .build import DATASETS
from .data_util import load_h5_cached

__all__ = ["ScanObjectNNHardest", "SCANOBJECTNN_CLASSES"]

SCANOBJECTNN_CLASSES = [
    "bag", "bin", "box", "cabinet", "chair", "desk", "display", "door",
    "shelf", "table", "bed", "pillow", "sink", "sofa", "toilet",
]


class ClsPointsBase:
    """``get(idx, rng)``: the train split shuffles its points, then the
    transform, then ``x = [pos || height]`` (scanobjectnn.py:81-98)."""

    gravity_dim = 1
    classes = SCANOBJECTNN_CLASSES
    num_classes = 15

    def __len__(self) -> int:
        return self.points.shape[0]

    def get(self, idx: int, rng: np.random.Generator):
        current = np.array(self.points[idx][: self.num_points], np.float32)
        if self.split == "train":
            rng.shuffle(current)
        data = {"pos": current, "y": np.int64(self.labels[idx])}
        if self.transform is not None:
            data = self.transform(data, rng)
        if "heights" in data:
            data["x"] = np.concatenate([data["pos"], data["heights"]], axis=1)
        else:
            g = self.gravity_dim
            h = current[:, g:g + 1] - current[:, g:g + 1].min()
            data["x"] = np.concatenate([data["pos"], h], axis=1)
        data.pop("heights", None)
        return data


@DATASETS.register_module()
class ScanObjectNNHardest(ClsPointsBase):
    """PB_T50_RS: 11416 train / 2882 test clouds of 2048 points."""

    def __init__(self, data_dir: str, split: str, num_points: int = 2048,
                 uniform_sample: bool = True, transform=None, **kwargs):
        self.split = split
        self.num_points = num_points
        self.transform = transform
        name = "training" if split == "train" else "test"
        h5 = os.path.join(data_dir,
                          f"{name}_objectdataset_augmentedrot_scale75.h5")
        if not os.path.isfile(h5):
            raise FileNotFoundError(f"{h5} not found: download ScanObjectNN "
                                    f"first")
        self.points, self.labels = load_h5_cached(h5)
        if name == "test" and uniform_sample:
            pkl = os.path.join(
                data_dir,
                f"{name}_objectdataset_augmentedrot_scale75_1024_fps.pkl")
            if os.path.exists(pkl):
                with open(pkl, "rb") as f:
                    self.points = pickle.load(f)
            else:
                self.points = _fps_1024(self.points)
                with open(pkl, "wb") as f:
                    pickle.dump(self.points, f)
        logging.info("ScanObjectNN %s: %s", split, self.points.shape)


def _fps_1024(points: np.ndarray) -> np.ndarray:
    """The clouds' first 1024 FPS points, by the plain FPS on the CPU (a
    one-off at dataset build; the same indices as the kernel's)."""
    import torch
    from ..ops.geometry import furthest_point_sample, index_points
    pts = torch.from_numpy(np.array(points, np.float32))
    out = [index_points(c, furthest_point_sample(c[..., :3], 1024))
           for c in pts.split(256)]
    return torch.cat(out).numpy()
