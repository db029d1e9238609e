"""S3DIS scene segmentation: the ``S3DIS`` rooms and the ``SyntheticScene``
stand-in.

Counterpart of ``adaptpoint_tpu/datasets/s3dis.py`` ``S3DIS`` and
``SyntheticScene`` (reference openpoints/dataset/s3dis/s3dis.py:12-146):
per-room ``.npy`` files (x, y, z, r, g, b, label) under ``<data_root>/raw``,
the test area held out for validation, each item voxel-cropped to
``voxel_max`` points (``data_util.crop_pc``), colours as ``x`` and the
gravity axis as ``heights``. A sample draws from the generator it is given
in the JAX package's order, so the two packages give the same batches. The
sphere-sampled ``S3DISSphere`` is not ported yet.
"""
from __future__ import annotations

import logging
import os
import os.path as osp
from typing import Optional

import numpy as np

from .build import DATASETS
from .data_util import crop_pc

__all__ = ["S3DIS", "SyntheticScene", "S3DIS_CLASSES",
           "S3DIS_NUM_PER_CLASS"]

S3DIS_CLASSES = ["ceiling", "floor", "wall", "beam", "column", "window",
                 "door", "chair", "table", "bookcase", "sofa", "board",
                 "clutter"]
S3DIS_NUM_PER_CLASS = np.array(
    [3370714, 2856755, 4919229, 318158, 375640, 478001, 974733, 650464,
     791496, 88727, 1284130, 229758, 2272837], dtype=np.int64)


@DATASETS.register_module()
class S3DIS:
    """Rooms of the S3DIS areas, voxel-cropped per item (parity: s3dis.py
    S3DIS). ``split`` train takes every area but ``test_area``; any other
    split takes ``test_area``. ``loop`` repeats the rooms an epoch."""

    classes = S3DIS_CLASSES
    num_classes = 13
    num_per_class = S3DIS_NUM_PER_CLASS
    gravity_dim = 2

    def __init__(self, data_root: str = "data/S3DIS/s3disfull",
                 test_area: int = 5, voxel_size: float = 0.04,
                 voxel_max: Optional[int] = 24000, split: str = "train",
                 transform=None, loop: int = 1, presample: bool = False,
                 variable: bool = False, shuffle: bool = True, **kwargs):
        self.split = "train" if split == "train" else "val"
        self.voxel_size = voxel_size
        self.voxel_max = voxel_max
        self.transform = transform
        self.loop = loop
        self.shuffle = shuffle
        raw_root = osp.join(data_root, "raw")
        if not osp.isdir(raw_root):
            raise FileNotFoundError(f"{raw_root} not found: download S3DIS "
                                    f"first")
        names = sorted(x[:-4] for x in os.listdir(raw_root) if "Area_" in x)
        area = f"Area_{test_area}"
        names = [x for x in names if (area not in x) == (split == "train")]
        self.raw_root = raw_root
        self.data_list = names
        logging.info("S3DIS %s: %d rooms", split, len(names))

    def __len__(self):
        return len(self.data_list) * self.loop

    def get(self, idx: int, rng: np.random.Generator):
        name = self.data_list[idx % len(self.data_list)]
        cdata = np.load(osp.join(self.raw_root, name + ".npy")).astype(
            np.float32)
        cdata[:, :3] -= cdata[:, :3].min(0)
        coord, feat, label = cdata[:, :3], cdata[:, 3:6], cdata[:, 6:7]
        coord, feat, label = crop_pc(
            coord, feat, label.reshape(-1), self.split, self.voxel_size,
            self.voxel_max, downsample=True, shuffle=self.shuffle, rng=rng)
        data = {"pos": coord, "x": feat, "y": label}
        if self.transform is not None:
            data = self.transform(data, rng)
        if "heights" not in data:
            g = self.gravity_dim
            data["heights"] = data["pos"][:, g:g + 1].astype(np.float32)
        return data


@DATASETS.register_module()
class SyntheticScene:
    """A synthetic room for scene segmentation without data (parity:
    s3dis.py SyntheticScene): ``num_points`` points in a 4 x 4 x 3 box, the
    label the height's quarter (four classes), the colour that label's."""

    classes = S3DIS_CLASSES[:4]
    num_classes = 4
    gravity_dim = 2

    def __init__(self, split="train", num_points=256, size=16, transform=None,
                 seed=0, **kwargs):
        self.split = split
        self.num_points = num_points
        self.size = size
        self.transform = transform
        self.seed = seed

    def __len__(self):
        return self.size

    def get(self, idx: int, rng: np.random.Generator):
        n = self.num_points
        pos = rng.random((n, 3)).astype(np.float32) * [4, 4, 3]
        y = np.clip((pos[:, 2] / 3.0 * 4).astype(np.int64), 0, 3)
        rgb = (np.eye(4)[y][:, :3] * 255).astype(np.float32)
        data = {"pos": pos, "x": rgb, "y": y}
        if self.transform is not None:
            data = self.transform(data, rng)
        data["heights"] = data["pos"][:, 2:3].astype(np.float32)
        return data
