"""S3DIS scene segmentation: the ``S3DIS`` rooms, the sphere-sampled
``S3DISSphere`` areas and the ``SyntheticScene`` stand-in.

Counterpart of ``adaptpoint_tpu/datasets/s3dis.py`` (reference
openpoints/dataset/s3dis/s3dis.py:12-146 and s3dis_sphere.py:15-348):
per-room ``.npy`` files (x, y, z, r, g, b, label) under ``<data_root>/raw``,
the test area held out for validation, each item voxel-cropped to
``voxel_max`` points (``data_util.crop_pc``), colours as ``x`` and the
gravity axis as ``heights``. A sample draws from the generator it is given
in the JAX package's order, so the two packages give the same batches.
``S3DISSphere`` takes one grid-subsampled cloud per area and serves spheres
from a schedule fixed at construction (the host kd-tree,
``ops.cpu.KDTree``).
"""
from __future__ import annotations

import logging
import os
import os.path as osp
from typing import Optional

import numpy as np

from ..ops.cpu.kdtree_knn import KDTree
from .build import DATASETS
from .data_util import crop_pc

__all__ = ["S3DIS", "S3DISSphere", "SyntheticScene", "S3DIS_CLASSES",
           "S3DIS_NUM_PER_CLASS", "S3DIS_CMAP"]

S3DIS_CLASSES = ["ceiling", "floor", "wall", "beam", "column", "window",
                 "door", "chair", "table", "bookcase", "sofa", "board",
                 "clutter"]
S3DIS_NUM_PER_CLASS = np.array(
    [3370714, 2856755, 4919229, 318158, 375640, 478001, 974733, 650464,
     791496, 88727, 1284130, 229758, 2272837], dtype=np.int64)
# each class's colour in the visualisation dumps (s3dis_sphere.py:34-47)
S3DIS_CMAP = np.array(
    [[0, 255, 0], [0, 0, 255], [0, 255, 255], [255, 255, 0], [255, 0, 255],
     [100, 100, 255], [200, 200, 100], [255, 0, 0], [170, 120, 200],
     [10, 200, 100], [200, 100, 100], [200, 200, 200], [50, 50, 50]],
    dtype=np.uint8)


@DATASETS.register_module()
class S3DIS:
    """Rooms of the S3DIS areas, voxel-cropped per item (parity: s3dis.py
    S3DIS). ``split`` train takes every area but ``test_area``; any other
    split takes ``test_area``. ``loop`` repeats the rooms an epoch."""

    classes = S3DIS_CLASSES
    num_classes = 13
    num_per_class = S3DIS_NUM_PER_CLASS
    cmap = S3DIS_CMAP
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


@DATASETS.register_module()
class S3DISSphere:
    """Spheres of the S3DIS areas on a min-potential schedule (parity:
    s3dis.py S3DISSphere, reference s3dis_sphere.py:15-348).

    Each area's rooms form one cloud, grid-subsampled by ``crop_pc`` and
    cached as ``<data_root>/processed/<area>_<voxel>_sphere.npz`` with the
    projection of every original point onto its nearest subsampled one.
    The schedule of ``num_epochs * num_steps`` spheres is drawn at
    construction from ``default_rng(seed)``: the center is the point of
    least potential, moved by gaussian noise of ``in_radius / 10``; the
    sphere is its ``num_points`` nearest subsampled points within
    ``in_radius`` (``KDTree.query_radius``), whose potentials then grow by
    Tukey weights. ``get`` pads a short sphere by resampling its points
    (``mask`` marks the real ones) and returns ``cloud_index`` and
    ``input_inds`` for the vote of ``validate_sphere``. The split ``train``
    takes every area but Area_5; any other split takes Area_5, whatever the
    cfg's ``test_area``, as the JAX package does."""

    classes = S3DIS_CLASSES
    num_classes = 13
    num_per_class = S3DIS_NUM_PER_CLASS
    color_mean = np.array([0.5136457, 0.49523646, 0.44921124])
    color_std = np.array([0.18308958, 0.18415008, 0.19252081])
    cmap = S3DIS_CMAP
    gravity_dim = 2

    def __init__(self, data_root: str = "data/S3DIS/s3disfull",
                 voxel_size: float = 0.04, in_radius: float = 2.0,
                 num_points: int = 16384, num_steps: int = 500,
                 num_epochs: int = 100, split: str = "train",
                 transform=None, seed: int = 0, **kwargs):
        self.split = "train" if split == "train" else "val"
        self.in_radius = in_radius
        self.num_points = num_points
        self.num_steps = num_steps
        self.transform = transform
        self.epoch = 0
        raw_root = osp.join(data_root, "raw")
        if not osp.isdir(raw_root):
            raise FileNotFoundError(f"{raw_root} not found: download S3DIS "
                                    f"first")
        names = sorted(x[:-4] for x in os.listdir(raw_root) if "Area_" in x)
        areas = sorted({n.split("_room")[0].split("_office")[0][:6]
                        for n in names})
        # one cloud per area (reference lines 79-147); validation is Area_5
        self._area_names = [a for a in areas
                            if (a == "Area_5") != (self.split == "train")]
        self.clouds_points, self.clouds_colors, self.clouds_labels = [], [], []
        self.sub_points, self.sub_colors, self.sub_labels = [], [], []
        self.sub_trees, self.projections = [], []
        cache_dir = osp.join(data_root, "processed")
        os.makedirs(cache_dir, exist_ok=True)
        for area in self._area_names:
            cache = osp.join(cache_dir, f"{area}_{voxel_size:.3f}_sphere.npz")
            if osp.isfile(cache):
                z = np.load(cache)
                pts, rgb, lab = z["pts"], z["rgb"], z["lab"]
                spts, srgb, slab, proj = (z["spts"], z["srgb"], z["slab"],
                                          z["proj"])
            else:
                rooms = [n for n in names if n.startswith(area)]
                cloud = np.concatenate(
                    [np.load(osp.join(raw_root, r + ".npy")).astype(
                        np.float32) for r in rooms], 0)
                pts, rgb = cloud[:, :3], cloud[:, 3:6]
                lab = cloud[:, 6].astype(np.int32)
                spts, srgb, slab = crop_pc(
                    pts, rgb, lab, "train", voxel_size, None, downsample=True,
                    shuffle=False, rng=np.random.default_rng(seed))
                proj = KDTree(spts[:, :3]).query(pts, 1)[0][:, 0]
                np.savez(cache, pts=pts, rgb=rgb, lab=lab, spts=spts,
                         srgb=srgb, slab=slab, proj=proj)
            self.clouds_points.append(pts)
            self.clouds_colors.append(rgb)
            self.clouds_labels.append(lab)
            self.sub_points.append(np.asarray(spts[:, :3], np.float32))
            self.sub_colors.append(np.asarray(srgb, np.float32))
            self.sub_labels.append(np.asarray(slab, np.int64).reshape(-1))
            self.sub_trees.append(KDTree(self.sub_points[-1]))
            self.projections.append(np.asarray(proj, np.int64))
        self._build_schedule(num_epochs, seed)
        logging.info("S3DISSphere %s: %d areas, %d steps/epoch", split,
                     len(self._area_names), num_steps)

    def _build_schedule(self, num_epochs: int, seed: int):
        """The min-potential sphere schedule (s3dis_sphere.py:204-252),
        drawn in the JAX package's order."""
        rng = np.random.default_rng(seed)
        potentials = [rng.random(p.shape[0]) * 1e-3 for p in self.sub_points]
        self.cloud_inds, self.point_inds, self.noise = [], [], []
        r2 = self.in_radius ** 2
        for _ in range(num_epochs * self.num_steps):
            ci = int(np.argmin([p.min() for p in potentials]))
            pi = int(np.argmin(potentials[ci]))
            noise = rng.normal(scale=self.in_radius / 10, size=3)
            self.cloud_inds.append(ci)
            self.point_inds.append(pi)
            self.noise.append(noise.astype(np.float32))
            pick = self.sub_points[ci][pi] + noise
            q = self.sub_trees[ci].query_radius(pick, self.in_radius,
                                                self.num_points)
            d2 = ((self.sub_points[ci][q] - pick) ** 2).sum(-1)
            tukey = np.square(1 - d2 / r2)
            tukey[d2 > r2] = 0
            potentials[ci][q] += tukey

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return self.num_steps

    def get(self, idx: int, rng: np.random.Generator):
        step = (idx + self.epoch * self.num_steps) % len(self.cloud_inds)
        ci, pi = self.cloud_inds[step], self.point_inds[step]
        pick = self.sub_points[ci][pi] + self.noise[step]
        q = self.sub_trees[ci].query_radius(pick, self.in_radius,
                                            self.num_points)
        n_real = q.shape[0]
        if n_real < self.num_points:
            pad = rng.choice(n_real, self.num_points - n_real)
            q = np.concatenate([q, q[pad]])
        order = rng.permutation(self.num_points)
        q = q[order]
        mask = (order < n_real).astype(np.int32)
        pos = (self.sub_points[ci][q] - pick).astype(np.float32)
        data = {"pos": pos,
                "x": self.sub_colors[ci][q].astype(np.float32),
                "y": self.sub_labels[ci][q],
                "mask": mask,
                "cloud_index": np.int64(ci),
                "input_inds": q.astype(np.int64)}
        if self.transform is not None:
            data = self.transform(data, rng)
        if "heights" not in data:
            data["heights"] = (pick[2] + pos[:, 2:3]).astype(np.float32)
        return data
