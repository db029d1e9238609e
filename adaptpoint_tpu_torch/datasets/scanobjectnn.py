"""ScanObjectNN (hardest variant), the classification dataset of the cfgs,
and its corruption test set ScanObjectNN-C with the sweep over it.

Counterpart of ``adaptpoint_tpu/datasets/scanobjectnn.py`` (reference
openpoints/dataset/scanobjectnn/scanobjectnn.py:11-100): the h5 split, the
test split's FPS to 1024 points computed once and kept beside it as a
pickle, the train-time point shuffle and the height feature appended to
``x``; and (reference scanobjectnn_c.py:17-167) the corruption splits
``{corruption}_{level}.h5`` and ``clean.h5``, and ``eval_corrupt_wrapper``,
which runs the clean split and the seven corruptions at five levels each
and aggregates OA, CE and RCE into mOA, mCE and RmCE against the
reference's DGCNN baseline. The data is not in the repository
(``data_dir``).
"""
from __future__ import annotations

import logging
import os
import pickle
from typing import Optional

import numpy as np

from .build import DATASETS
from .data_util import load_h5_cached

__all__ = ["ScanObjectNNHardest", "ScanObjectNNC", "SCANOBJECTNN_CLASSES",
           "CORRUPTIONS", "DGCNN_OA_SCANOBJECTNN_C", "eval_corrupt_wrapper"]

SCANOBJECTNN_CLASSES = [
    "bag", "bin", "box", "cabinet", "chair", "desk", "display", "door",
    "shelf", "table", "bed", "pillow", "sink", "sofa", "toilet",
]

# the CE normalisation baseline (reference scanobjectnn_c.py:113-122)
DGCNN_OA_SCANOBJECTNN_C = {
    "clean": 0.858, "scale": 0.578, "jitter": 0.456, "rotate": 0.733,
    "dropout_global": 0.622, "dropout_local": 0.697, "add_global": 0.540,
    "add_local": 0.773,
}

CORRUPTIONS = ["clean", "scale", "jitter", "rotate", "dropout_global",
               "dropout_local", "add_global", "add_local"]


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


@DATASETS.register_module()
class ScanObjectNNC(ClsPointsBase):
    """One corruption split, ``<data_dir>/<split>.h5``: no point shuffle, and
    a height feature only where the transform computed one
    (scanobjectnn_c.py:79-85)."""

    def __init__(self, data_dir: str = "./data/ScanObjectNN_C/scanobjectnn_c",
                 split: Optional[str] = None, num_points: int = 2048,
                 transform=None, **kwargs):
        self.split = split
        self.num_points = num_points
        self.transform = transform
        h5 = os.path.join(data_dir, f"{split}.h5")
        if not os.path.isfile(h5):
            raise FileNotFoundError(f"{h5} not found: download "
                                    f"ScanObjectNN-C first")
        self.points, self.labels = load_h5_cached(h5)

    def get(self, idx: int, rng: np.random.Generator):
        current = np.array(self.points[idx][: self.num_points], np.float32)
        data = {"pos": current, "y": np.int64(self.labels[idx])}
        if self.transform is not None:
            data = self.transform(data, rng)
        if "heights" in data:
            data["x"] = np.concatenate([data["pos"], data["heights"]], axis=1)
        else:
            data["x"] = data["pos"]
        data.pop("heights", None)
        return data


def eval_corrupt_wrapper(model_eval_fn, eval_args, out_path: str, epoch,
                         corruptions=CORRUPTIONS,
                         baseline_oa=DGCNN_OA_SCANOBJECTNN_C,
                         n_levels: int = 5):
    """The clean split, then each corruption at ``n_levels`` levels, through
    ``model_eval_fn(split=..., **eval_args)`` (``{"acc": float}`` or a
    float); per corruption its OA, CE and RCE, then mOA, mCE and RmCE.
    Appends the report to ``<out_path>/outcorruption.txt`` and returns the
    per-corruption results with ``"aggregate"``."""
    lines = [f"epoch: {epoch}"]
    oa_clean = None
    perf_all = {"OA": [], "CE": [], "RCE": []}
    result = {}
    for corruption in corruptions:
        oas = []
        for level in range(n_levels):
            split = "clean" if corruption == "clean" \
                else f"{corruption}_{level}"
            perf = model_eval_fn(split=split, **eval_args)
            if not isinstance(perf, dict):
                perf = {"acc": perf}
            oas.append(perf["acc"])
            rep = dict(perf, corruption=corruption)
            if corruption != "clean":
                rep["level"] = level
            lines.append(str(rep))
            if corruption == "clean":
                oa_clean = round(perf["acc"], 3)
                break
        perf_corrupt = {"OA": round(sum(oas) / len(oas), 3)}
        if corruption != "clean":
            perf_corrupt["CE"] = round(
                (1 - perf_corrupt["OA"]) / (1 - baseline_oa[corruption]), 3)
            perf_corrupt["RCE"] = round(
                (oa_clean - perf_corrupt["OA"])
                / (baseline_oa["clean"] - baseline_oa[corruption]), 3)
            for k in perf_all:
                perf_all[k].append(perf_corrupt[k])
        perf_corrupt.update(corruption=corruption, level="Overall")
        lines.append(str(perf_corrupt))
        result[corruption] = perf_corrupt
    agg = {k: round(sum(v) / len(v), 3) for k, v in perf_all.items()}
    agg = {"mCE": agg["CE"], "RmCE": agg["RCE"], "mOA": agg["OA"],
           "OA_clean": oa_clean}
    lines.append(str(agg))
    if out_path:
        with open(os.path.join(out_path, "outcorruption.txt"), "a") as f:
            f.write("\n".join(str(x) for x in lines) + "\n")
    logging.info("corruption eval: %s", agg)
    result["aggregate"] = agg
    return result
