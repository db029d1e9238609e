"""ModelNet40 (2048-point h5 and the normal-resampled txt release) and
ModelNet-C, with the ModelNet-C sweep and its mCE.

Counterpart of ``adaptpoint_tpu/datasets/modelnet.py`` (reference
openpoints/dataset/modelnet/modelnet40_ply_2048_loader.py:60-150,
modelnet40_normal_resampled_loader.py:51-124, modelnet_c/modelnet_c.py:16-127
and mCE_calculator.py:13-58): the same registry names, the same per-sample
randomness (the train split shuffles its points with the sample's
generator), so the two packages' loaders give the same batches bit for bit.
``eval_corrupt_wrapper_modelnetc`` is ``eval_corrupt_wrapper`` over
``ModelNetC`` splits against the DGCNN baseline of the reference. The data
is not in the repository (``data_dir``, ``modelnet_c_dir``).
"""
from __future__ import annotations

import glob
import logging
import os.path as osp

import numpy as np

from .build import DATASETS
from .data_util import load_h5_cached
from .scanobjectnn import eval_corrupt_wrapper

__all__ = ["ModelNet40Ply2048", "ModelNet", "ModelNetC", "MODELNET40_CLASSES",
           "DGCNN_OA_MODELNET_C", "POINTNET2_WOLFMIX_MODELNET_C",
           "validate_modelnetc", "eval_corrupt_wrapper_modelnetc",
           "calculate_ce"]

MODELNET40_CLASSES = [
    "airplane", "bathtub", "bed", "bench", "bookshelf", "bottle", "bowl",
    "car", "chair", "cone", "cup", "curtain", "desk", "door", "dresser",
    "flower_pot", "glass_box", "guitar", "keyboard", "lamp", "laptop",
    "mantel", "monitor", "night_stand", "person", "piano", "plant", "radio",
    "range_hood", "sink", "sofa", "stairs", "stool", "table", "tent",
    "toilet", "tv_stand", "vase", "wardrobe", "xbox",
]

# the CE normalisation baseline (reference mCE_calculator.py:22-31)
DGCNN_OA_MODELNET_C = {
    "clean": 0.926, "scale": 0.906, "jitter": 0.684, "rotate": 0.785,
    "dropout_global": 0.752, "dropout_local": 0.793, "add_global": 0.705,
    "add_local": 0.725,
}

# the reference's worked example (mCE_calculator.py:33)
POINTNET2_WOLFMIX_MODELNET_C = {
    "clean": 0.931, "scale": 0.911, "jitter": 0.567, "rotate": 0.891,
    "dropout_global": 0.886, "dropout_local": 0.873, "add_global": 0.912,
    "add_local": 0.919,
}


def _with_x(data):
    """``x = [pos || heights]`` where the transform made heights, else
    ``pos``."""
    if "heights" in data:
        data["x"] = np.concatenate([data["pos"], data["heights"]], axis=1)
    else:
        data["x"] = data["pos"]
    data.pop("heights", None)
    return data


@DATASETS.register_module()
class ModelNet40Ply2048:
    """12311 CAD models, 40 classes, h5 shards of 2048 points
    (``<data_dir>/modelnet40_ply_hdf5_2048/ply_data_{train,test}*.h5``)."""

    classes = MODELNET40_CLASSES
    num_classes = 40
    gravity_dim = 1

    def __init__(self, data_dir="./data/ModelNet40Ply2048", split="train",
                 num_points=1024, transform=None, **kwargs):
        self.partition = "train" if split.lower() == "train" else "test"
        self.num_points = num_points
        self.transform = transform
        pattern = osp.join(data_dir, "modelnet40_ply_hdf5_2048",
                           f"ply_data_{self.partition}*.h5")
        files = sorted(glob.glob(pattern))
        if not files:
            raise FileNotFoundError(f"no h5 files under {pattern}")
        data, label = zip(*[load_h5_cached(f) for f in files])
        self.points = np.concatenate(data)
        self.labels = np.concatenate(label)
        logging.info("ModelNet40 %s: %s", split, self.points.shape)

    def __len__(self):
        return self.points.shape[0]

    def get(self, idx: int, rng: np.random.Generator):
        current = np.array(self.points[idx][: self.num_points], np.float32)
        data = {"pos": current, "y": np.int64(self.labels[idx])}
        if self.partition == "train":
            rng.shuffle(data["pos"])
        if self.transform is not None:
            data = self.transform(data, rng)
        return _with_x(data)


@DATASETS.register_module()
class ModelNet:
    """The normal-resampled txt release: a comma-separated xyz + normal file
    per shape under ``<data_dir>/modelnet40_normal_resampled/``, the class
    list ``modelnet{10,40}_shape_names.txt`` and the split lists
    ``modelnet{10,40}_{train,test}.txt``. The train split shuffles its
    points; with ``use_normals`` ``x = [pos || normals (|| heights)]``."""

    gravity_dim = 1

    def __init__(self, data_dir="./data", num_points=1024, num_classes=40,
                 use_normals=False, split="train", transform=None, **kwargs):
        root = osp.join(data_dir, "modelnet40_normal_resampled")
        if not osp.isdir(root):
            root = data_dir  # already the release's directory
        self.root = root
        self.num_points = num_points
        self.num_classes = num_classes
        self.use_normals = use_normals
        self.partition = "train" if split.lower() == "train" else "test"
        self.transform = transform
        tag = "modelnet10" if num_classes == 10 else "modelnet40"
        with open(osp.join(root, f"{tag}_shape_names.txt")) as f:
            self.classes = [ln.strip() for ln in f if ln.strip()]
        cls_of = {c: i for i, c in enumerate(self.classes)}
        with open(osp.join(root, f"{tag}_{self.partition}.txt")) as f:
            ids = [ln.strip() for ln in f if ln.strip()]
        shape_names = ["_".join(i.split("_")[:-1]) for i in ids]
        self.paths = [osp.join(root, name, i + ".txt")
                      for name, i in zip(shape_names, ids)]
        self.labels = np.asarray([cls_of[n] for n in shape_names], np.int64)
        logging.info("ModelNet (normal-resampled) %s: %d shapes", split,
                     len(self.paths))

    def __len__(self):
        return len(self.paths)

    def get(self, idx: int, rng: np.random.Generator):
        raw = np.loadtxt(self.paths[idx], delimiter=",").astype(np.float32)
        raw = raw[: self.num_points]  # the release is in FPS order
        if self.partition == "train":
            raw = raw[rng.permutation(raw.shape[0])]
        data = {"pos": raw[:, 0:3], "y": np.int64(self.labels[idx])}
        if self.use_normals:
            data["x"] = raw[:, 3:6]
        if self.transform is not None:
            data = self.transform(data, rng)
        if self.use_normals:
            data["x"] = np.concatenate([data["pos"], data["x"]], axis=1)
        if "heights" in data:
            base = data["x"] if self.use_normals else data["pos"]
            data["x"] = np.concatenate([base, data.pop("heights")], axis=1)
        elif not self.use_normals:
            data["x"] = data["pos"]
        return data


@DATASETS.register_module()
class ModelNetC:
    """One ModelNet-C split, ``<data_dir>/<split>.h5`` (``clean`` or
    ``{corruption}_{level}``): no point shuffle."""

    classes = MODELNET40_CLASSES
    num_classes = 40
    gravity_dim = 1

    def __init__(self, data_dir="./data/ModelNetC/modelnet_c", split=None,
                 num_points=2048, transform=None, **kwargs):
        self.partition = split
        self.num_points = num_points
        self.transform = transform
        h5 = osp.join(data_dir, f"{split}.h5")
        if not osp.isfile(h5):
            raise FileNotFoundError(f"{h5} not found: download ModelNet-C "
                                    f"first")
        self.points, self.labels = load_h5_cached(h5)

    def __len__(self):
        return self.points.shape[0]

    def get(self, idx: int, rng: np.random.Generator):
        current = np.array(self.points[idx][: self.num_points], np.float32)
        data = {"pos": current, "y": np.int64(self.labels[idx])}
        if self.transform is not None:
            data = self.transform(data, rng)
        return _with_x(data)


def validate_modelnetc(split, eval_step, state, cfg):
    """One ModelNet-C split through ``validate``: ``{"acc": OA / 100}``
    (reference train_modelnetc.py's validate)."""
    from ..engine.cls_trainer import validate
    from ..transforms import build_transforms_from_cfg
    from .loader import NumpyLoader

    transform = build_transforms_from_cfg(
        "val", cfg.get("datatransforms_modelnet_c",
                       cfg.get("datatransforms_scanobjectnn_c")))
    ds = ModelNetC(data_dir=cfg.get("modelnet_c_dir",
                                    "./data/ModelNetC/modelnet_c"),
                   split=split, transform=transform)
    loader = NumpyLoader(ds, cfg.get("val_batch_size", cfg.batch_size))
    _, oa, _, _ = validate(eval_step, state, loader, cfg)
    return {"acc": oa / 100.0}


def eval_corrupt_wrapper_modelnetc(eval_args, out_path, epoch):
    """The ModelNet-C sweep: ``eval_corrupt_wrapper`` over
    ``validate_modelnetc`` against ``DGCNN_OA_MODELNET_C``."""
    return eval_corrupt_wrapper(validate_modelnetc, eval_args, out_path,
                                epoch, baseline_oa=DGCNN_OA_MODELNET_C)


def calculate_ce(model_oa: dict, baseline: dict = DGCNN_OA_MODELNET_C) -> dict:
    """mCE and RmCE from per-corruption OAs (reference
    mCE_calculator.py:37-58)."""
    ces, rces = [], []
    for c, oa in model_oa.items():
        if c == "clean":
            continue
        ces.append((1 - oa) / (1 - baseline[c]))
        rces.append((model_oa["clean"] - oa)
                    / (baseline["clean"] - baseline[c]))
    return {"mCE": round(sum(ces) / len(ces), 3),
            "RmCE": round(sum(rces) / len(rces), 3)}
