"""ShapeNetPart and its corruption test set ShapeNet-C, with the sweep over
it.

Counterpart of ``adaptpoint_tpu/datasets/shapenetpart.py`` (reference
openpoints/dataset/shapenetpart/shapenetpart.py:41-410 and
shapenetpart_c/shapenetpart_c.py:42-200): the 16 shape categories and the
50 part labels each owns (``CLS2PARTS``); ``ShapeNetPart`` over the h5
shards (``trainval`` scales, shifts and shuffles each cloud; every sample
carries its category ``cls``, its part labels ``y`` and ``x = [pos ||
height]``); ``ShapeNetPartC`` over the splits ``{corruption}_{level}.h5``
and ``clean.h5``, and ``eval_corrupt_wrapper_shapenetc``, which runs the
clean split and the seven corruptions at five levels each and appends
the results to ``outcorruption.txt``; ``ShapeNetPartNormal`` over the txt
release with normals, and ``ShapeNetPartCurve``, CurveNet's loader. The
data is not in the repository (``data_root``, ``data_dir``).
"""
from __future__ import annotations

import glob
import logging
import os
import os.path as osp

import numpy as np

from .build import DATASETS
from .data_util import load_h5_seg_cached

__all__ = ["SHAPENETPART_CLASSES", "SEG_NUM", "CLS_PARTS", "CLS2PARTS",
           "SHAPENETC_CORRUPTIONS", "ShapeNetPart", "ShapeNetPartC",
           "ShapeNetPartNormal", "ShapeNetPartCurve",
           "eval_corrupt_wrapper_shapenetc"]

SHAPENETPART_CLASSES = [
    "airplane", "bag", "cap", "car", "chair", "earphone", "guitar", "knife",
    "lamp", "laptop", "motorbike", "mug", "pistol", "rocket", "skateboard",
    "table",
]
SEG_NUM = [4, 2, 2, 4, 4, 3, 3, 2, 4, 2, 6, 2, 3, 3, 3, 3]
CLS_PARTS = {
    "earphone": [16, 17, 18], "motorbike": [30, 31, 32, 33, 34, 35],
    "rocket": [41, 42, 43], "car": [8, 9, 10, 11], "laptop": [28, 29],
    "cap": [6, 7], "skateboard": [44, 45, 46], "mug": [36, 37],
    "guitar": [19, 20, 21], "bag": [4, 5], "lamp": [24, 25, 26, 27],
    "table": [47, 48, 49], "airplane": [0, 1, 2, 3], "pistol": [38, 39, 40],
    "chair": [12, 13, 14, 15], "knife": [22, 23],
}
CLS2PARTS = [CLS_PARTS[c] for c in SHAPENETPART_CLASSES]
SHAPENETC_CORRUPTIONS = ["clean", "scale", "jitter", "rotate",
                         "dropout_global", "dropout_local", "add_global",
                         "add_local"]
_SPLIT_FILES = {"trainval": ["*train*.h5", "*val*.h5"],
                "train": ["*train*.h5"], "val": ["*val*.h5"],
                "test": ["*test*.h5"]}


def _translate_pointcloud(pc: np.ndarray,
                          rng: np.random.Generator) -> np.ndarray:
    """Scale by U[2/3, 3/2] and shift by U[-0.2, 0.2], per axis."""
    scale = rng.uniform(2.0 / 3.0, 3.0 / 2.0, 3).astype(np.float32)
    shift = rng.uniform(-0.2, 0.2, 3).astype(np.float32)
    return (pc * scale + shift).astype(np.float32)


def _read_shards(data_root: str, split: str):
    """The split's h5 shards under ``data_root/hdf5_data`` (or directly
    under ``data_root``), concatenated: ``(data, label, seg)``."""
    patterns = _SPLIT_FILES[split]
    files = sorted(sum((glob.glob(osp.join(data_root, "hdf5_data", p))
                        for p in patterns), []))
    if not files:
        files = sorted(sum((glob.glob(osp.join(data_root, p))
                            for p in patterns), []))
    if not files:
        raise FileNotFoundError(f"no shapenetpart h5 under {data_root}")
    data, label, seg = zip(*[load_h5_seg_cached(f) for f in files])
    return np.concatenate(data), np.concatenate(label), np.concatenate(seg)


def _height(pos: np.ndarray, g: int) -> np.ndarray:
    return (pos[:, g:g + 1] - pos[:, g:g + 1].min()).astype(np.float32)


@DATASETS.register_module()
class ShapeNetPart:
    classes = SHAPENETPART_CLASSES
    num_classes = 50  # part labels
    cls2parts = CLS2PARTS
    gravity_dim = 1

    def __init__(self, data_root="data/shapenetpart", num_points=2048,
                 split="train", transform=None, **kwargs):
        split = {"train": "trainval", "val": "test"}.get(split, split)
        self.partition = split
        self.num_points = num_points
        self.transform = transform
        self.data, self.label, self.seg = _read_shards(data_root, split)
        logging.info("ShapeNetPart %s: %s", split, self.data.shape)

    def __len__(self):
        return self.data.shape[0]

    def get(self, idx: int, rng: np.random.Generator):
        pc = np.array(self.data[idx][: self.num_points], np.float32)
        seg = np.array(self.seg[idx][: self.num_points], np.int64)
        label = int(self.label[idx])
        if self.partition == "trainval":
            pc = _translate_pointcloud(pc, rng)
            order = rng.permutation(pc.shape[0])
            pc, seg = pc[order], seg[order]
        data = {"pos": pc, "y": seg, "cls": np.int64(label)}
        if self.transform is not None:
            data = self.transform(data, rng)
        if "heights" not in data:
            data["heights"] = _height(pc, self.gravity_dim)
        data["x"] = np.concatenate([data["pos"], data["heights"]], axis=1)
        return data


@DATASETS.register_module()
class ShapeNetPartC(ShapeNetPart):
    """One ShapeNet-C split, ``<data_dir>/<split>.h5`` with ``pid`` part
    labels; served as ``ShapeNetPart``'s test split is."""

    def __init__(self, data_dir="./data/shapenet_c", split=None,
                 num_points=2048, transform=None, **kwargs):
        self.partition = split
        self.num_points = num_points
        self.transform = transform
        h5 = osp.join(data_dir, f"{split}.h5")
        if not osp.isfile(h5):
            raise FileNotFoundError(f"{h5} not found: download ShapeNet-C "
                                    f"first")
        self.data, self.label, self.seg = load_h5_seg_cached(h5)


def eval_corrupt_wrapper_shapenetc(eval_fn, eval_args, out_path, epoch,
                                   n_levels: int = 5):
    """``eval_fn(split=..., **eval_args)`` (a dict of metrics) on the clean
    split and on each corruption at ``n_levels`` levels; each corruption's
    metrics averaged over its levels, rounded to 3 places. The lines go to
    ``<out_path>/outcorruption.txt`` (appended) under ``epoch: <epoch>``.
    Returns ``{corruption: averages}``."""
    lines = [f"epoch: {epoch}"]
    result = {}
    for corruption in SHAPENETC_CORRUPTIONS:
        accs = {}
        for level in range(n_levels):
            split = ("clean" if corruption == "clean"
                     else f"{corruption}_{level}")
            perf = eval_fn(split=split, **eval_args)
            for k, v in perf.items():
                accs.setdefault(k, []).append(v)
            lines.append(str(dict(perf, corruption=corruption, level=level)))
            if corruption == "clean":
                break
        agg = {k: round(sum(v) / len(v), 3) for k, v in accs.items()}
        agg.update(corruption=corruption, level="Overall")
        lines.append(str(agg))
        result[corruption] = agg
    if out_path:
        with open(os.path.join(out_path, "outcorruption.txt"), "a") as f:
            f.write("\n".join(lines) + "\n")
    logging.info("shapenet-c eval: %s", result)
    return result


@DATASETS.register_module()
class ShapeNetPartNormal(ShapeNetPart):
    """The txt release with normals: ``synsetoffset2category.txt``, the
    shuffled json split lists, and one ``xyz normal pid`` txt per shape;
    ``num_points`` drawn per sample (with replacement where a shape has
    fewer), ``x = [pos || height || normal]``."""

    def __init__(self, data_root="data/shapenetcore_partanno_segmentation_"
                                 "benchmark_v0_normal",
                 num_points=2048, split="train", use_normal=True,
                 transform=None, **kwargs):
        import json
        split = {"val": "test"}.get(split, split)
        self.partition = split
        self.num_points = num_points
        self.use_normal = use_normal
        self.transform = transform
        catfile = osp.join(data_root, "synsetoffset2category.txt")
        if not osp.isfile(catfile):
            raise FileNotFoundError(f"{catfile} not found")
        cat = {}
        with open(catfile) as f:
            for line in f:
                name, synset = line.strip().split()
                cat[name] = synset
        cls_of_synset = {v: i for i, v in enumerate(cat.values())}
        wanted = {"train": ["train", "val"], "trainval": ["train", "val"],
                  "test": ["test"]}[split]
        ids = set()
        for w in wanted:
            with open(osp.join(data_root, "train_test_split",
                               f"shuffled_{w}_file_list.json")) as f:
                ids |= {d.split("/")[2] for d in json.load(f)}
        self.paths, self.label = [], []
        for synset in cat.values():
            d = osp.join(data_root, synset)
            if not osp.isdir(d):
                continue
            for fn in sorted(os.listdir(d)):
                if fn[:-4] in ids:
                    self.paths.append(osp.join(d, fn))
                    self.label.append(cls_of_synset[synset])
        self.label = np.asarray(self.label, np.int64)
        logging.info("ShapeNetPartNormal %s: %d shapes", split,
                     len(self.paths))

    def __len__(self):
        return len(self.paths)

    def get(self, idx: int, rng: np.random.Generator):
        raw = np.loadtxt(self.paths[idx]).astype(np.float32)
        sel = rng.choice(len(raw), self.num_points,
                         replace=len(raw) < self.num_points)
        raw = raw[sel]
        pos, normal, seg = raw[:, :3], raw[:, 3:6], raw[:, 6].astype(np.int64)
        data = {"pos": pos, "y": seg, "cls": np.int64(self.label[idx])}
        if self.use_normal:
            data["normals"] = normal
        if self.transform is not None:
            data = self.transform(data, rng)
        if "heights" not in data:
            data["heights"] = _height(data["pos"], self.gravity_dim)
        parts = [data["pos"], data["heights"]]
        if self.use_normal:
            parts.append(data.get("normals", normal))
        data["x"] = np.concatenate(parts, axis=1)
        data.pop("heights", None)
        data.pop("normals", None)
        return data


@DATASETS.register_module()
class ShapeNetPartCurve(ShapeNetPart):
    """CurveNet's loader over the same h5 shards: the split as given (no
    ``train`` -> ``trainval``), a shuffle in training but no scale or shift,
    an optional single category (``class_choice``), and ``x`` the height
    alone where a transform gives one."""

    def __init__(self, data_root="data/ShapeNetPart/hdf5_data",
                 num_points=2048, split="train", class_choice=None,
                 transform=None, **kwargs):
        self.partition = split
        self.num_points = num_points
        self.transform = transform
        self.data, self.label, self.seg = _read_shards(data_root, split)
        logging.info("ShapeNetPartCurve %s: %s", split, self.data.shape)
        cat2id = {c: i for i, c in enumerate(
            ["airplane", "bag", "cap", "car", "chair", "earphone", "guitar",
             "knife", "lamp", "laptop", "motor", "mug", "pistol", "rocket",
             "skateboard", "table"])}
        self.seg_num_all, self.seg_start_index = 50, 0
        if class_choice is not None:
            cid = cat2id[class_choice]
            keep = self.label == cid
            self.data, self.label, self.seg = (
                self.data[keep], self.label[keep], self.seg[keep])
            self.seg_num_all = SEG_NUM[cid]
            self.seg_start_index = [0, 4, 6, 8, 12, 16, 19, 22, 24, 28, 30,
                                    36, 38, 41, 44, 47][cid]

    def get(self, idx: int, rng: np.random.Generator):
        pc = np.array(self.data[idx][: self.num_points], np.float32)
        seg = np.array(self.seg[idx][: self.num_points], np.int64)
        if "train" in self.partition:
            order = rng.permutation(pc.shape[0])
            pc, seg = pc[order], seg[order]
        data = {"pos": pc, "y": seg, "cls": np.int64(self.label[idx])}
        if self.transform is not None:
            data = self.transform(data, rng)
        if "heights" in data:
            data["x"] = data.pop("heights")
        return data
