"""The S3DIS data path of the port against the JAX package, on the CPU.

- ``voxelize`` (both modes), ``crop_pc`` (train crop, val crop, padding,
  ``variable``, no voxel size) and ``get_class_weights``: bit-equal outputs
  for the same ``np.random.Generator`` state, and the generators left in
  the same state.
- ``SyntheticScene`` and ``S3DIS`` (rooms written to ``tmp_path``, test
  area 5 held out) with the cfg's transforms (``PointCloudScaling``,
  ``PointCloudXYZAlign``, ``PointCloudJitter``): the same samples and the
  same loader batches (``pos``, ``x``, ``y``, ``heights``) bit for bit.
- ``PointCloudXYZAlign`` and ``PointCloudJitter`` alone.
- ``get_mious`` and the confusion matrix's ``tp``, ``union``, ``count``:
  equal to the JAX package's (float64 sums, so exact).
"""
import os

import numpy as np
import pytest
import torch

from adaptpoint_tpu.datasets import build_dataloader_from_cfg as jax_loader
from adaptpoint_tpu.datasets import data_util as jdu
from adaptpoint_tpu.datasets import s3dis as js3dis
from adaptpoint_tpu.transforms import point_transforms as jpt
from adaptpoint_tpu.utils import EasyConfig as JaxConfig
from adaptpoint_tpu.utils.metrics import (ConfusionMatrix as JaxCM,
                                          get_mious as jax_get_mious)
from adaptpoint_tpu_torch.datasets import build_dataloader_from_cfg
from adaptpoint_tpu_torch.datasets import data_util as pdu
from adaptpoint_tpu_torch.datasets import s3dis as ps3dis
from adaptpoint_tpu_torch.transforms import point_transforms as ppt
from adaptpoint_tpu_torch.utils import EasyConfig
from adaptpoint_tpu_torch.utils.metrics import ConfusionMatrix, get_mious

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def room(seed, n=3000):
    rng = np.random.default_rng(seed)
    coord = (rng.random((n, 3)) * [4, 4, 3]).astype(np.float32)
    feat = (rng.random((n, 3)) * 255).astype(np.float32)
    label = rng.integers(0, 13, n)
    return coord, feat, label


def assert_same(a, b):
    assert type(a) is type(b)
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif a is None:
        assert b is None
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ data_util

@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("voxel", [0.04, 0.2])
def test_voxelize_equals_jax(mode, voxel):
    coord, _, _ = room(1)
    r1, r2 = np.random.default_rng(9), np.random.default_rng(9)
    got = pdu.voxelize(coord, voxel, mode=mode, rng=r1)
    ref = jdu.voxelize(coord, voxel, mode=mode, rng=r2)
    assert_same(got, ref)
    assert r1.random() == r2.random()


@pytest.mark.parametrize("split,voxel_size,voxel_max,variable,shuffle", [
    ("train", 0.04, 2000, False, True),     # crop around a random point
    ("val", 0.04, 2000, False, True),       # around the middle point
    ("train", 0.2, 2000, False, True),      # fewer voxels than voxel_max: pad
    ("train", 0.2, 2000, True, False),      # variable: no pad
    ("val", None, 1000, False, False),      # no voxel downsampling
    ("train", 0.04, None, False, True),     # no crop
])
def test_crop_pc_equals_jax(split, voxel_size, voxel_max, variable, shuffle):
    coord, feat, label = room(2)
    r1, r2 = np.random.default_rng(4), np.random.default_rng(4)
    got = pdu.crop_pc(coord, feat, label, split, voxel_size, voxel_max,
                      variable=variable, shuffle=shuffle, rng=r1)
    ref = jdu.crop_pc(coord, feat, label, split, voxel_size, voxel_max,
                      variable=variable, shuffle=shuffle, rng=r2)
    assert_same(got, ref)
    assert r1.random() == r2.random()
    assert (got[0].min(0) == 0).all()


def test_crop_pc_without_features_or_labels():
    coord, _, _ = room(3)
    got = pdu.crop_pc(coord, None, None, "train", 0.04, 500,
                      rng=np.random.default_rng(1))
    ref = jdu.crop_pc(coord, None, None, "train", 0.04, 500,
                      rng=np.random.default_rng(1))
    assert_same(got, ref)


@pytest.mark.parametrize("normalize", [False, True])
def test_class_weights_equal_jax(normalize):
    counts = js3dis.S3DIS_NUM_PER_CLASS
    got = pdu.get_class_weights(counts, normalize)
    np.testing.assert_array_equal(got, jdu.get_class_weights(counts,
                                                             normalize))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(ps3dis.S3DIS_NUM_PER_CLASS, counts)


# ------------------------------------------------------------- datasets

def test_synthetic_scene_equals_jax():
    port = ps3dis.SyntheticScene("train", num_points=300, size=4)
    ref = js3dis.SyntheticScene("train", num_points=300, size=4)
    assert len(port) == len(ref) == 4 and port.num_classes == 4
    for i in range(4):
        a = port.get(i, np.random.default_rng((0, 1, i)))
        b = ref.get(i, np.random.default_rng((0, 1, i)))
        assert a.keys() == b.keys() == {"pos", "x", "y", "heights"}
        for k in a:
            assert_same(a[k], b[k])


def write_rooms(root, n=2500):
    rng = np.random.default_rng(0)
    raw = os.path.join(root, "raw")
    os.makedirs(raw)
    for area in ("Area_1", "Area_2", "Area_5"):
        for name in ("office_1", "hallway_2"):
            pos = rng.random((n, 3)).astype(np.float32) * [6, 5, 3] + 10
            rgb = rng.random((n, 3)).astype(np.float32) * 255
            y = np.clip(pos[:, 2] - 10, 0, 2.99).astype(np.float32) * 4
            np.save(os.path.join(raw, f"{area}_{name}.npy"),
                    np.concatenate([pos, rgb, np.floor(y)[:, None]], 1))
    return str(root)


def s3dis_cfgs(data_root, name="S3DIS", **common):
    """The S3DIS cfg's dataset and transforms, as both packages load it,
    pointed at ``data_root`` and cut to 1000 points a crop."""
    out = []
    for cls in (EasyConfig, JaxConfig):
        cfg = cls()
        cfg.load(os.path.join(REPO, "cfgs/s3dis/default.yaml"),
                 recursive=True)
        cfg.dataset.common.NAME = name
        cfg.dataset.common.data_root = data_root
        cfg.dataset.train.voxel_max = 1000
        cfg.dataset.val.voxel_max = 1000
        cfg.dataset.train.loop = 2
        cfg.dataset.common.update(common)
        out.append(cfg)
    return out


@pytest.mark.parametrize("split", ["train", "val"])
def test_s3dis_loader_batches_equal_jax(tmp_path, split):
    data_root = write_rooms(tmp_path / "s3dis")
    port_cfg, jax_cfg = s3dis_cfgs(data_root)
    port = build_dataloader_from_cfg(
        3, port_cfg.dataset, {"num_workers": 0},
        datatransforms_cfg=port_cfg.datatransforms, split=split, seed=7)
    ref = jax_loader(3, jax_cfg.dataset, {"num_workers": 0},
                     datatransforms_cfg=jax_cfg.datatransforms, split=split,
                     seed=7)
    assert port.dataset.data_list == ref.dataset.data_list
    assert len(port.dataset) == (8 if split == "train" else 2)
    assert all(("Area_5" in x) == (split == "val")
               for x in port.dataset.data_list)
    port.set_epoch(2)
    ref.set_epoch(2)
    batches = 0
    for a, b in zip(port, ref):
        assert a.keys() == b.keys()
        assert {"pos", "x", "y", "heights"} <= set(a)
        for k in a:
            assert_same(np.asarray(a[k]), np.asarray(b[k]))
        assert a["pos"].shape == (3, 1000, 3)
        batches += 1
    assert batches == len(port) == len(ref)
    with pytest.raises(FileNotFoundError):
        ps3dis.S3DIS(data_root=str(tmp_path / "nowhere"))


def test_synthetic_scene_loader_batches_equal_jax():
    port_cfg, jax_cfg = s3dis_cfgs("", name="SyntheticScene",
                                   num_points=500, size=6)
    for split in ("train", "val"):
        port = build_dataloader_from_cfg(
            4, port_cfg.dataset, {"num_workers": 2},
            datatransforms_cfg=port_cfg.datatransforms, split=split, seed=3)
        ref = jax_loader(4, jax_cfg.dataset, {"num_workers": 0},
                         datatransforms_cfg=jax_cfg.datatransforms,
                         split=split, seed=3)
        for a, b in zip(port, ref):
            for k in a:
                assert_same(np.asarray(a[k]), np.asarray(b[k]))


# ----------------------------------------------------------- transforms

@pytest.mark.parametrize("name,kwargs", [
    ("PointCloudXYZAlign", {"gravity_dim": 2}),
    ("PointCloudXYZAlign", {"gravity_dim": 1}),
    ("PointCloudJitter", {"jitter_sigma": 0.005, "jitter_clip": 0.02}),
    ("PointCloudJitter", {}),
])
def test_transform_equals_jax(name, kwargs):
    coord, _, _ = room(5, 400)
    r1, r2 = np.random.default_rng(6), np.random.default_rng(6)
    got = getattr(ppt, name)(**kwargs)({"pos": coord.copy()}, r1)["pos"]
    ref = getattr(jpt, name)(**kwargs)({"pos": coord.copy()}, r2)["pos"]
    assert_same(got, ref)
    assert r1.random() == r2.random()


# -------------------------------------------------------------- metrics

@pytest.mark.parametrize("ignore_index", [None, 13])
def test_get_mious_equals_jax(ignore_index):
    rng = np.random.default_rng(8)
    port, ref = ConfusionMatrix(13, ignore_index), JaxCM(13, ignore_index)
    for _ in range(3):
        y = rng.integers(0, 13 if ignore_index is None else 14, 5000)
        y[y == 4] = 3  # a class with no points
        pred = np.where(rng.random(5000) < 0.6, y, rng.integers(0, 13, 5000))
        pred[pred == 4] = 5  # ... and no predictions: its IoU counts 100
        port.update(torch.from_numpy(pred), torch.from_numpy(y))
        ref.update(pred, y)
    for attr in ("tp", "union", "count"):
        np.testing.assert_array_equal(getattr(port, attr).numpy(),
                                      getattr(ref, attr))
    got = get_mious(port.tp, port.union, port.count)
    want = jax_get_mious(ref.tp, ref.union, ref.count)
    assert got[:3] == want[:3]
    for a, b in zip(got[3:], want[3:]):
        np.testing.assert_array_equal(a, b)
    assert got[3][4] == 100.0
