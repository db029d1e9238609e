"""The S3DIS sphere protocol's host side against the JAX package's, on the
CPU, bit for bit where the JAX package is deterministic.

- The host kd-tree (``ops.cpu.KDTree``, ``kdtree_knn``, ``knn_search``):
  kNN and radius queries (with ``max_out``) equal to the JAX package's
  library on the same points, ties and k > N included; the radius query
  equal to its plain version; a failed ``g++`` build raises; the library
  lies under ``build/adaptpoint_tpu_torch``.
- Grid subsampling (``ops.cpu.grid_subsample``) equal to JAX's, with and
  without features, and to its plain version.
- ``S3DISSphere`` on six seeded areas of two rooms the test writes (voxel
  0.1, spheres of 1 m and 256 points): the subsampled clouds, projections,
  the schedule (``cloud_inds``, ``point_inds``, ``noise``), ``get(i, rng)``
  for both splits, both epochs and the sphere cfg's transforms, the cache
  hit, and the split: ``val`` is Area_5 whatever ``test_area`` says.
- ``ChromaticNormalize`` on clouds above and below 1 (with and without
  ``color_mean``), ``MaskedCrossEntropy`` within 1e-6 (an all-zero mask
  too) and ``vis3d.write_obj`` / ``read_obj`` equal to JAX's.
"""
import importlib
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adaptpoint_tpu.datasets.s3dis import S3DISSphere as JaxSphere
from adaptpoint_tpu.loss import MaskedCrossEntropy as JaxMaskedCE
from adaptpoint_tpu.transforms import (
    build_transforms_from_cfg as jax_transforms)
from adaptpoint_tpu.transforms.point_transforms import (
    ChromaticNormalize as JaxChromatic)
from adaptpoint_tpu.utils import EasyConfig as JaxConfig
from adaptpoint_tpu_torch.datasets import S3DISSphere
from adaptpoint_tpu_torch.datasets import vis3d
from adaptpoint_tpu_torch.loss import (MaskedCrossEntropy,
                                       build_criterion_from_cfg)
from adaptpoint_tpu_torch.ops import _build
from adaptpoint_tpu_torch.ops.cpu import (KDTree, grid_subsample,
                                          grid_subsample_plain, kdtree_knn,
                                          knn_plain, knn_search,
                                          query_radius_plain)
from adaptpoint_tpu_torch.transforms import build_transforms_from_cfg
from adaptpoint_tpu_torch.transforms.point_transforms import (
    ChromaticNormalize)
from adaptpoint_tpu_torch.utils import EasyConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
jkd = importlib.import_module("adaptpoint_tpu.ops.cpu.kdtree_knn")
jgs = importlib.import_module("adaptpoint_tpu.ops.cpu.grid_subsample")
SPHERE = dict(voxel_size=0.1, in_radius=1.0, num_points=256, num_steps=4,
              num_epochs=2)


def cloud(seed, n, ties):
    rng = np.random.default_rng(seed)
    p = (rng.random((n, 3)) * [4, 4, 3]).astype(np.float32)
    if ties:  # exact copies and points on a grid: equal distances
        p[::5] = p[1::5]
        p[2::7] = np.round(p[2::7] * 4) / 4
    return p


def test_the_libraries_are_the_ports_own():
    """The JAX loader's library is a C++ build too (else the comparisons
    below would hold the port against its numpy fallback); the port's
    libraries lie under build/adaptpoint_tpu_torch, built from the sources
    beside their modules."""
    assert jkd._load() is not False and jgs._load() is not False
    kd = _build.load_host(importlib.import_module(
        "adaptpoint_tpu_torch.ops.cpu.kdtree_knn")._SRC)
    gs = _build.load_host(importlib.import_module(
        "adaptpoint_tpu_torch.ops.cpu.grid_subsample")._SRC)
    for lib in (kd, gs):
        assert os.path.dirname(lib._name) == str(_build.BUILD_DIR)
        assert "adaptpoint_tpu/cpp" not in lib._name


@pytest.mark.parametrize("ties", [False, True])
def test_the_kdtree_equals_jax(ties):
    p, q = cloud(0, 3000, ties), cloud(1, 200, ties)
    q[:20] = p[:20]  # queries on the points
    tree, jtree = KDTree(p), jkd.KDTree(p)
    for k in (1, 8):
        got, ref = tree.query(q, k), jtree.query(q, k)
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
    for i in range(40):
        for r, cap in ((0.3, None), (0.6, 16), (1.0, 300)):
            got = tree.query_radius(q[i], r, cap)
            np.testing.assert_array_equal(got, jtree.query_radius(q[i], r,
                                                                  cap))
            np.testing.assert_array_equal(
                got, query_radius_plain(p, q[i], r, cap))
    # k > N: the farthest found repeats
    small = p[:5]
    got, ref = kdtree_knn(small, q, 8), jkd.kdtree_knn(small, q, 8)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert (got[0][:, 5:] == got[0][:, 4:5]).all()
    batched = knn_search(np.stack([p, p[::-1]]), np.stack([q, q]), 4)
    np.testing.assert_array_equal(
        batched, jkd.knn_search(np.stack([p, p[::-1]]), np.stack([q, q]), 4))
    np.testing.assert_array_equal(knn_search(p, q, 3),
                                  jkd.knn_search(p, q, 3))
    if not ties:  # without ties the plain kNN is the same
        np.testing.assert_array_equal(tree.query(q, 8)[0],
                                      knn_plain(p, q, 8)[0])


def test_the_kdtree_pickles_as_its_points():
    import pickle
    p = cloud(2, 500, False)
    tree = pickle.loads(pickle.dumps(KDTree(p)))
    np.testing.assert_array_equal(tree.query(p[:9], 3)[0],
                                  KDTree(p).query(p[:9], 3)[0])


def test_a_failed_host_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "broken_host_op.cpp"
    bad.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        _build.load_host(bad)
    other = tmp_path / "other_host_op.cpp"
    other.write_text("extern \"C\" int f() { return 1; }\n")
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        _build.load_host(other)


@pytest.mark.parametrize("feats", [False, True])
def test_grid_subsampling_equals_jax(feats):
    rng = np.random.default_rng(4)
    p = cloud(3, 6000, True)
    f = (rng.random((6000, 4)) * 255).astype(np.float32) if feats else None
    got = grid_subsample(p, f, 0.1)
    ref = jgs.grid_subsample(p, f, 0.1)
    plain = grid_subsample_plain(p, f, 0.1)
    assert got[0].shape[0] < 6000
    for a, b in ((got, ref), (got, plain)):
        np.testing.assert_array_equal(a[0], b[0])
        if feats:
            np.testing.assert_array_equal(a[1], b[1])
        else:
            assert a[1] is None and b[1] is None


# ------------------------------------------------------------ S3DISSphere

def write_areas(root, areas=range(1, 7), n=500):
    """Two rooms an area, raw rows (x, y, z, r, g, b, label) as S3DIS's
    ``raw/Area_k_room_j.npy`` (the JAX tests' fixture, rooms of 4 x 4 x 3
    m with colours in 0-255 and labels by height)."""
    rng = np.random.default_rng(0)
    raw = os.path.join(root, "raw")
    os.makedirs(raw, exist_ok=True)
    for a in areas:
        for room in (1, 2):
            pos = rng.random((n, 3)).astype(np.float32) * [4, 4, 3]
            rgb = rng.random((n, 3)).astype(np.float32) * 255
            y = np.clip((pos[:, 2] / 3.0 * 13).astype(np.float32), 0, 12)
            np.save(os.path.join(raw, f"Area_{a}_room_{room}.npy"),
                    np.concatenate([pos, rgb, y[:, None]], 1))
    return str(root)


def sphere_transforms(split):
    cfg = EasyConfig()
    cfg.load(os.path.join(REPO, "cfgs", "s3dis", "pointnext-s_sphere.yaml"),
             recursive=True)
    t = dict(cfg.datatransforms)
    jt = JaxConfig(t)
    return (build_transforms_from_cfg(split, cfg.datatransforms),
            jax_transforms(split, jt))


@pytest.mark.parametrize("split", ["train", "val"])
def test_the_sphere_dataset_equals_jax(tmp_path, split):
    root = write_areas(tmp_path / "port")
    jroot = write_areas(tmp_path / "jax")
    port_t, jax_t = sphere_transforms(split)
    ds = S3DISSphere(data_root=root, split=split, transform=port_t,
                     test_area=2, **SPHERE)
    ref = JaxSphere(data_root=jroot, split=split, transform=jax_t,
                    test_area=2, **SPHERE)
    want = ["Area_5"] if split == "val" else [
        f"Area_{a}" for a in (1, 2, 3, 4, 6)]
    assert ds._area_names == ref._area_names == want
    for name in ("clouds_points", "clouds_colors", "clouds_labels",
                 "sub_points", "sub_colors", "sub_labels", "projections"):
        for a, b in zip(getattr(ds, name), getattr(ref, name)):
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert ds.cloud_inds == ref.cloud_inds
    assert ds.point_inds == ref.point_inds
    np.testing.assert_array_equal(np.stack(ds.noise), np.stack(ref.noise))
    assert len(ds.cloud_inds) == SPHERE["num_steps"] * SPHERE["num_epochs"]
    padded = 0
    for epoch in (0, 1):
        ds.set_epoch(epoch)
        ref.set_epoch(epoch)
        for i in range(SPHERE["num_steps"]):
            got = ds.get(i, np.random.default_rng((7, epoch, i)))
            exp = ref.get(i, np.random.default_rng((7, epoch, i)))
            assert set(got) == set(exp) == {"pos", "x", "y", "mask",
                                            "cloud_index", "input_inds",
                                            "heights"}
            for k in got:
                np.testing.assert_array_equal(got[k], exp[k], err_msg=k)
                assert np.asarray(got[k]).dtype == np.asarray(exp[k]).dtype
            assert got["pos"].shape == (256, 3)
            assert got["x"].max() <= 1.0  # ChromaticNormalize
            padded += int(got["mask"].sum() < 256)
    assert padded > 0  # some spheres are padded by resampling
    # the cache: a second dataset reads processed/*.npz
    cached = os.listdir(os.path.join(root, "processed"))
    assert sorted(cached) == sorted(f"{a}_0.100_sphere.npz" for a in want)
    again = S3DISSphere(data_root=root, split=split, **SPHERE)
    for a, b in zip(again.sub_points, ds.sub_points):
        np.testing.assert_array_equal(a, b)
    assert again.cloud_inds == ds.cloud_inds


def test_a_missing_tree_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        S3DISSphere(data_root=str(tmp_path), **SPHERE)


# ------------------------------------------------- transforms, loss, OBJ

@pytest.mark.parametrize("scale,mean", [(255.0, False), (1.0, False),
                                        (255.0, True), (0.8, True)])
def test_chromatic_normalize_equals_jax(scale, mean):
    rng = np.random.default_rng(5)
    x = (rng.random((300, 4)) * scale).astype(np.float32)
    kw = ({"color_mean": S3DISSphere.color_mean,
           "color_std": S3DISSphere.color_std} if mean else {})
    got = ChromaticNormalize(**kw)({"x": x.copy()}, None)["x"]
    ref = JaxChromatic(**kw)({"x": x.copy()}, None)["x"]
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[:, 3], x[:, 3])
    if not mean:
        np.testing.assert_array_equal(
            got[:, :3], x[:, :3] / 255.0 if scale > 1 else x[:, :3])


@pytest.mark.parametrize("mask_kind", ["mixed", "zero", "one"])
def test_masked_cross_entropy_equals_jax(mask_kind):
    rng = np.random.default_rng(6)
    logits = rng.normal(size=(2, 300, 13)).astype(np.float32) * 3
    y = rng.integers(0, 13, (2, 300))
    mask = {"mixed": rng.random((2, 300)) < 0.6,
            "zero": np.zeros((2, 300), bool),
            "one": np.ones((2, 300), bool)}[mask_kind].astype(np.int32)
    crit = build_criterion_from_cfg(EasyConfig(
        {"NAME": "MaskedCrossEntropy", "label_smoothing": 0.2}))
    assert isinstance(crit, MaskedCrossEntropy)
    got = crit(torch.from_numpy(logits), torch.from_numpy(y),
               torch.from_numpy(mask))
    ref = JaxMaskedCE(label_smoothing=0.2)(jnp.asarray(logits),
                                            jnp.asarray(y), jnp.asarray(mask))
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6, atol=1e-6)
    if mask_kind == "zero":
        assert got.item() == 0.0
    if mask_kind == "one":
        plain = crit.ce(torch.from_numpy(logits), torch.from_numpy(y))
        np.testing.assert_allclose(got.item(), plain.item(), rtol=1e-6)


def test_obj_files_equal_jax(tmp_path):
    jvis = importlib.import_module("adaptpoint_tpu.datasets.vis3d")
    rng = np.random.default_rng(8)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    rgb = rng.random((50, 3))
    vis3d.write_obj(pts, rgb, str(tmp_path / "a.obj"))
    jvis.write_obj(pts, rgb, str(tmp_path / "b.obj"))
    assert (tmp_path / "a.obj").read_text() == (tmp_path / "b.obj").read_text()
    p, c = vis3d.read_obj(str(tmp_path / "a.obj"))
    jp, jc = jvis.read_obj(str(tmp_path / "a.obj"))
    np.testing.assert_array_equal(p, jp)
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_allclose(p, pts, atol=1e-6)
