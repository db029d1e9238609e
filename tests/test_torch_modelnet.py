"""The port's ModelNet datasets and the ModelNet-C protocol against the JAX
package, on the CPU, on trees the tests write (the data is not in the
repository):

- ``ModelNet40Ply2048`` (h5 shards with the release's keys, both splits)
  and ``ModelNet`` (the normal-resampled txt release, with and without
  normals) through both packages' loaders and the ModelNet-C cfg's
  transforms: the same batches bit for bit over two epochs;
- ``ModelNetC`` samples under the sweep's transform, bit for bit;
- ``calculate_ce`` and the ModelNet-C report (``outcorruption.txt`` and
  the returned results) equal to the JAX package's for fixed per-split
  OAs, and the report's mCE / RmCE within the rounding of its per-
  corruption CEs (0.001) of ``calculate_ce`` on the same OAs;
- the sweep runs the port's model over every split of a tree (1 clean + 7
  x 5 corrupt) and skips a missing tree with a warning.
"""
import logging
import os

import numpy as np
import pytest

from adaptpoint_tpu.datasets import build_dataloader_from_cfg as jax_loader
from adaptpoint_tpu.datasets import modelnet as jax_modelnet
from adaptpoint_tpu.transforms import build_transforms_from_cfg as jax_tf
from adaptpoint_tpu.utils import EasyConfig as JaxConfig
from adaptpoint_tpu_torch.datasets import (CORRUPTIONS,
                                           build_dataloader_from_cfg)
from adaptpoint_tpu_torch.datasets import modelnet
from adaptpoint_tpu_torch.engine import corrupt_main
from adaptpoint_tpu_torch.engine.cls_trainer import TrainState, make_eval_step
from adaptpoint_tpu_torch.models import build_model_from_cfg
from adaptpoint_tpu_torch.transforms import build_transforms_from_cfg
from adaptpoint_tpu_torch.utils import EasyConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MNC = os.path.join(REPO, "cfgs", "modelnetc", "default.yaml")
TINY = os.path.join(REPO, "cfgs", "synthetic", "pointnext-tiny.yaml")


def _both(path, **overrides):
    out = []
    for cls in (JaxConfig, EasyConfig):
        cfg = cls()
        cfg.load(path, recursive=True)
        cfg.update_opts([f"{k}={v}" for k, v in overrides.items()])
        out.append(cfg)
    return out


def _assert_same_batches(jcfg, pcfg, split, keys, epochs=(1, 2)):
    jl = jax_loader(4, jcfg.dataset, jcfg.dataloader,
                    datatransforms_cfg=jcfg.datatransforms, split=split,
                    seed=5)
    pl = build_dataloader_from_cfg(4, pcfg.dataset, pcfg.dataloader,
                                   datatransforms_cfg=pcfg.datatransforms,
                                   split=split, seed=5)
    assert len(jl) == len(pl) > 0
    for epoch in epochs:
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        for jb, pb in zip(jl, pl):
            assert set(jb) == set(pb) == keys
            for key in jb:
                assert jb[key].dtype == pb[key].dtype, key
                np.testing.assert_array_equal(pb[key], jb[key], err_msg=key)
    return pb


def _write_h5(path, n, points, seed, classes=40):
    import h5py
    rng = np.random.default_rng(seed)
    with h5py.File(path, "w") as f:
        f["data"] = rng.standard_normal((n, points, 3)).astype(np.float32)
        f["label"] = rng.integers(0, classes, (n, 1)).astype(np.uint8)


@pytest.fixture
def ply_dir(tmp_path):
    d = tmp_path / "modelnet40_ply_hdf5_2048"
    d.mkdir()
    _write_h5(d / "ply_data_train0.h5", 7, 2048, 1)
    _write_h5(d / "ply_data_train1.h5", 5, 2048, 2)
    _write_h5(d / "ply_data_test0.h5", 6, 2048, 3)
    return str(tmp_path)


@pytest.mark.parametrize("split", ["train", "val"])
def test_modelnet40ply2048_batches_equal_the_jax_loader(ply_dir, split):
    jcfg, pcfg = _both(MNC, **{"dataset.common.data_dir": ply_dir,
                               "dataloader.num_workers": 2})
    last = _assert_same_batches(jcfg, pcfg, split,
                                {"pos", "x", "y", "n_valid"})
    # the transform's heights ride along; in_channels 3 keeps xyz
    assert last["x"].shape == (4, 1024, 4)
    with pytest.raises(FileNotFoundError):
        modelnet.ModelNet40Ply2048(data_dir=str(ply_dir) + "/missing")


@pytest.fixture
def txt_dir(tmp_path):
    root = tmp_path / "modelnet40_normal_resampled"
    root.mkdir()
    names = modelnet.MODELNET40_CLASSES
    (root / "modelnet40_shape_names.txt").write_text("\n".join(names) + "\n")
    rng = np.random.default_rng(4)
    ids = {"train": [], "test": []}
    for i, cls in enumerate(("airplane", "chair", "night_stand", "xbox")):
        (root / cls).mkdir()
        for j in range(3):
            sid = f"{cls}_{j + 1:04d}"
            ids["train" if j < 2 else "test"].append(sid)
            pts = rng.standard_normal((1100, 6)).astype(np.float32)
            np.savetxt(root / cls / f"{sid}.txt", pts, delimiter=",",
                       fmt="%.6f")
    for split, lst in ids.items():
        (root / f"modelnet40_{split}.txt").write_text("\n".join(lst) + "\n")
    return str(tmp_path)


@pytest.mark.parametrize("normals", [False, True],
                         ids=["xyz", "with_normals"])
@pytest.mark.parametrize("split", ["train", "val"])
def test_modelnet_txt_batches_equal_the_jax_loader(txt_dir, split, normals):
    overrides = {"dataset.common.NAME": "ModelNet",
                 "dataset.common.data_dir": txt_dir,
                 "dataset.common.use_normals": normals}
    jcfg, pcfg = _both(MNC, **overrides)
    last = _assert_same_batches(jcfg, pcfg, split,
                                {"pos", "x", "y", "n_valid"})
    assert last["x"].shape == (4, 1024, 7 if normals else 4)


@pytest.fixture
def modelnetc_dir(tmp_path):
    import h5py
    rng = np.random.default_rng(6)
    d = tmp_path / "modelnet_c"
    d.mkdir()
    for c in CORRUPTIONS:
        for s in (["clean"] if c == "clean"
                  else [f"{c}_{i}" for i in range(5)]):
            with h5py.File(d / f"{s}.h5", "w") as f:
                f["data"] = (rng.standard_normal((5, 96, 3)) * 0.5
                             ).astype(np.float32)
                f["label"] = rng.integers(0, 5, (5, 1))
    return str(d)


def test_modelnetc_samples_equal_the_jax_ones(modelnetc_dir):
    tcfg = _both(MNC)[1].datatransforms_modelnet_c
    for split, tf in (("clean", None), ("jitter_2", tcfg),
                      ("add_local_4", tcfg)):
        port = modelnet.ModelNetC(data_dir=modelnetc_dir, split=split,
                                  num_points=64,
                                  transform=tf and build_transforms_from_cfg(
                                      "val", tf))
        ref = jax_modelnet.ModelNetC(data_dir=modelnetc_dir, split=split,
                                     num_points=64,
                                     transform=tf and jax_tf("val", tf))
        assert len(port) == len(ref) == 5
        for i in range(5):
            pg = port.get(i, np.random.default_rng(i))
            jg = ref.get(i, np.random.default_rng(i))
            assert set(pg) == set(jg) == {"pos", "x", "y"}
            for key in jg:
                np.testing.assert_array_equal(pg[key], np.asarray(jg[key]),
                                              err_msg=(split, key))
    assert port.classes == ref.classes and port.num_classes == 40
    with pytest.raises(FileNotFoundError):
        modelnet.ModelNetC(data_dir=modelnetc_dir, split="scale_7")


def _fixed_oas(seed):
    rng = np.random.default_rng(seed)
    accs = {"clean": float(rng.uniform(0.85, 0.95))}
    for c in CORRUPTIONS[1:]:
        for level in range(5):
            accs[f"{c}_{level}"] = float(rng.uniform(0.3, 0.9))
    return accs


@pytest.mark.parametrize("seed", [0, 1])
def test_calculate_ce_equals_the_jax_function(seed):
    assert modelnet.DGCNN_OA_MODELNET_C == jax_modelnet.DGCNN_OA_MODELNET_C
    assert modelnet.MODELNET40_CLASSES == jax_modelnet.MODELNET40_CLASSES
    cases = [modelnet.POINTNET2_WOLFMIX_MODELNET_C]
    rng = np.random.default_rng(seed)
    cases.append({c: float(rng.uniform(0.4, 0.95)) for c in CORRUPTIONS})
    for oas in cases:
        for baseline in (modelnet.DGCNN_OA_MODELNET_C, oas_b := {
                c: 0.5 + 0.04 * i for i, c in enumerate(CORRUPTIONS)}):
            assert modelnet.calculate_ce(oas, baseline) == \
                jax_modelnet.calculate_ce(oas, baseline)
        assert oas_b["clean"] == 0.5
    got = modelnet.calculate_ce(modelnet.POINTNET2_WOLFMIX_MODELNET_C)
    assert 0 < got["mCE"] < 1


@pytest.mark.parametrize("seed", [0, 1])
def test_the_modelnetc_report_equals_the_jax_one(tmp_path, monkeypatch,
                                                 seed):
    """Each package's sweep with its per-split evaluation replaced by the
    same fixed OAs: the same results and the same report text."""
    accs = _fixed_oas(seed)
    seen = []

    def fixed(split, **kwargs):
        seen.append(split)
        return {"acc": accs[split]}

    monkeypatch.setattr(modelnet, "validate_modelnetc", fixed)
    monkeypatch.setattr(jax_modelnet, "validate_modelnetc", fixed)
    dirs = [tmp_path / "port", tmp_path / "jax"]
    for d in dirs:
        d.mkdir()
    got = modelnet.eval_corrupt_wrapper_modelnetc({}, str(dirs[0]), 19)
    ref = jax_modelnet.eval_corrupt_wrapper_modelnetc({}, str(dirs[1]), 19)
    assert got == ref
    assert len(seen) == 2 * (1 + 7 * 5)
    text = (dirs[0] / "outcorruption.txt").read_text()
    assert text == (dirs[1] / "outcorruption.txt").read_text()
    assert text.startswith("epoch: 19") and text.count("'level': 'Overall'") \
        == len(CORRUPTIONS)
    # the report's aggregate against calculate_ce on its own per-corruption
    # OAs: the report rounds each CE to 3 decimals before the mean
    oas = {c: got[c]["OA"] for c in CORRUPTIONS}
    ce = modelnet.calculate_ce(oas)
    agg = got["aggregate"]
    assert abs(agg["mCE"] - ce["mCE"]) <= 1e-3 + 1e-9
    assert abs(agg["RmCE"] - ce["RmCE"]) <= 1e-3 + 1e-9


def test_the_modelnetc_sweep_runs_the_model_and_skips_a_missing_tree(
        modelnetc_dir, tmp_path, caplog):
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    cfg = EasyConfig()
    cfg.load(TINY, recursive=True)
    cfg.update_opts(["mode=modelnetc", f"modelnet_c_dir={modelnetc_dir}",
                     f"run_dir={run_dir}", "val_batch_size=4",
                     "num_points=64"])
    cfg.datatransforms_modelnet_c = _both(MNC)[1].datatransforms_modelnet_c
    cfg.model.in_channels = cfg.model.encoder_args.in_channels = 3
    model = build_model_from_cfg(cfg.model, device="cpu", seed=0)
    state = TrainState(model, None)
    eval_step = make_eval_step(model, cfg)
    calls = []
    validate = modelnet.validate_modelnetc

    def counted(split, *args, **kwargs):
        calls.append(split)
        return validate(split, *args, **kwargs)

    import unittest.mock as mock
    with mock.patch.object(modelnet, "validate_modelnetc", counted):
        corrupt_main._corruption_eval(cfg, eval_step, state, 19)
    assert len(calls) == 1 + 7 * 5 and calls[0] == "clean"
    report = (run_dir / "outcorruption.txt").read_text()
    assert report.startswith("epoch: 19") and "mCE" in report
    oa = modelnet.validate_modelnetc("dropout_local_2", eval_step, state,
                                     cfg)["acc"]
    assert 0.0 <= oa <= 1.0
    cfg.modelnet_c_dir = str(tmp_path / "missing")
    with caplog.at_level(logging.WARNING):
        corrupt_main._corruption_eval(cfg, eval_step, state, "final_best")
    assert "skipping corruption eval" in caplog.text
    assert report == (run_dir / "outcorruption.txt").read_text()


@pytest.mark.parametrize("name", ["adapt.rsmix", "datasets.modelnet",
                                  "engine.corrupt_main", "utils.ckpt"])
def test_the_slice_modules_import_no_jax_and_read_h5_lazily(name):
    """This slice's modules import nothing of JAX or the JAX package, and
    none imports ``h5py`` at the top (the card's machine has none: a split
    imports it when it reads a file)."""
    import ast
    import importlib
    mod = importlib.import_module("adaptpoint_tpu_torch." + name)
    tree = ast.parse(open(mod.__file__).read())
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else [node.module or ""])
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "flax",
                                               "optax", "adaptpoint_tpu"), n
    top = [n for n in tree.body if isinstance(n, (ast.Import,
                                                  ast.ImportFrom))]
    assert not any("h5py" in ast.unparse(n) for n in top)
