"""The port's ``mode: train`` entry path on the CPU: data, CLI, checkpoints.

- The port's ``NumpyLoader`` with its transforms gives the JAX package's
  batches bit for bit: ``SyntheticCls`` under the synthetic cfg's
  transforms, and ``ScanObjectNNHardest`` on h5 files written with the real
  keys (``data``, ``label``), both splits (the test split's FPS to 1024
  points included).
- ``python -m adaptpoint_tpu_torch.main --cfg
  cfgs/synthetic/pointnext-tiny.yaml --device cpu`` trains two epochs, with
  and without ``ADAPTPOINT_TPU_TRAIN_FUSED=1``, and leaves the run
  directory's ``log.txt``, ``cfg.yaml``, ``scalars.jsonl``, csv and both
  checkpoints; ``mode=test`` on the best checkpoint evaluates exactly the
  checkpoint's tensors (not the freshly built model's, which they differ
  from) and prints the OA the training run's final test of that checkpoint
  printed. A checkpoint of another model does not load.
- Modes and transforms the port lacks say so.
"""
import glob
import json
import os
import re

import numpy as np
import pytest
import torch

from adaptpoint_tpu.datasets import build_dataloader_from_cfg as jax_loader
from adaptpoint_tpu.utils import EasyConfig as JaxConfig
from adaptpoint_tpu_torch.datasets import build_dataloader_from_cfg
from adaptpoint_tpu_torch.engine import cls_main
from adaptpoint_tpu_torch.main import main as cli
from adaptpoint_tpu_torch.models import build_model_from_cfg
from adaptpoint_tpu_torch.transforms import build_transforms_from_cfg
from adaptpoint_tpu_torch.utils import EasyConfig
from adaptpoint_tpu_torch.utils.ckpt import load_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "cfgs", "synthetic", "pointnext-tiny.yaml")
SONN = os.path.join(REPO, "cfgs", "scanobjectnn", "pointnext-s.yaml")


def _both(path, **overrides):
    out = []
    for cls in (JaxConfig, EasyConfig):
        cfg = cls()
        cfg.load(path, recursive=True)
        cfg.update_opts([f"{k}={v}" for k, v in overrides.items()])
        out.append(cfg)
    return out


def _assert_same_batches(jcfg, pcfg, split, epochs=(1, 2), batches=3):
    jl = jax_loader(8, jcfg.dataset, jcfg.dataloader,
                    datatransforms_cfg=jcfg.datatransforms, split=split,
                    seed=5)
    pl = build_dataloader_from_cfg(8, pcfg.dataset, pcfg.dataloader,
                                   datatransforms_cfg=pcfg.datatransforms,
                                   split=split, seed=5)
    assert len(jl) == len(pl) > 0
    for epoch in epochs:
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        for b, (jb, pb) in enumerate(zip(jl, pl)):
            assert set(jb) == set(pb) == {"pos", "x", "y", "n_valid"}
            for key in jb:
                assert jb[key].dtype == pb[key].dtype, key
                np.testing.assert_array_equal(pb[key], jb[key], err_msg=key)
            if b + 1 == batches:
                break


@pytest.mark.parametrize("split", ["train", "val"])
def test_synthetic_batches_equal_the_jax_loader(split):
    jcfg, pcfg = _both(TINY, **{"dataset.common.size": 40,
                                "dataloader.num_workers": 2})
    _assert_same_batches(jcfg, pcfg, split)


def _write_h5(path, n, seed):
    import h5py
    rng = np.random.default_rng(seed)
    with h5py.File(path, "w") as f:
        f["data"] = rng.standard_normal((n, 2048, 3)).astype(np.float32)
        f["label"] = rng.integers(0, 15, (n, 1)).astype(np.uint8)


@pytest.mark.parametrize("split", ["train", "test"])
def test_scanobjectnn_batches_equal_the_jax_loader(tmp_path, split):
    """The test split keeps the first 1024 FPS points of each cloud, computed
    once into a pickle beside the h5. The port's plain FPS follows the
    reference arithmetic (each product and sum rounded); the JAX package's
    CPU route lets XLA contract them, so at a near-tie of two distances the
    two may pick another point: the port's pickle holds the JAX one's points
    but for a few, and on the JAX pickle the batches are equal bit for bit."""
    import pickle
    import shutil
    name = "training" if split == "train" else "test"
    dirs = []
    for who in ("jax", "port"):
        d = tmp_path / who
        d.mkdir()
        _write_h5(d / f"{name}_objectdataset_augmentedrot_scale75.h5", 10, 3)
        dirs.append(str(d))
    jcfg, pcfg = _both(SONN)
    jcfg.dataset.common.data_dir, pcfg.dataset.common.data_dir = dirs
    if split == "test":
        from adaptpoint_tpu.datasets import build_dataset_from_cfg as jbuild
        from adaptpoint_tpu_torch.datasets import build_dataset_from_cfg
        pkl = "test_objectdataset_augmentedrot_scale75_1024_fps.pkl"
        split_cfg = {"split": "test"}
        jpts = jbuild(jcfg.dataset.common, split_cfg).points
        ppts = build_dataset_from_cfg(pcfg.dataset.common, split_cfg).points
        assert ppts.shape == jpts.shape == (10, 1024, 3)
        assert (ppts == jpts).all(-1).mean() > 0.999
        shutil.copyfile(os.path.join(dirs[0], pkl), os.path.join(dirs[1], pkl))
        with open(os.path.join(dirs[1], pkl), "rb") as f:
            assert (pickle.load(f) == jpts).all()
    _assert_same_batches(jcfg, pcfg, split, epochs=(1,), batches=2)


def _run_dir(root):
    runs = glob.glob(os.path.join(root, "synthetic", "*"))
    assert len(runs) == 1, runs
    return runs[0]


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_cli_trains_two_epochs_and_reproduces_its_test_oa(
        tmp_path, monkeypatch, capsys, fused):
    monkeypatch.setenv("ADAPTPOINT_TPU_TRAIN_FUSED", "1" if fused else "0")
    root = str(tmp_path / "log")
    common = ["--cfg", TINY, "--device", "cpu", "dataset.common.size=40",
              "seed=3", f"root_dir={root}"]
    best_val = cli(common + ["epochs=2"])
    run = _run_dir(root)
    name = os.path.basename(run)
    for f in ("log.txt", "cfg.yaml", "scalars.jsonl", f"{name}.csv",
              f"checkpoint/{name}_ckpt_latest.pth",
              f"checkpoint/{name}_ckpt_best.pth"):
        assert os.path.exists(os.path.join(run, f)), f
    log = open(os.path.join(run, "log.txt")).read()
    assert f"fused train-BN route: {fused}" in log
    oas = [float(v) for v in re.findall(r"OA: ([0-9.]+)", log)]
    assert oas and all(np.isfinite(oas)) and 0.0 <= best_val <= 100.0
    tags = [json.loads(ln)["tag"] for ln in
            open(os.path.join(run, "scalars.jsonl"))]
    assert tags.count("train_loss") == 2 and tags.count("val_oa") == 2
    assert len(re.findall(r"epoch_seconds [0-9.]+", log)) == 2
    ckpt = torch.load(os.path.join(run, "checkpoint",
                                   f"{name}_ckpt_best.pth"),
                      weights_only=True)
    assert {"model", "optimizer", "epoch", "best_val"} <= set(ckpt)
    counts = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert not any(counts["launch_counts"].values())  # plain versions
    best = os.path.join(run, "checkpoint", f"{name}_ckpt_best.pth")
    evaluated = []
    validate = cls_main.validate

    def spy(eval_step, state, *args, **kwargs):
        evaluated.append({k: v.detach().clone()
                          for k, v in state.model.state_dict().items()})
        return validate(eval_step, state, *args, **kwargs)

    monkeypatch.setattr(cls_main, "validate", spy)
    oa = cli(common + ["mode=test", f"pretrained_path={best}"])
    assert os.path.exists(os.path.join(run, "cfg_test.yaml"))
    assert f"{oa:3.2f}" == f"{oas[-1]:3.2f}"  # the best checkpoint's test
    assert len(evaluated) == 1 and set(evaluated[0]) == set(ckpt["model"])
    for key, value in ckpt["model"].items():
        assert torch.equal(evaluated[0][key], value), key
    cfg = EasyConfig()
    cfg.load(TINY, recursive=True)
    fresh = build_model_from_cfg(cfg.model, device="cpu", seed=3)
    assert any(not torch.equal(v, ckpt["model"][k])
               for k, v in fresh.state_dict().items()
               if v.is_floating_point())


def test_load_checkpoint_refuses_another_models_weights(tmp_path):
    cfg = EasyConfig()
    cfg.load(TINY, recursive=True)
    model = build_model_from_cfg(cfg.model, device="cpu", seed=0)
    state = model.state_dict()
    path = str(tmp_path / "ckpt.pth")
    torch.save({"model": {k: v for k, v in state.items()
                          if "prediction" not in k}}, path)
    with pytest.raises(RuntimeError, match="Missing key"):
        load_checkpoint(model, path)
    torch.save({"model": dict(state, extra=torch.zeros(1))}, path)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_checkpoint(model, path)
    torch.save({"model": state, "epoch": 4, "best_val": 12.5}, path)
    assert load_checkpoint(model, path) == (4, 12.5)


def test_what_the_port_lacks_says_so(tmp_path):
    for mode in ("pretrain",):
        with pytest.raises(NotImplementedError, match="not ported"):
            cli(["--cfg", TINY, "--device", "cpu", f"mode={mode}",
                 f"root_dir={tmp_path}"])
    with pytest.raises(NotImplementedError, match="not ported"):
        build_transforms_from_cfg("train",
                                  {"train": ["PointCloudTranslation"]})
