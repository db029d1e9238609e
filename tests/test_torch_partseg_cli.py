"""The port's part-segmentation command line on the CPU:
``python -m adaptpoint_tpu_torch.partseg --cfg cfgs/shapenetpart/<x>.yaml
--device cpu`` at width 16 on ``SyntheticPartSeg`` clouds of 128 points.

- ``mode: adaptpoint`` runs phase A and phase B each epoch, leaves the GAN
  pair (``model_gan.pth``, which reloads into a fresh ``build_gan`` bit for
  bit), both checkpoints and the summaries, and sweeps a ShapeNet-C tree
  written to ``tmp_path`` on the latest and the best weights (1 clean and
  35 corrupt splits each in ``outcorruption.txt``); ``mode=test`` on the
  best checkpoint returns the instance mIoU the run logged as its best;
  ``resume=True`` continues at the next epoch with the GAN pair reloaded
  and runs exactly one epoch more.
- ``mode: train`` then ``mode: resume`` on the baseline cfg: the resumed run
  starts at the checkpoint's epoch + 1 with its optimizer's state.
- Without ``--device cpu`` and without a card the CLI raises; so do a mode
  the part-segmentation loop does not run and a test without a checkpoint.
"""
import glob
import json
import os
import re

import numpy as np
import pytest
import torch

from adaptpoint_tpu_torch.datasets import shapenetpart
from adaptpoint_tpu_torch.engine.adapt_trainer import build_gan
from adaptpoint_tpu_torch.partseg import main as cli
from adaptpoint_tpu_torch.utils import EasyConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ADAPT = os.path.join(REPO, "cfgs", "shapenetpart",
                     "pointnext-s_adaptpoint.yaml")
BASE = os.path.join(REPO, "cfgs", "shapenetpart", "pointnext-s.yaml")
NARROW = ["--device", "cpu", "dataset.common.NAME=SyntheticPartSeg",
          "dataset.common.num_points=128", "dataset.common.size=16",
          "num_points=128", "model.encoder_args.width=16", "batch_size=8",
          "val_batch_size=6", "seed=3", "dataloader.num_workers=0"]


def _run_dir(root):
    runs = glob.glob(os.path.join(root, "shapenetpart", "*"))
    assert len(runs) == 1, runs
    return runs[0], os.path.basename(runs[0])


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _shapenet_c_tree(path):
    import h5py
    rng = np.random.default_rng(0)
    os.makedirs(path)
    splits = ["clean"] + [f"{c}_{lv}" for c in
                          shapenetpart.SHAPENETC_CORRUPTIONS[1:]
                          for lv in range(5)]
    for split in splits:
        cls = rng.integers(0, 4, 4)
        with h5py.File(os.path.join(path, f"{split}.h5"), "w") as f:
            f["data"] = (rng.standard_normal((4, 128, 3)) * 0.4).astype(
                np.float32)
            f["label"] = cls[:, None]
            f["pid"] = 2 * cls[:, None] + rng.integers(0, 2, (4, 128))


def test_adaptpoint_run_test_and_resume(tmp_path, capsys):
    root = str(tmp_path / "log")
    tree = str(tmp_path / "shapenet_c")
    _shapenet_c_tree(tree)
    best = cli(["--cfg", ADAPT] + NARROW + [
        "epochs=2", f"root_dir={root}", "eval_shapenet_c=True",
        f"shapenet_c_dir={tree}"])
    counts = _last_json(capsys)["launch_counts"]
    assert set(counts) >= {"fps", "knn", "ball_group_max"}
    assert all(v == 0 for v in counts.values())  # no kernel on the CPU
    run, name = _run_dir(root)
    for f in ("log.txt", "cfg.yaml", "scalars.jsonl", "model_gan.pth",
              "outcorruption.txt", f"checkpoint/{name}_ckpt_latest.pth",
              f"checkpoint/{name}_ckpt_best.pth"):
        assert os.path.exists(os.path.join(run, f)), f
    log = open(os.path.join(run, "log.txt")).read()
    phases = re.findall(r"phase_a_seconds ([0-9.]+) phase_b_seconds "
                        r"([0-9.]+)", log)
    assert len(phases) == 2 and all(float(a) > 0 and float(b) > 0
                                    for a, b in phases)
    assert log.count("phase B: 2 batches of 16 fake clouds") == 2
    moved = [float(v) for v in re.findall(
        r"mean \|fake - real\| ([0-9.eE+-]+)", log)]
    assert len(moved) == 2 and min(moved) > 0.0
    ins = [float(v) for v in re.findall(r"Epoch .*'ins_miou': ([0-9.]+)",
                                        log)]
    cls = [float(v) for v in re.findall(r"Epoch .*'cls_miou': ([0-9.]+)",
                                        log)]
    assert len(ins) == len(cls) == 2 and np.isfinite(ins + cls).all()
    assert best == max(ins)
    report = open(os.path.join(run, "outcorruption.txt")).read().splitlines()
    assert [ln for ln in report if ln.startswith("epoch")] == [
        "epoch: 2-latest", "epoch: 2-best"]
    assert sum(ln.startswith("{'acc'") and "'level': 'Overall'" not in ln
               for ln in report) == 2 * 36

    # the GAN pair reloads into a fresh build_gan, bit for bit
    saved = torch.load(os.path.join(run, "model_gan.pth"), weights_only=True)
    cfg = EasyConfig()
    cfg.load(ADAPT, recursive=True)
    gen, dis, _, _, _ = build_gan(cfg, "cpu", 3)
    gen.load_state_dict(saved["generator"], strict=True)
    dis.load_state_dict(saved["discriminator"], strict=True)
    for part, module in (("generator", gen), ("discriminator", dis)):
        for k, v in module.state_dict().items():
            assert torch.equal(v, saved[part][k]), (part, k)

    # mode=test on the best checkpoint: the run's best instance mIoU
    ckpt = os.path.join(run, "checkpoint", f"{name}_ckpt_best.pth")
    perf = cli(["--cfg", ADAPT] + NARROW + ["mode=test",
                                            f"pretrained_path={ckpt}"])
    capsys.readouterr()
    assert perf["ins_miou"] == best and set(perf) == {"acc", "ins_miou",
                                                      "cls_miou"}
    assert os.path.exists(os.path.join(run, "cfg_test.yaml"))

    # resume=True: one epoch more, from epoch 3, the GAN pair reloaded
    latest = os.path.join(run, "checkpoint", f"{name}_ckpt_latest.pth")
    resumed = cli(["--cfg", ADAPT] + NARROW + [
        "epochs=3", "resume=True", f"pretrained_path={latest}"])
    capsys.readouterr()
    log = open(os.path.join(run, "log.txt")).read()
    after = log[log.index("resumed GAN pair from"):]
    assert re.findall(r"Epoch (\d+) LR", after) == ["3"]
    assert "at epoch 2 " in log
    assert torch.load(latest, weights_only=True)["epoch"] == 3
    assert resumed >= best
    assert os.path.exists(os.path.join(run, "cfg_resume.yaml"))


def test_train_then_mode_resume(tmp_path, capsys):
    root = str(tmp_path / "log")
    cli(["--cfg", BASE] + NARROW + ["epochs=1", f"root_dir={root}"])
    capsys.readouterr()
    run, name = _run_dir(root)
    latest = os.path.join(run, "checkpoint", f"{name}_ckpt_latest.pth")
    first = torch.load(latest, weights_only=True)
    assert first["epoch"] == 1 and first["optimizer"]["state"]
    cli(["--cfg", BASE] + NARROW + ["mode=resume", "epochs=2",
                                    f"pretrained_path={latest}"])
    capsys.readouterr()
    log = open(os.path.join(run, "log.txt")).read()
    assert re.findall(r"Epoch (\d+) LR", log) == ["1", "2"]
    assert "phase_a_seconds 0.000" in log  # no phase A in mode: train
    second = torch.load(latest, weights_only=True)
    assert second["epoch"] == 2
    # Adam's step count went on from the first run's
    steps = {int(s["step"]) for s in second["optimizer"]["state"].values()}
    assert steps == {4}


def test_cli_refusals(tmp_path, monkeypatch):
    root = str(tmp_path / "log")
    with pytest.raises(ValueError, match="mode"):
        cli(["--cfg", BASE] + NARROW + ["mode=finetune", f"root_dir={root}"])
    with pytest.raises(ValueError, match="pretrained_path"):
        cli(["--cfg", BASE] + NARROW + ["mode=val", f"root_dir={root}"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli(["--cfg", BASE] + NARROW[2:] + [f"root_dir={root}"])
