"""The port's scene-segmentation command line on the CPU: ``python -m
adaptpoint_tpu_torch.seg --cfg cfgs/s3dis/pointnext-b.yaml --device cpu``
cut to blocks [1, 2, 2], strides [1, 4, 4], width 16, K = 8 on
``SyntheticScene`` crops of 256 points (the cfg's transforms, 13 classes).

- ``mode: train`` for two epochs leaves ``log.txt``, ``cfg.yaml``,
  ``scalars.jsonl`` (the validation mIoU, mAcc and OA each epoch) and both
  checkpoints; it returns the best epoch's mIoU.
- ``mode=test`` and ``mode=val`` on the best checkpoint give exactly the
  best epoch's mIoU, mAcc and OA (the same weights, the same crops).
- ``mode=resume`` on the latest checkpoint runs epoch 3 alone, from the
  saved optimizer state (Adam's step count goes on) and keeps ``best_val``.
- Refusals: ``mode=test_6fold`` and the sphere protocol are not ported
  yet, an unknown mode, ``test`` or ``resume`` without a checkpoint, and no
  card without ``--device cpu``.
"""
import glob
import json
import os
import re

import pytest
import torch

from adaptpoint_tpu_torch.seg import main as cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "cfgs", "s3dis", "pointnext-b.yaml")
NARROW = ["--device", "cpu", "dataset.common.NAME=SyntheticScene",
          "dataset.common.num_points=256", "dataset.common.size=8",
          "batch_size=4", "val_batch_size=4", "seed=3",
          "dataloader.num_workers=0", "model.encoder_args.width=16",
          "model.encoder_args.blocks=[1,2,2]",
          "model.encoder_args.strides=[1,4,4]",
          "model.encoder_args.nsample=8", "model.encoder_args.radius=0.3"]


def run_dir(root):
    runs = glob.glob(os.path.join(root, "s3dis", "*"))
    assert len(runs) == 1, runs
    return runs[0], os.path.basename(runs[0])


def scalars(run):
    out = {}
    for line in open(os.path.join(run, "scalars.jsonl")):
        row = json.loads(line)
        out.setdefault(row["tag"], {})[row["step"]] = row["value"]
    return out


def test_train_test_val_and_resume(tmp_path, capsys):
    root = str(tmp_path / "log")
    best = cli(["--cfg", CFG] + NARROW + ["epochs=2", f"root_dir={root}"])
    counts = json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "launch_counts"]
    assert set(counts) >= {"fps", "ball_group", "knn"}
    assert all(v == 0 for v in counts.values())  # no kernel on the CPU
    run, name = run_dir(root)
    for f in ("log.txt", "cfg.yaml", "scalars.jsonl",
              f"checkpoint/{name}_ckpt_latest.pth",
              f"checkpoint/{name}_ckpt_best.pth"):
        assert os.path.exists(os.path.join(run, f)), f
    assert name.startswith("s3dis-pointnext-b-")
    vals = scalars(run)
    assert sorted(vals["val_miou"]) == [1, 2]
    best_epoch = max(vals["val_miou"], key=vals["val_miou"].get)
    assert best == vals["val_miou"][best_epoch] > 0

    ckpt = os.path.join(run, "checkpoint", f"{name}_ckpt_best.pth")
    for mode in ("test", "val"):
        perf = cli(["--cfg", CFG] + NARROW + [f"mode={mode}",
                                              f"pretrained_path={ckpt}"])
        capsys.readouterr()
        assert set(perf) == {"miou", "macc", "oa", "ious", "accs"}
        for k in ("miou", "macc", "oa"):
            assert perf[k] == vals[f"val_{k}"][best_epoch], (mode, k)
        assert os.path.exists(os.path.join(run, f"cfg_{mode}.yaml"))

    latest = os.path.join(run, "checkpoint", f"{name}_ckpt_latest.pth")
    first = torch.load(latest, weights_only=True)
    assert first["epoch"] == 2 and first["best_val"] == best
    resumed = cli(["--cfg", CFG] + NARROW + ["mode=resume", "epochs=3",
                                             f"pretrained_path={latest}"])
    capsys.readouterr()
    log = open(os.path.join(run, "log.txt")).read()
    assert re.findall(r"Epoch (\d+) LR", log) == ["1", "2", "3"]
    assert "at epoch 2 " in log
    third = torch.load(latest, weights_only=True)
    assert third["epoch"] == 3
    assert resumed == max(best, scalars(run)["val_miou"][3])
    steps = {int(s["step"]) for s in third["optimizer"]["state"].values()}
    assert steps == {6}  # two steps an epoch, three epochs
    assert os.path.exists(os.path.join(run, "cfg_resume.yaml"))


def test_cli_refusals(tmp_path, monkeypatch):
    root = str(tmp_path / "log")
    with pytest.raises(NotImplementedError, match="test_6fold"):
        cli(["--cfg", CFG] + NARROW + ["mode=test_6fold",
                                       f"root_dir={root}"])
    with pytest.raises(ValueError, match="mode"):
        cli(["--cfg", CFG] + NARROW + ["mode=finetune", f"root_dir={root}"])
    for mode in ("test", "resume"):
        with pytest.raises(ValueError, match="pretrained_path"):
            cli(["--cfg", CFG] + NARROW + [f"mode={mode}",
                                           f"root_dir={root}"])
    with pytest.raises(NotImplementedError, match="sphere"):
        cli(["--cfg", os.path.join(REPO, "cfgs", "s3dis",
                                   "pointnext-s_sphere.yaml"),
             "--device", "cpu", f"root_dir={root}"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli(["--cfg", CFG] + NARROW[2:] + [f"root_dir={root}"])


def test_seg_modules_are_covered_by_the_isolation_scan():
    """The slice's modules are among the files ``test_torch_isolation.py``
    scans, and none of them imports JAX, flax or the JAX package; the
    S3DIS path's own modules do not import h5py either (``data_util``
    imports it inside its h5 readers, for other datasets)."""
    from test_torch_isolation import FORBIDDEN, _imported_modules, _port_files
    scanned = {os.path.relpath(p, REPO) for p in _port_files()}
    for rel in ("adaptpoint_tpu_torch/seg.py",
                "adaptpoint_tpu_torch/engine/seg_main.py",
                "adaptpoint_tpu_torch/datasets/s3dis.py",
                "adaptpoint_tpu_torch/datasets/data_util.py",
                "adaptpoint_tpu_torch/transforms/point_transforms.py",
                "adaptpoint_tpu_torch/utils/metrics.py",
                "adaptpoint_tpu_torch/models/backbone/pointnext.py",
                "adaptpoint_tpu_torch/ops/fpsample.py"):
        assert rel in scanned, rel
        banned = FORBIDDEN + (() if rel.endswith("data_util.py")
                              else ("h5py",))
        for mod in _imported_modules(os.path.join(REPO, rel)):
            assert mod.split(".")[0] not in banned, (rel, mod)
