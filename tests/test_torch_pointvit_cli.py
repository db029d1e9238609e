"""PointViT through the port's command line on the CPU:
``python -m adaptpoint_tpu_torch.main --cfg cfgs/scanobjectnn/pointvit.yaml
--device cpu`` with the cfg's model cut to a tiny override (embed 48, depth
2, 3 heads, 16 groups of 8) on a small SyntheticCls set (128 points a cloud,
64 drawn a step). The override is written into a copy of the cfg and its
``default.yaml`` (as command-line overrides it would name a run directory
longer than a file name may be).

- ``mode: train`` for two epochs: the run directory, both checkpoints, the
  launch counts line (every count 0: the plain versions); ``mode=test`` on
  the best checkpoint prints the OA the run's final test printed;
  ``mode=resume`` on the latest continues at epoch 3 with its best OA
  carried over; ``mode=finetune`` on the best trains from epoch 1;
- ``mode: scanobjectnnc`` for one epoch (its ScanObjectNN-C sweep, with no
  tree here, logged and skipped), then ``resume=True`` for one epoch more.
"""
import glob
import json
import os
import re

import numpy as np
import torch
import yaml

from adaptpoint_tpu_torch.main import main as cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"dataset": {"common": {"NAME": "SyntheticCls", "num_points": 128,
                               "num_classes": 15, "size": 24}},
        "num_points": 64, "batch_size": 8, "val_batch_size": 8,
        "dataloader": {"num_workers": 0},
        "model": {"encoder_args": {"embed_dim": 48, "depth": 2,
                                   "num_heads": 3, "num_groups": 16,
                                   "group_size": 8}}}


def _merge(dst, src):
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _merge(dst[k], v)
        else:
            dst[k] = v
    return dst


def _tiny_cfg(tmp_path):
    """``cfgs/scanobjectnn/{default,pointvit}.yaml`` copied, the tiny
    override merged into the copy of ``pointvit.yaml``."""
    d = tmp_path / "cfgs" / "scanobjectnn"
    d.mkdir(parents=True)
    src = os.path.join(REPO, "cfgs", "scanobjectnn")
    (d / "default.yaml").write_text(
        open(os.path.join(src, "default.yaml")).read())
    cfg = _merge(yaml.safe_load(open(os.path.join(src, "pointvit.yaml"))),
                 TINY)
    assert cfg["model"]["encoder_args"]["NAME"] == "PointViT"
    (d / "pointvit.yaml").write_text(yaml.safe_dump(cfg))
    return str(d / "pointvit.yaml")


def _run(root):
    runs = [r for r in glob.glob(os.path.join(root, "*", "*"))
            if os.path.isdir(r)]
    assert len(runs) == 1, runs
    run = runs[0]
    return run, os.path.join(run, "checkpoint", os.path.basename(run))


def _epochs(log):
    return [int(e) for e in re.findall(r"Epoch (\d+) LR", log)]


def test_cli_trains_tests_resumes_and_finetunes(tmp_path, capsys):
    root = str(tmp_path / "log")
    cfg = _tiny_cfg(tmp_path)
    common = ["--cfg", cfg, "--device", "cpu", "seed=3", f"root_dir={root}"]
    best_val = cli(common + ["epochs=2"])
    run, ckpt = _run(root)
    for f in ("log.txt", "cfg.yaml", "_ckpt_latest.pth", "_ckpt_best.pth"):
        path = ckpt + f if f.startswith("_") else os.path.join(run, f)
        assert os.path.exists(path), f
    log = open(os.path.join(run, "log.txt")).read()
    assert _epochs(log) == [1, 2]
    oas = [float(v) for v in re.findall(r"OA: ([0-9.]+)", log)]
    assert oas and all(np.isfinite(oas)) and 0.0 <= best_val <= 100.0
    counts = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(counts["launch_counts"]) >= {"fps", "knn", "gather_rows"}
    assert not any(counts["launch_counts"].values())  # plain versions
    saved = torch.load(ckpt + "_ckpt_latest.pth", weights_only=True)
    assert saved["epoch"] == 2
    assert "encoder.blocks.1.attn.qkv.weight" in saved["model"]

    oa = cli(common + ["mode=test", f"pretrained_path={ckpt}_ckpt_best.pth"])
    assert f"{oa:3.2f}" == f"{oas[-1]:3.2f}"

    best = cli(common + ["mode=resume", "epochs=3",
                         f"pretrained_path={ckpt}_ckpt_latest.pth"])
    log = open(os.path.join(run, "log.txt")).read()
    assert _epochs(log)[-1] == 3 and best >= best_val
    assert torch.load(ckpt + "_ckpt_latest.pth",
                      weights_only=True)["epoch"] == 3

    ft_root = str(tmp_path / "ft")
    cli(["--cfg", cfg, "--device", "cpu", "seed=3", f"root_dir={ft_root}",
         "mode=finetune", "epochs=1",
         f"pretrained_path={ckpt}_ckpt_best.pth"])
    ft_run, _ = _run(ft_root)
    ft_log = open(os.path.join(ft_run, "log.txt")).read()
    assert _epochs(ft_log) == [1] and "finetuning from" in ft_log


def test_cli_scanobjectnnc_then_resume(tmp_path):
    root = str(tmp_path / "log")
    common = ["--cfg", _tiny_cfg(tmp_path), "--device", "cpu", "seed=4",
              "mode=scanobjectnnc",
              f"scanobjectnn_c_dir={tmp_path / 'no_tree'}",
              f"root_dir={root}"]
    best = cli(common + ["epochs=1"])
    assert 0.0 <= best <= 100.0
    run, ckpt = _run(root)
    log = open(os.path.join(run, "log.txt")).read()
    assert "epoch variant: plain" in log and "skipping corruption eval" in log
    best2 = cli(common + ["epochs=2", "resume=True",
                          f"pretrained_path={ckpt}_ckpt_latest.pth"])
    log = open(os.path.join(run, "log.txt")).read()
    assert _epochs(log) == [1, 2] and best2 >= best
    assert torch.load(ckpt + "_ckpt_latest.pth",
                      weights_only=True)["epoch"] == 2
