"""The port's ``mode: adaptpoint`` entry path on the CPU.

- ``python -m adaptpoint_tpu_torch.main --cfg
  cfgs/synthetic/pointnext-tiny_adaptpoint.yaml --device cpu`` runs phase A
  and phase B each epoch and leaves the GAN pair (``model_gan.pth``, which
  reloads into a fresh ``build_gan`` bit for bit), both checkpoints, the
  summaries (the per-step ``train_G_iter/*`` scalars with the hardratio)
  and, when asked, the fake-cloud h5 dumps; ``mode=test`` on the best
  checkpoint prints the OA the run's final test of it printed.
- Phase B's loader gives the JAX package's batches on the same fake buffer,
  and the hardratio schedule is the JAX package's at every epoch.
- The ScanObjectNN-C sweep: ``ScanObjectNNC`` gives the JAX package's
  samples on a synthetic h5 tree, ``eval_corrupt_wrapper`` its results and
  report for the same per-split accuracies, the sweep runs the port's
  model over every split of the tree, and a missing tree is skipped with a
  warning.
- Each switch the port lacks under ``mode: adaptpoint`` (``adaptpoint_fused``,
  ``scan_batches > 1``, ``use_voting``) raises and names its ``ROADMAP.md``
  item; a requested dump without ``h5py`` raises.
"""
import glob
import json
import logging
import os
import re
import types

import numpy as np
import pytest
import torch

from adaptpoint_tpu.adapt.feedback import update_hardratio as jax_hardratio
from adaptpoint_tpu.adapt.form_dataset import FormDatasetCls as JaxFake
from adaptpoint_tpu.datasets import NumpyLoader as JaxLoader
from adaptpoint_tpu.datasets.scanobjectnn import (
    CORRUPTIONS as JAX_CORRUPTIONS, ScanObjectNNC as JaxSONNC,
    eval_corrupt_wrapper as jax_wrapper)
from adaptpoint_tpu.transforms import build_transforms_from_cfg as jax_tf
from adaptpoint_tpu_torch.adapt.feedback import update_hardratio
from adaptpoint_tpu_torch.adapt.form_dataset import FormDatasetCls
from adaptpoint_tpu_torch.datasets import (CORRUPTIONS,
                                           DGCNN_OA_SCANOBJECTNN_C,
                                           ScanObjectNNC, eval_corrupt_wrapper)
from adaptpoint_tpu_torch.engine import adapt_main, train_gan_epoch
from adaptpoint_tpu_torch.engine.adapt_trainer import build_gan
from adaptpoint_tpu_torch.engine.cls_trainer import (TrainState,
                                                     make_eval_step)
from adaptpoint_tpu_torch.main import main as cli
from adaptpoint_tpu_torch.models import build_model_from_cfg
from adaptpoint_tpu_torch.transforms import build_transforms_from_cfg
from adaptpoint_tpu_torch.utils import EasyConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "cfgs", "synthetic", "pointnext-tiny_adaptpoint.yaml")
SONN = os.path.join(REPO, "cfgs", "scanobjectnn",
                    "pointnext-s_adaptpoint_1.yaml")


def _cfg(path=TINY, *opts):
    cfg = EasyConfig()
    cfg.load(path, recursive=True)
    cfg.update_opts(list(opts))
    return cfg


def test_cli_runs_both_phases_and_reproduces_its_test_oa(tmp_path, capsys):
    root = str(tmp_path / "log")
    common = ["--cfg", TINY, "--device", "cpu", "dataset.common.size=40",
              "seed=3", f"root_dir={root}"]
    best_val = cli(common + ["epochs=2", "dump_fakedata=True"])
    runs = glob.glob(os.path.join(root, "synthetic", "*"))
    assert len(runs) == 1, runs
    run = runs[0]
    name = os.path.basename(run)
    for f in ("log.txt", "cfg.yaml", "scalars.jsonl", "model_gan.pth",
              f"checkpoint/{name}_ckpt_latest.pth",
              f"checkpoint/{name}_ckpt_best.pth",
              "fakedata/epoch1/minibatch0.h5",
              "fakedata/epoch2/minibatch0.h5"):
        assert os.path.exists(os.path.join(run, f)), f
    log = open(os.path.join(run, "log.txt")).read()
    # 40 clouds, batches of 16: 2 steps of phase A, 32 fake clouds, 2 of B
    assert len(re.findall(r"phase_a_seconds [0-9.]+ phase_b_seconds "
                          r"[0-9.]+", log)) == 2
    assert log.count("phase B: 2 batches of 32 fake clouds") == 2
    assert "skipping corruption eval" in log
    moved = [float(v) for v in re.findall(
        r"mean \|fake - real\| ([0-9.eE+-]+)", log)]
    assert len(moved) == 2 and min(moved) > 0.0
    oas = [float(v) for v in re.findall(r"OA: ([0-9.]+)", log)]
    assert oas and all(np.isfinite(oas)) and 0.0 <= best_val <= 100.0

    scalars = [json.loads(ln) for ln in
               open(os.path.join(run, "scalars.jsonl"))]
    tags = [s["tag"] for s in scalars]
    for k in ("g_loss", "g_loss_raw", "d_loss", "feedback", "loss_fake",
              "loss_real", "hardratio"):
        steps = [s["step"] for s in scalars if s["tag"] == f"train_G_iter/{k}"]
        assert steps == [0, 1, 2, 3], k
    assert {s["value"] for s in scalars
            if s["tag"] == "train_G_iter/hardratio"} == {3.0}
    assert tags.count("train_loss") == 2 and tags.count("val_oa") == 2

    import h5py
    with h5py.File(os.path.join(run, "fakedata/epoch1/minibatch0.h5")) as f:
        assert f["pointcloud"].shape == f["raw"].shape == (16, 128, 3)
        assert f["label"].shape == (16,)
        assert not np.array_equal(f["pointcloud"][()], f["raw"][()])

    # the GAN pair reloads into a fresh build_gan, bit for bit
    saved = torch.load(os.path.join(run, "model_gan.pth"), weights_only=True)
    assert set(saved) == {"generator", "discriminator"}
    gen, dis, _, _, _ = build_gan(_cfg(), "cpu", 3)
    fresh = {"generator": gen.state_dict(), "discriminator": dis.state_dict()}
    assert any(not torch.equal(v, saved["generator"][k])
               for k, v in fresh["generator"].items()
               if v.is_floating_point())
    gen.load_state_dict(saved["generator"], strict=True)
    dis.load_state_dict(saved["discriminator"], strict=True)
    for part, module in (("generator", gen), ("discriminator", dis)):
        for k, v in module.state_dict().items():
            assert torch.equal(v, saved[part][k]), (part, k)

    counts = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert not any(counts["launch_counts"].values())  # plain versions
    best = os.path.join(run, "checkpoint", f"{name}_ckpt_best.pth")
    oa = cli(common + ["mode=test", f"pretrained_path={best}"])
    assert f"{oa:3.2f}" == f"{oas[-1]:3.2f}"  # the best checkpoint's test
    # adapt_main's own test mode evaluates the same checkpoint the same way
    cfg = _cfg(TINY, "dataset.common.size=40", "seed=3", "mode=test",
               f"pretrained_path={best}")
    assert adapt_main.main(cfg, device="cpu") == oa


@pytest.mark.parametrize("epoch", [1, 7])
def test_fake_loader_batches_equal_the_jax_loader(epoch):
    rng = np.random.default_rng(epoch)
    gens = [rng.standard_normal((8, 64, 3)).astype(np.float32)
            for _ in range(5)]
    labels = [rng.integers(0, 15, 8).astype(np.int64) for _ in range(5)]
    xs = [np.concatenate([g, rng.standard_normal((8, 64, 1)).astype(
        np.float32)], -1) for g in gens]
    seed = 11
    port = adapt_main.fake_loader(FormDatasetCls(gens, labels, xs), 16, seed,
                                  epoch)
    ref = JaxLoader(JaxFake(gens, labels, xs), 16, shuffle=True,
                    drop_last=True, seed=seed + epoch)
    assert len(port) == len(ref) == 2
    n = 0
    for pb, jb in zip(port, ref):
        assert set(pb) == set(jb)
        for key in jb:
            np.testing.assert_array_equal(pb[key], np.asarray(jb[key]),
                                          err_msg=key)
        n += 1
    assert n == 2


def test_hardratio_schedule_equals_jax():
    for start, end, epochs in ((3, 3, 300), (1.0, 3.0, 250), (2, 0.5, 7)):
        for epoch in range(1, epochs + 1):
            assert update_hardratio(start, end, epoch, epochs) \
                == jax_hardratio(start, end, epoch, epochs)


@pytest.fixture
def corrupt_dir(tmp_path):
    import h5py
    rng = np.random.default_rng(5)
    d = tmp_path / "scanobjectnn_c"
    d.mkdir()
    for c in CORRUPTIONS:
        splits = ["clean"] if c == "clean" else [f"{c}_{i}" for i in range(5)]
        for s in splits:
            with h5py.File(d / f"{s}.h5", "w") as f:
                f["data"] = (rng.standard_normal((6, 96, 3)) * 0.5 + 0.2
                             ).astype(np.float32)
                f["label"] = rng.integers(0, 5, (6, 1))
    return str(d)


def test_scanobjectnnc_samples_equal_jax(corrupt_dir):
    assert CORRUPTIONS == JAX_CORRUPTIONS
    cfg = _cfg(SONN)
    tcfg = cfg.datatransforms_scanobjectnn_c
    for split, tf in (("clean", None), ("rotate_3", tcfg),
                      ("add_local_0", tcfg)):
        port = ScanObjectNNC(data_dir=corrupt_dir, split=split,
                             num_points=64,
                             transform=tf and build_transforms_from_cfg(
                                 "val", tf))
        ref = JaxSONNC(data_dir=corrupt_dir, split=split, num_points=64,
                       transform=tf and jax_tf("val", tf))
        assert len(port) == len(ref) == 6
        for i in range(6):
            pg = port.get(i, np.random.default_rng(i))
            jg = ref.get(i, np.random.default_rng(i))
            assert set(pg) == set(jg) == {"pos", "x", "y"}
            for key in jg:
                np.testing.assert_array_equal(pg[key], np.asarray(jg[key]),
                                              err_msg=(split, key))
        assert pg["x"].shape == (64, 4 if tf else 3)
    with pytest.raises(FileNotFoundError):
        ScanObjectNNC(data_dir=corrupt_dir, split="jitter_9")


def test_eval_corrupt_wrapper_equals_jax(tmp_path):
    rng = np.random.default_rng(0)
    accs = {"clean": 0.91}
    for c in CORRUPTIONS[1:]:
        for level in range(5):
            accs[f"{c}_{level}"] = float(rng.uniform(0.3, 0.9))
    seen = []

    def fake_eval(split, tag):
        seen.append((tag, split))
        return {"acc": accs[split]}

    out = []
    for tag, wrapper in (("jax", jax_wrapper), ("port", eval_corrupt_wrapper)):
        d = tmp_path / tag
        d.mkdir()
        out.append((wrapper(fake_eval, {"tag": tag}, str(d), epoch=9),
                    (d / "outcorruption.txt").read_text()))
    (jres, jtxt), (pres, ptxt) = out
    assert pres == jres and ptxt == jtxt
    assert [s for t, s in seen if t == "port"] == \
        [s for t, s in seen if t == "jax"]
    assert len(seen) == 2 * 36 and "mCE" in pres["aggregate"]
    assert set(DGCNN_OA_SCANOBJECTNN_C) == set(CORRUPTIONS)


def _eval_parts(cfg):
    model = build_model_from_cfg(cfg.model, device="cpu", seed=0)
    state = TrainState(model, None)
    return make_eval_step(model, cfg), state


def test_sweep_runs_over_the_tree_and_skips_a_missing_one(corrupt_dir,
                                                          tmp_path, caplog):
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    cfg = _cfg(TINY, f"scanobjectnn_c_dir={corrupt_dir}",
               f"run_dir={run_dir}", "val_batch_size=4")
    eval_step, state = _eval_parts(cfg)
    adapt_main._corruption_eval(cfg, eval_step, state, 9)
    report = (run_dir / "outcorruption.txt").read_text()
    assert report.startswith("epoch: 9") and "mCE" in report
    assert report.count("'level': 'Overall'") == len(CORRUPTIONS)
    oa = adapt_main.validate_scanobjectnnc("jitter_1", eval_step, state,
                                           cfg)["acc"]
    assert 0.0 <= oa <= 1.0

    cfg.scanobjectnn_c_dir = str(tmp_path / "missing")
    with caplog.at_level(logging.WARNING):
        adapt_main._corruption_eval(cfg, eval_step, state, "final_best")
    assert "skipping corruption eval" in caplog.text
    assert report == (run_dir / "outcorruption.txt").read_text()


@pytest.mark.parametrize("opt,item", [
    ("adaptpoint_fused=True", "§A.5"), ("scan_batches=2", "§A.2"),
    ("use_voting=True", "§A.5")])
def test_what_the_port_lacks_under_adaptpoint_says_so(tmp_path, opt, item):
    with pytest.raises(NotImplementedError, match=f"not ported.*{item}"):
        cli(["--cfg", TINY, "--device", "cpu", opt, f"root_dir={tmp_path}"])


def test_a_requested_dump_without_h5py_raises(monkeypatch, tmp_path):
    monkeypatch.setitem(__import__("sys").modules, "h5py", None)
    cfg = _cfg(TINY, "dump_fakedata=True", f"run_dir={tmp_path}")
    state = types.SimpleNamespace(device=torch.device("cpu"))
    with pytest.raises(ImportError):
        train_gan_epoch(None, state, [], None, 3.0, cfg)
