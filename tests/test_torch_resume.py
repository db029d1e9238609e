"""Resuming and finetuning runs of the port, on the CPU, through its CLI
(``python -m adaptpoint_tpu_torch.main ... --device cpu``): the
counterparts of ``tests/test_resume_modes.py:18,51`` (``resume=True`` under
``mode: modelnetc`` and ``mode: adaptpoint``) and of the classifier's
``mode: resume`` / ``finetune``.

A run of one epoch is continued to two. The continued run reuses the
checkpoint's run directory, runs exactly one more epoch (epoch 2), and
starts it from what was saved, bit for bit: the classifier's tensors, the
optimizer's state (Adam's moments and step counts) and, for AdaptPoint,
the GAN pair's weights and batch statistics (whose Adam moments restart, as
in the JAX package). ``best_val`` carries over: the saved watermark is set
to 100, which no epoch can beat, and the continued run must end with it.
``mode: finetune`` takes the weights only and trains from epoch 1 in a new
run directory.
"""
import copy
import glob
import os
import re

import pytest
import torch

from adaptpoint_tpu_torch.engine import adapt_main, cls_main, corrupt_main
from adaptpoint_tpu_torch.main import main as cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "cfgs", "synthetic", "pointnext-tiny.yaml")
ADAPT = os.path.join(REPO, "cfgs", "synthetic",
                     "pointnext-tiny_adaptpoint.yaml")
MODELNET = os.path.join(REPO, "cfgs", "synthetic",
                        "pointnext-tiny_adaptpoint_modelnet.yaml")


def _tensors_equal(a, b, what):
    if isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            _tensors_equal(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _tensors_equal(x, y, f"{what}/{i}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu()), what
    else:
        assert a == b, what


def _first_run(tmp_path, cfg, *opts):
    root = str(tmp_path / "log")
    common = ["--cfg", cfg, "--device", "cpu", "dataset.common.size=32",
              "seed=2", f"root_dir={root}"] + list(opts)
    cli(common + ["epochs=1"])
    runs = glob.glob(os.path.join(root, "synthetic", "*"))
    assert len(runs) == 1, runs
    run = runs[0]
    name = os.path.basename(run)
    latest = os.path.join(run, "checkpoint", f"{name}_ckpt_latest.pth")
    saved = torch.load(latest, weights_only=True)
    assert saved["epoch"] == 1 and saved["optimizer"]["state"]
    # a watermark no epoch can beat: the continued run must keep it
    saved["best_val"] = 100.0
    torch.save(saved, latest)
    return common, run, latest, saved


class _Spy:
    """Records the tensors a run's first epoch starts from."""

    def __init__(self, monkeypatch, module, name, grab):
        self.seen = []
        fn = getattr(module, name)

        def spy(*args, **kwargs):
            if not self.seen:
                self.seen.append(grab(*args, **kwargs))
            return fn(*args, **kwargs)

        monkeypatch.setattr(module, name, spy)


def _cls_grab(step, state, *args, **kwargs):
    return {"model": {k: v.clone() for k, v in
                      state.model.state_dict().items()},
            "optimizer": copy.deepcopy(state.optimizer.state_dict())}


def _continued(run, latest, epochs_before):
    log = open(os.path.join(run, "log.txt")).read()
    epochs = [int(e) for e in re.findall(r"Epoch (\d+) LR", log)]
    assert epochs == epochs_before + [2], epochs
    after = torch.load(latest, weights_only=True)
    assert after["epoch"] == 2 and after["best_val"] == 100.0
    return log


def test_cls_mode_resume_continues_the_run(tmp_path, monkeypatch):
    common, run, latest, saved = _first_run(tmp_path, TINY)
    spy = _Spy(monkeypatch, cls_main, "train_one_epoch", _cls_grab)
    best = cli(common + ["epochs=2", "mode=resume",
                         f"pretrained_path={latest}"])
    assert best == 100.0
    assert len(glob.glob(os.path.join(os.path.dirname(run), "*"))) == 1
    assert os.path.exists(os.path.join(run, "cfg_resume.yaml"))
    _continued(run, latest, [1])
    _tensors_equal(spy.seen[0]["model"], saved["model"], "model")
    _tensors_equal(spy.seen[0]["optimizer"], saved["optimizer"], "optimizer")


def test_cls_mode_finetune_takes_the_weights_only(tmp_path, monkeypatch):
    common, run, latest, saved = _first_run(tmp_path, TINY)
    spy = _Spy(monkeypatch, cls_main, "train_one_epoch", _cls_grab)
    root2 = str(tmp_path / "log2")
    best = cli([o if not o.startswith("root_dir") else f"root_dir={root2}"
                for o in common] + ["epochs=1", "mode=finetune",
                                    f"pretrained_path={latest}"])
    assert 0.0 <= best <= 100.0
    _tensors_equal(spy.seen[0]["model"], saved["model"], "model")
    assert spy.seen[0]["optimizer"]["state"] == {}  # a fresh optimizer
    run2 = glob.glob(os.path.join(root2, "synthetic", "*"))[0]
    log = open(os.path.join(run2, "log.txt")).read()
    assert re.findall(r"Epoch (\d+) LR", log) == ["1"]
    assert "finetuning from" in log


@pytest.mark.parametrize("mode", ["resume", "finetune"])
def test_cls_modes_need_a_checkpoint(tmp_path, mode):
    with pytest.raises(ValueError, match="needs pretrained_path"):
        cli(["--cfg", TINY, "--device", "cpu", f"mode={mode}",
             f"root_dir={tmp_path}"])


def test_corrupt_mode_resume_continues_the_run(tmp_path, monkeypatch):
    """``tests/test_resume_modes.py:18`` for the port: ``resume=True`` under
    ``mode: modelnetc`` (the sweep skipped without a tree)."""
    common, run, latest, saved = _first_run(tmp_path, TINY,
                                            "mode=modelnetc")
    spy = _Spy(monkeypatch, corrupt_main, "train_one_epoch", _cls_grab)
    best = cli(common + ["epochs=2", "resume=True",
                         f"pretrained_path={latest}"])
    assert best == 100.0
    _continued(run, latest, [1])
    _tensors_equal(spy.seen[0]["model"], saved["model"], "model")
    _tensors_equal(spy.seen[0]["optimizer"], saved["optimizer"], "optimizer")


@pytest.mark.parametrize("cfg", [ADAPT, MODELNET],
                         ids=["adaptpoint", "adaptpoint_modelnet_rsmix"])
def test_adapt_mode_resume_continues_the_run(tmp_path, monkeypatch, cfg):
    """``tests/test_resume_modes.py:51`` for the port: ``resume=True`` under
    ``mode: adaptpoint`` and under ``mode: adaptpoint_modelnet`` with
    RSMix in phase B; the GAN pair comes back from ``model_gan.pth``."""
    common, run, latest, saved = _first_run(tmp_path, cfg)
    gan = torch.load(os.path.join(run, "model_gan.pth"), weights_only=True)
    classifier = []
    make = adapt_main.make_gan_step

    def record(generator, discriminator, g_opt, d_opt, cls_model, cfg_):
        classifier.append(cls_model)
        return make(generator, discriminator, g_opt, d_opt, cls_model, cfg_)

    monkeypatch.setattr(adapt_main, "make_gan_step", record)

    def grab(gan_step, gan_state, *args, **kwargs):
        return {"model": {k: v.clone() for k, v in
                          classifier[0].state_dict().items()},
                "generator": {k: v.clone() for k, v in
                              gan_state.generator.state_dict().items()},
                "discriminator": {k: v.clone() for k, v in
                                  gan_state.discriminator.state_dict()
                                  .items()},
                "g_opt": copy.deepcopy(gan_state.g_opt.state_dict()["state"]),
                "d_opt": copy.deepcopy(gan_state.d_opt.state_dict()["state"])}

    spy = _Spy(monkeypatch, adapt_main, "train_gan_epoch", grab)
    opt_spy = _Spy(monkeypatch, adapt_main, "train_one_epoch"
                   if cfg == ADAPT else "train_one_epoch_rsmix",
                   lambda step, state, *a, **k: copy.deepcopy(
                       state.optimizer.state_dict()))
    best = cli(common + ["epochs=2", "resume=True",
                         f"pretrained_path={latest}"])
    assert best == 100.0
    log = _continued(run, latest, [1])
    assert "resumed GAN pair from" in log and "phase B:" in log
    seen = spy.seen[0]
    _tensors_equal(seen["model"], saved["model"], "model")
    _tensors_equal(seen["generator"], gan["generator"], "generator")
    _tensors_equal(seen["discriminator"], gan["discriminator"],
                   "discriminator")
    assert seen["g_opt"] == {} and seen["d_opt"] == {}  # moments restart
    # phase A leaves the classifier's optimizer alone: phase B starts from
    # the saved state
    _tensors_equal(opt_spy.seen[0], saved["optimizer"], "optimizer")
