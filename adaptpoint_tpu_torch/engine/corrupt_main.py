"""Baseline training with the corruption sweep (``mode: scanobjectnnc`` /
``modelnetc``) and the PointWOLF, RSMix and WolfMix augmentation baselines.

Counterpart of ``adaptpoint_tpu/engine/corrupt_main.py`` (reference
examples/classification/train_scanobjectnnc.py:54-369 and
train_pointwolf_utils.py:25-269). The cfg picks the epoch: ``pointwolf``
deforms each batch's xyz on the device before the step's resampling
(:func:`make_train_step_pointwolf`); ``rsmix_params`` mixes each batch on
the host in numpy, as the reference does, and trains on the two labels
weighted by lambda (:func:`make_train_step_mixed`,
:func:`train_one_epoch_rsmix`); ``wolfmix`` does both, with its parameters
nested under ``cfg.wolfmix``; a ``wolfmix`` that is not a mapping with
both (``wolfmix: True``, as ``cfgs/modelnetc/pointnet++_wolfmix.yaml``
sets it) is refused before anything is built (:func:`check_wolfmix`: the
JAX package fails on it at its first epoch). Every 20 epochs, and on the
best and the
latest checkpoints at the end, the ScanObjectNN-C or (``mode: modelnetc``)
ModelNet-C sweep runs; a missing tree is logged and the sweep skipped.
``test=True`` with ``pretrained_path`` only sweeps the checkpoint;
``resume=True`` continues it at its epoch + 1.

The classifier's steps are ``cls_main``'s, with its two switches
(``fused_switches``) for training and evaluation.
"""
from __future__ import annotations

import logging
import os
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch
from torch import nn

from ..adapt.pointwolf import pointwolf
from ..adapt.rsmix import rsmix
from ..datasets import build_dataloader_from_cfg, eval_corrupt_wrapper
from ..datasets.modelnet import eval_corrupt_wrapper_modelnetc
from ..device import resolve_device
from ..metricslog import Summary
from ..models import build_model_from_cfg
from ..utils.ckpt import load_checkpoint, resume_checkpoint, save_checkpoint
from ..utils.metrics import AverageMeter, ConfusionMatrix
from ..utils.random import set_random_seed
from .cls_main import fused_switches, print_cls_results
from .cls_trainer import (TrainState, build_train_tools, make_eval_step,
                          make_train_step, train_one_epoch, validate)

__all__ = ["main", "make_train_step_pointwolf", "make_train_step_mixed",
           "train_one_epoch_rsmix", "check_wolfmix"]


def check_wolfmix(cfg) -> None:
    """Raise ValueError where ``cfg.wolfmix`` is set but is not a mapping
    holding ``rsmix_params`` and ``pointwolf``: a bare ``wolfmix: True``
    leaves WolfMix without parameters, and the JAX package fails on it
    (``cfg.wolfmix.rsmix_params``) at its first epoch."""
    wm = cfg.get("wolfmix")
    if wm is None:
        return
    if not hasattr(wm, "get") or wm.get("rsmix_params") is None \
            or wm.get("pointwolf") is None:
        raise ValueError(
            f"wolfmix must be a mapping with rsmix_params and pointwolf "
            f"(the WolfMix epoch reads its parameters from cfg.wolfmix), got "
            f"wolfmix: {wm!r}; nest the cfg's top-level pointwolf and "
            f"rsmix_params under wolfmix, or drop wolfmix")


def _wolf_args(pw) -> tuple:
    pw = dict(pw)
    return (int(pw.get("w_num_anchor", 4)), float(pw.get("w_sigma", 0.5)),
            float(pw.get("w_R_range", 10)), float(pw.get("w_S_range", 3)),
            float(pw.get("w_T_range", 0.25)))


def make_train_step_pointwolf(model: nn.Module,
                              optimizer: torch.optim.Optimizer,
                              criterion: Callable, cfg,
                              fused_train_bn: bool = False) -> Callable:
    """``train_step(state, batch, gen_or_cols, lr, dropout_mask=None,
    wolf=None)``: PointWOLF (``cfg.pointwolf``) on the batch's xyz, then
    ``make_train_step``'s step (parity: train_pointwolf_utils.py:25-88).
    ``wolf`` holds the deformation's draws (``adapt.WolfDraws``); without
    it they come from ``gen_or_cols`` where that is a generator (before the
    step's own draws), else from the default generator."""
    step = make_train_step(model, optimizer, criterion, cfg, fused_train_bn)
    args = _wolf_args(cfg.pointwolf)

    def train_step(state, batch, gen_or_cols=None, lr=None,
                   dropout_mask=None, wolf=None):
        x = batch["x"]
        if wolf is None and isinstance(gen_or_cols, torch.Generator):
            wolf = gen_or_cols
        _, new_xyz = pointwolf(wolf, x[..., :3].contiguous(), *args)
        batch = dict(batch, x=torch.cat([new_xyz, x[..., 3:]], dim=-1))
        return step(state, batch, gen_or_cols, lr, dropout_mask)

    return train_step


def make_train_step_mixed(model: nn.Module, optimizer: torch.optim.Optimizer,
                          criterion: Callable, cfg,
                          fused_train_bn: bool = False) -> Callable:
    """``make_train_step``'s step on a mixed batch (``x``, ``y`` the first
    labels, ``y_b`` the partners', ``lam`` each cloud's share of the
    partner's points): the loss is ``mean((1 - lam) * la + lam * lb)`` of
    the criterion's per-sample losses (parity:
    train_pointwolf_utils.py:150-157)."""

    def mixed_loss(logits, batch):
        lam = batch["lam"]
        la = criterion.per_sample(logits, batch["y"])
        lb = criterion.per_sample(logits, batch["y_b"])
        return ((1.0 - lam) * la + lam * lb).mean()

    return make_train_step(model, optimizer, criterion, cfg, fused_train_bn,
                           batch_loss=mixed_loss)


def train_one_epoch_rsmix(train_step_mixed: Callable, state: TrainState,
                          loader: Iterable, rng: Optional[torch.Generator],
                          lr: float, cfg, apply_pointwolf: bool = False,
                          np_rng: Optional[np.random.Generator] = None):
    """One RSMix (``apply_pointwolf``: WolfMix) epoch: each batch mixed on
    the host with ``np_rng`` (default: ``np.random.default_rng`` seeded from
    ``rng``), with probability ``rsmix_prob`` where ``beta > 0``, else
    passed with ``lam = 0``; WolfMix first deforms the batch by PointWOLF on
    the device with ``rng``'s draws. Its parameters nest under
    ``cfg.wolfmix`` (parity: train_pointwolf_utils.py:90-269). Losses and
    predictions stay on the device until the last batch.

    Returns ``(state, mean loss, macc, oa, per-class accs, cm)``; the
    accuracy counts the first labels."""
    params = dict(cfg["wolfmix"]["rsmix_params"] if apply_pointwolf
                  else cfg["rsmix_params"])
    if np_rng is None:
        seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=rng,
                             device=rng.device if rng is not None else "cpu")
        np_rng = np.random.default_rng(int(seed))
    wolf_args = (_wolf_args(cfg["wolfmix"]["pointwolf"]) if apply_pointwolf
                 else None)
    device = state.device
    losses, preds, labels = [], [], []
    for batch in loader:
        points = np.asarray(batch["x"], np.float32)
        if apply_pointwolf:
            x = torch.as_tensor(points).to(device)
            _, new_xyz = pointwolf(rng, x[..., :3].contiguous(), *wolf_args)
            points = points.copy()
            points[..., :3] = new_xyz.cpu().numpy()
        y = np.asarray(batch["y"])
        r = np_rng.random()  # drawn for every batch, as the reference does
        if params["beta"] > 0 and r < params["rsmix_prob"]:
            mixed, lam, y_a, y_b = rsmix(points, y, beta=params["beta"],
                                         n_sample=params["nsample"],
                                         knn=params["knn"], rng=np_rng)
        else:
            mixed, lam, y_a, y_b = points, np.zeros(len(y), np.float32), y, y
        dev_batch = {
            "x": torch.as_tensor(mixed, dtype=torch.float32).to(
                device, non_blocking=True),
            "y": torch.as_tensor(y_a).to(device, torch.int64),
            "y_b": torch.as_tensor(y_b).to(device, torch.int64),
            "lam": torch.as_tensor(lam, dtype=torch.float32).to(device)}
        state, loss, pred = train_step_mixed(state, dev_batch, rng, lr)
        losses.append(loss)
        preds.append(pred)
        labels.append(dev_batch["y"])
    loss_meter = AverageMeter()
    cm = ConfusionMatrix(num_classes=cfg.num_classes)
    if losses:
        for v in torch.stack(losses).cpu().tolist():
            loss_meter.update(v)
        cm.update(torch.cat(preds), torch.cat(labels))
    macc, oa, accs = cm.all_acc()
    return state, loss_meter.avg, macc, oa, accs, cm


def _corruption_eval(cfg, eval_step, state, epoch) -> None:
    """The ModelNet-C sweep under ``mode: modelnetc`` and
    ``adaptpoint_modelnet``, else the ScanObjectNN-C sweep; skipped with a
    warning where the data is missing (``corrupt_main.py:171-184``,
    ``adapt_main.py:261-274``)."""
    from .adapt_main import validate_scanobjectnnc
    eval_args = {"eval_step": eval_step, "state": state, "cfg": cfg}
    try:
        if cfg.get("mode") in ("modelnetc", "adaptpoint_modelnet"):
            eval_corrupt_wrapper_modelnetc(eval_args, cfg.get("run_dir"),
                                           epoch)
        else:
            eval_corrupt_wrapper(validate_scanobjectnnc, eval_args,
                                 cfg.get("run_dir"), epoch)
    except FileNotFoundError as e:
        logging.warning("skipping corruption eval: %s", e)


def main(cfg, device: Optional[str] = None) -> Optional[float]:
    """Run the corruption-mode trainer on ``device`` (``None``: the card).
    Returns the best validation OA (``None`` where ``test`` only swept)."""
    if not (cfg.get("pretrained_path") and cfg.get("test")):
        check_wolfmix(cfg)
    dev = resolve_device(device)
    seed = cfg.get("seed") or 0
    rng = set_random_seed(seed, dev,
                          deterministic=cfg.get("deterministic", False))
    if cfg.model.get("in_channels", None) is None:
        cfg.model.in_channels = cfg.model.encoder_args.in_channels
    model = build_model_from_cfg(cfg.model, device=dev, seed=seed)

    val_loader = build_dataloader_from_cfg(
        cfg.get("val_batch_size", cfg.batch_size), cfg.dataset,
        cfg.dataloader, datatransforms_cfg=cfg.datatransforms, split="val",
        seed=seed)
    if hasattr(val_loader.dataset, "classes"):
        cfg.classes = list(val_loader.dataset.classes)
    criterion, optimizer, lr_fn = build_train_tools(cfg, model)
    fused_train_bn, fused_eval = fused_switches()
    logging.info("fused train-BN route: %s, fused eval route: %s",
                 fused_train_bn, fused_eval)
    state = TrainState(model, optimizer)
    eval_step = make_eval_step(model, cfg, fused_eval=fused_eval)

    if cfg.get("pretrained_path") and cfg.get("test"):
        epoch_loaded, _ = load_checkpoint(model, cfg.pretrained_path)
        _corruption_eval(cfg, eval_step, state, epoch_loaded)
        return None
    resumed_best = 0.0
    if cfg.get("resume") and cfg.get("pretrained_path"):
        _, resumed_best = resume_checkpoint(cfg, model, optimizer)

    train_loader = build_dataloader_from_cfg(
        cfg.batch_size, cfg.dataset, cfg.dataloader,
        datatransforms_cfg=cfg.datatransforms, split="train", seed=seed)
    use_wolfmix = cfg.get("wolfmix") is not None
    use_pointwolf = cfg.get("pointwolf") is not None and not use_wolfmix
    use_rsmix = cfg.get("rsmix_params") is not None and not use_wolfmix
    if use_pointwolf:
        train_step = make_train_step_pointwolf(model, optimizer, criterion,
                                               cfg, fused_train_bn)
    elif use_rsmix or use_wolfmix:
        train_step = make_train_step_mixed(model, optimizer, criterion, cfg,
                                           fused_train_bn)
    else:
        train_step = make_train_step(model, optimizer, criterion, cfg,
                                     fused_train_bn=fused_train_bn)
    logging.info("epoch variant: %s", "pointwolf" if use_pointwolf else
                 "wolfmix" if use_wolfmix else "rsmix" if use_rsmix else
                 "plain")
    logging.info("train size %d, val size %d", len(train_loader.dataset),
                 len(val_loader.dataset))

    summary = Summary(cfg.get("run_dir"))
    best_val, val_oa = float(resumed_best or 0.0), 0.0
    for epoch in range(cfg.get("start_epoch", 1), cfg.epochs + 1):
        train_loader.set_epoch(epoch)
        lr = lr_fn(epoch - 1)
        t0 = time.perf_counter()
        if use_rsmix or use_wolfmix:
            state, train_loss, _, train_oa, _, _ = train_one_epoch_rsmix(
                train_step, state, train_loader, rng, lr, cfg,
                apply_pointwolf=use_wolfmix)
        else:
            state, train_loss, _, train_oa, _, _ = train_one_epoch(
                train_step, state, train_loader, rng, lr, cfg)
        epoch_seconds = time.perf_counter() - t0
        if (epoch + 1) % 20 == 0:
            _corruption_eval(cfg, eval_step, state, epoch)
        is_best = False
        if epoch % cfg.val_freq == 0:
            val_macc, val_oa, val_accs, _ = validate(eval_step, state,
                                                     val_loader, cfg)
            is_best = val_oa > best_val
            if is_best:
                best_val = val_oa
                print_cls_results(val_oa, val_macc, val_accs, epoch, cfg)
        logging.info("Epoch %d LR %.6f train_oa %.2f val_oa %.2f best %.2f "
                     "epoch_seconds %.3f", epoch, lr, train_oa, val_oa,
                     best_val, epoch_seconds)
        for tag, value in (("train_loss", train_loss),
                           ("train_oa", train_oa), ("val_oa", val_oa)):
            summary.add_scalar(tag, value, epoch)
        summary.flush()
        if cfg.get("run_name"):
            save_checkpoint(cfg, model, optimizer, epoch, is_best=is_best,
                            additional={"best_val": best_val})

    # the final sweeps, on the best and on the latest weights
    # (train_scanobjectnnc.py:243-246)
    if cfg.get("run_name"):
        for tag in ("best", "latest"):
            path = os.path.join(cfg.ckpt_dir,
                                f"{cfg.run_name}_ckpt_{tag}.pth")
            if os.path.exists(path):
                load_checkpoint(model, path)
                _corruption_eval(cfg, eval_step, state, f"final_{tag}")
    summary.close()
    return best_val
