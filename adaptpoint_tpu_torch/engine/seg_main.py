"""The S3DIS scene-segmentation experiment loop: modes ``train``, ``val``,
``test`` and ``resume``.

Counterpart of ``adaptpoint_tpu/engine/seg_main.py`` (reference
examples/segmentation/main.py:112-730, its core path). The train step is
f32: the train-mode forward of ``BaseSeg`` on the batch's ``pos`` and the
features named by ``feature_keys`` (``x,heights`` for S3DIS: the colours
and the height, ``in_channels: 4``), the criterion over every point's
logits (label-smoothed cross entropy, with ``cls_weighed_loss`` weighted by
``get_class_weights`` of the validation set's class counts), global-norm
clipping (optax's rule), and the optimizer and schedule of the cfg (AdamW,
cosine). Validation fills a confusion matrix over every point of every
crop and reports mIoU, mAcc and OA (``get_mious``); the predictions come
back from the device after the last batch.

``mode: test`` / ``val`` evaluate ``pretrained_path``; ``mode: resume``
continues it at its epoch + 1 with its optimizer's state and ``best_val``.
A checkpoint is written every epoch (``_ckpt_best`` where the epoch's mIoU
is the best), as in the JAX package. The two opt-in switches of
``cls_main.fused_switches`` select the fused train-BN and the fused eval SA
routes. Not ported yet, and refused: the sphere protocol (``S3DISSphere``,
``validate_sphere``, ``MaskedCrossEntropy``) and ``mode: test_6fold``.
"""
from __future__ import annotations

import logging
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch
from torch import nn

from ..datasets import build_dataloader_from_cfg
from ..datasets.data_util import get_class_weights
from ..device import resolve_device
from ..metricslog import Summary
from ..models import build_model_from_cfg
from ..optim import clip_by_global_norm_, set_lr
from ..utils.ckpt import load_checkpoint, resume_checkpoint, save_checkpoint
from ..utils.metrics import AverageMeter, ConfusionMatrix, get_mious
from ..utils.random import set_random_seed
from .cls_main import fused_switches
from .cls_trainer import TrainState, build_train_tools

__all__ = ["main", "MODES", "seg_batch", "make_seg_train_step",
           "make_seg_eval_step", "validate_seg", "train_seg_epoch"]

MODES = ("train", "val", "test", "resume")
NOT_PORTED = ("test_6fold",)


def seg_batch(batch, device: torch.device, cfg) -> dict:
    """A loader batch as device tensors: ``pos`` (f32), ``x`` the features
    ``cfg.feature_keys`` names (``pos``, ``x``, ``heights``; default
    ``pos,heights``) side by side in that order, ``y`` (int64)."""
    keys = cfg.get("feature_keys", "pos,heights").split(",")
    for k in keys:
        if k not in ("pos", "x", "heights"):
            raise ValueError(f"unknown feature key {k}")
    parts = [np.asarray(batch[k], np.float32) for k in keys]
    x = np.concatenate(parts, axis=-1) if len(parts) > 1 else parts[0]

    def dev(v, dtype):
        return torch.as_tensor(v).to(device, dtype, non_blocking=True)

    return {"pos": dev(batch["pos"], torch.float32).contiguous(),
            "x": dev(x, torch.float32).contiguous(),
            "y": dev(batch["y"], torch.int64)}


def make_seg_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                        criterion: Callable, cfg,
                        fused_train_bn: bool = False) -> Callable:
    """``train_step(state, batch, lr=None, dropout_mask=None,
    generator=None) -> (state, loss, preds)``.

    ``batch`` holds device tensors ``pos (B, N, 3)``, ``x (B, N, C)`` and
    ``y (B, N)`` (:func:`seg_batch`). The head's dropout keep-mask (B, N,
    C') is ``dropout_mask``, or drawn from ``generator`` (``None``: the
    default one). ``fused_train_bn`` sends the encoder's standard SA stages
    through the fused train-BN op where they fit. ``loss`` and ``preds (B,
    N)`` are device tensors."""
    clip = cfg.get("grad_norm_clip")
    if str(cfg.get("optimizer", {}).get("NAME", "")).lower() == "adahessian":
        raise NotImplementedError("the adahessian train step is not ported "
                                  "yet")
    params = [p for group in optimizer.param_groups for p in group["params"]]

    def train_step(state: TrainState, batch, lr: Optional[float] = None,
                   dropout_mask=None,
                   generator: Optional[torch.Generator] = None):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        logits = model(batch["pos"], batch["x"], dropout_mask=dropout_mask,
                       generator=generator, fused_train_bn=fused_train_bn)
        loss = criterion(logits.float(), batch["y"])
        loss.backward()
        if clip is not None and clip > 0:
            clip_by_global_norm_([p.grad for p in params
                                  if p.grad is not None], float(clip))
        if lr is not None:
            set_lr(optimizer, lr)
        optimizer.step()
        state.step += 1
        return state, loss.detach(), logits.detach().argmax(dim=-1)

    return train_step


def make_seg_eval_step(model: nn.Module,
                       fused_eval: bool = False) -> Callable:
    """``eval_step(state, batch) -> preds (B, N)``: the eval forward, on the
    fused route when asked."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch):
        model.eval()
        return model(batch["pos"], batch["x"],
                     fused_eval=fused_eval).argmax(dim=-1)

    return eval_step


def validate_seg(eval_step: Callable, state: TrainState, loader: Iterable,
                 cfg) -> dict:
    """``{"miou", "macc", "oa", "ious", "accs"}`` (percent) over every point
    of ``loader``'s crops. A padded last batch says how many of its rows are
    real in ``n_valid``; the rest are cut before they are counted."""
    cm = ConfusionMatrix(num_classes=cfg.num_classes,
                         ignore_index=cfg.get("ignore_index"))
    device = state.device
    pending = []
    for batch in loader:
        batch = dict(batch)
        n_valid = int(batch.pop("n_valid", len(batch["y"])))
        pending.append((eval_step(state, seg_batch(batch, device, cfg)),
                        np.asarray(batch["y"]), n_valid))
    for preds, y, n_valid in pending:
        cm.update(preds[:n_valid], y[:n_valid])
    miou, macc, oa, ious, accs = get_mious(cm.tp, cm.union, cm.count)
    return {"miou": miou, "macc": macc, "oa": oa, "ious": ious.tolist(),
            "accs": accs.tolist()}


def train_seg_epoch(train_step: Callable, state: TrainState,
                    loader: Iterable, rng: Optional[torch.Generator],
                    lr: float, cfg):
    """One epoch over ``loader``; the dropout masks come from ``rng``. The
    losses stay on the device until the last batch is enqueued. Returns
    ``(state, mean loss)``."""
    device = state.device
    losses = []
    for batch in loader:
        state, loss, _ = train_step(state, seg_batch(batch, device, cfg), lr,
                                    generator=rng)
        losses.append(loss)
    meter = AverageMeter()
    if losses:
        for v in torch.stack(losses).cpu().tolist():
            meter.update(v)
    return state, meter.avg


def main(cfg, device: Optional[str] = None):
    """Run ``cfg.mode`` on ``device`` (``None``: the card). Returns the best
    mIoU (``train``, ``resume``) or the metrics of ``validate_seg``
    (``test``, ``val``)."""
    mode = cfg.get("mode", "train")
    if mode in NOT_PORTED:
        raise NotImplementedError(f"mode {mode} is not ported yet")
    if mode not in MODES:
        raise NotImplementedError(f"mode {mode} is not ported for scene "
                                  f"segmentation")
    if "sphere" in str(cfg.dataset.common.NAME).lower():
        raise NotImplementedError("the sphere protocol (S3DISSphere, "
                                  "validate_sphere) is not ported yet")
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

    criterion, optimizer, lr_fn = build_train_tools(cfg, model)
    if cfg.get("cls_weighed_loss", False) and hasattr(val_loader.dataset,
                                                      "num_per_class"):
        criterion.weight = torch.as_tensor(get_class_weights(
            val_loader.dataset.num_per_class, normalize=True))
    logging.info("Number of params: %.4f M",
                 sum(p.numel() for p in model.parameters()) / 1e6)
    fused_train_bn, fused_eval = fused_switches()
    logging.info("fused train-BN route: %s, fused eval route: %s",
                 fused_train_bn, fused_eval)
    state = TrainState(model, optimizer)
    train_step = make_seg_train_step(model, optimizer, criterion, cfg,
                                     fused_train_bn=fused_train_bn)
    eval_step = make_seg_eval_step(model, fused_eval=fused_eval)

    if mode in ("test", "val"):
        if not cfg.get("pretrained_path"):
            raise ValueError(f"mode {mode} needs pretrained_path")
        load_checkpoint(model, cfg.pretrained_path)
        perf = validate_seg(eval_step, state, val_loader, cfg)
        logging.info("test: miou %.2f macc %.2f oa %.2f", perf["miou"],
                     perf["macc"], perf["oa"])
        return perf

    resumed_best = 0.0
    if mode == "resume":
        if not cfg.get("pretrained_path"):
            raise ValueError("mode resume needs pretrained_path")
        # the model, its optimizer, epoch + 1 and best_val
        _, resumed_best = resume_checkpoint(cfg, model, optimizer)
    train_loader = build_dataloader_from_cfg(
        cfg.batch_size, cfg.dataset, cfg.dataloader,
        datatransforms_cfg=cfg.datatransforms, split="train", seed=seed)
    logging.info("train size %d, val size %d", len(train_loader.dataset),
                 len(val_loader.dataset))

    summary = Summary(cfg.get("run_dir"))
    best_miou = float(resumed_best or 0.0)
    for epoch in range(cfg.get("start_epoch", 1), cfg.epochs + 1):
        train_loader.set_epoch(epoch)
        lr = lr_fn(epoch - 1)
        t0 = time.perf_counter()
        state, train_loss = train_seg_epoch(train_step, state, train_loader,
                                            rng, lr, cfg)
        train_s = time.perf_counter() - t0
        perf = {"miou": 0.0, "macc": 0.0, "oa": 0.0}
        is_best = False
        if epoch % cfg.val_freq == 0:
            perf = validate_seg(eval_step, state, val_loader, cfg)
            is_best = perf["miou"] > best_miou
            if is_best:
                best_miou = perf["miou"]
        logging.info("Epoch %d LR %.6f loss %.4f miou %.2f macc %.2f oa %.2f "
                     "best %.2f train_seconds %.3f", epoch, lr, train_loss,
                     perf["miou"], perf["macc"], perf["oa"], best_miou,
                     train_s)
        summary.add_scalar("train_loss", train_loss, epoch)
        for k in ("miou", "macc", "oa"):
            summary.add_scalar(f"val_{k}", perf[k], epoch)
        summary.flush()
        if cfg.get("run_name"):
            save_checkpoint(cfg, model, optimizer, epoch, is_best=is_best,
                            additional={"best_val": best_miou})
    summary.close()
    return best_miou
