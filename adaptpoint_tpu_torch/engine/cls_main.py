"""The classification experiment loop: modes ``train``, ``test``, ``val``,
``resume`` and ``finetune``.

Counterpart of ``adaptpoint_tpu/engine/cls_main.py`` (reference
examples/classification/train.py:52-319): the model, criterion, optimizer,
scheduler and loaders from the cfg; the epoch loop with validation every
``val_freq`` epochs, best and latest checkpoints and the learning rate set
per epoch; then the test of the last and of the best weights and
``write_to_csv``. ``mode: resume`` continues the ``pretrained_path``
checkpoint at its epoch + 1 with its optimizer's state and its
``best_val``; ``mode: finetune`` loads its weights only (the JAX package
also takes its optimizer state, where the file has one) and trains from
epoch 1.

The JAX package's two opt-in switches are read here, and only here:
``ADAPTPOINT_TPU_TRAIN_FUSED=1`` trains through the fused train-BN SA
stages (``make_train_step(..., fused_train_bn=True)``) and
``ADAPTPOINT_TPU_EVAL_FUSED=1`` evaluates through the fused eval SA stages
(``make_eval_step(..., fused_eval=True)``).

Not ported yet (they raise): ``scan_batches > 1`` and ``use_voting``.
"""
from __future__ import annotations

import csv
import logging
import os
import time
from typing import Optional

from ..datasets import build_dataloader_from_cfg
from ..device import resolve_device
from ..metricslog import Summary
from ..models import build_model_from_cfg
from ..utils.ckpt import load_checkpoint, resume_checkpoint, save_checkpoint
from ..utils.random import set_random_seed
from .cls_trainer import (TrainState, build_train_tools, make_eval_step,
                          make_train_step, train_one_epoch, validate)

__all__ = ["main", "print_cls_results", "write_to_csv", "fused_switches"]


def fused_switches() -> tuple:
    """``(fused_train_bn, fused_eval)`` from ``ADAPTPOINT_TPU_TRAIN_FUSED``
    and ``ADAPTPOINT_TPU_EVAL_FUSED`` (``1`` turns each on)."""
    return (os.environ.get("ADAPTPOINT_TPU_TRAIN_FUSED", "0") == "1",
            os.environ.get("ADAPTPOINT_TPU_EVAL_FUSED", "0") == "1")


def write_to_csv(oa, macc, accs, best_epoch, cfg, write_header=True):
    """Append the final results to ``cfg.csv_path``
    (reference train_autoaug.py:50-61)."""
    if not cfg.get("csv_path"):
        return
    classes = cfg.get("classes") or [str(i) for i in range(cfg.num_classes)]
    header = (["method", "OA", "mAcc"] + list(classes)
              + ["best_epoch", "log_path"])
    row = ([cfg.get("exp_name", cfg.get("run_name", "-")), f"{oa:.3f}",
            f"{macc:.2f}"] + [f"{a:.2f}" for a in accs]
           + [str(best_epoch), cfg.get("run_dir", "-")])
    new = not os.path.exists(cfg.csv_path)
    with open(cfg.csv_path, "a", newline="") as f:
        w = csv.writer(f)
        if write_header and new:
            w.writerow(header)
        w.writerow(row)


def print_cls_results(oa, macc, accs, epoch, cfg):
    s = "\nClasses\tAcc\n"
    classes = cfg.get("classes") or [str(i) for i in range(cfg.num_classes)]
    for name, acc in zip(classes, accs):
        s += "{:10}: {:3.2f}%\n".format(name, acc)
    s += f"E@{epoch}\tOA: {oa:3.2f}\tmAcc: {macc:3.2f}\n"
    logging.info(s)


def main(cfg, device: Optional[str] = None) -> Optional[float]:
    """Run ``cfg.mode`` on ``device`` (``None``: the card). Returns the best
    validation OA (``train``, ``resume``, ``finetune``) or the OA (``test``,
    ``val``)."""
    mode = cfg.get("mode", "train")
    if mode not in ("train", "test", "val", "resume", "finetune"):
        raise NotImplementedError(f"mode {mode} is not ported yet")
    if int(cfg.get("scan_batches", 1) or 1) > 1:
        raise NotImplementedError("scan_batches > 1 is not ported yet")
    if cfg.get("use_voting", False):
        raise NotImplementedError("use_voting is not ported yet")
    dev = resolve_device(device)
    seed = cfg.get("seed") or 0
    rng = set_random_seed(seed, dev,
                          deterministic=cfg.get("deterministic", False))
    if cfg.model.get("in_channels", None) is None:
        cfg.model.in_channels = cfg.model.encoder_args.in_channels
    model = build_model_from_cfg(cfg.model, device=dev, seed=seed)

    val_bs = cfg.get("val_batch_size", cfg.batch_size)
    val_loader = build_dataloader_from_cfg(
        val_bs, cfg.dataset, cfg.dataloader,
        datatransforms_cfg=cfg.datatransforms, split="val", seed=seed)
    try:  # ScanObjectNN tests on its test split for val and test alike
        test_loader = build_dataloader_from_cfg(
            val_bs, cfg.dataset, cfg.dataloader,
            datatransforms_cfg=cfg.datatransforms, split="test", seed=seed)
    except Exception:
        test_loader = val_loader
    if hasattr(val_loader.dataset, "classes"):
        cfg.classes = list(val_loader.dataset.classes)

    criterion, optimizer, lr_fn = build_train_tools(cfg, model)
    logging.info("Number of params: %.4f M",
                 sum(p.numel() for p in model.parameters()) / 1e6)
    fused_train_bn, fused_eval = fused_switches()
    logging.info("fused train-BN route: %s, fused eval route: %s",
                 fused_train_bn, fused_eval)
    state = TrainState(model, optimizer)
    train_step = make_train_step(model, optimizer, criterion, cfg,
                                 fused_train_bn=fused_train_bn)
    eval_step = make_eval_step(model, cfg, fused_eval=fused_eval)

    best_val = 0.0
    if cfg.get("pretrained_path"):
        if mode == "resume":
            _, best_val = resume_checkpoint(cfg, model, optimizer)
        elif mode == "finetune":  # the weights only, from epoch 1
            load_checkpoint(model, cfg.pretrained_path)
            logging.info("finetuning from %s", cfg.pretrained_path)
        else:
            epoch_loaded, _ = load_checkpoint(model, cfg.pretrained_path,
                                              optimizer)
        if mode in ("test", "val"):
            loader = test_loader if mode == "test" else val_loader
            macc, oa, accs, _ = validate(eval_step, state, loader, cfg)
            print_cls_results(oa, macc, accs, epoch_loaded, cfg)
            return oa
    elif mode in ("test", "val", "resume", "finetune"):
        raise ValueError(f"mode {mode} needs pretrained_path")

    train_loader = build_dataloader_from_cfg(
        cfg.batch_size, cfg.dataset, cfg.dataloader,
        datatransforms_cfg=cfg.datatransforms, split="train", seed=seed)
    logging.info("train size %d, val size %d", len(train_loader.dataset),
                 len(val_loader.dataset))
    summary = Summary(cfg.get("run_dir"))
    best_epoch, val_oa = 0, 0.0
    for epoch in range(cfg.get("start_epoch", 1), cfg.epochs + 1):
        train_loader.set_epoch(epoch)
        lr = lr_fn(epoch - 1)
        t0 = time.perf_counter()
        state, train_loss, _, train_oa, _, _ = train_one_epoch(
            train_step, state, train_loader, rng, lr, cfg)
        epoch_seconds = time.perf_counter() - t0
        is_best = False
        if epoch % cfg.val_freq == 0:
            val_macc, val_oa, val_accs, _ = validate(eval_step, state,
                                                     val_loader, cfg)
            is_best = val_oa > best_val
            if is_best:
                best_val, best_epoch = val_oa, epoch
                logging.info("Find a better ckpt @E%d", epoch)
                print_cls_results(val_oa, val_macc, val_accs, epoch, cfg)
        logging.info("Epoch %d LR %.6f train_oa %.2f val_oa %.2f best %.2f "
                     "epoch_seconds %.3f", epoch, lr, train_oa, val_oa,
                     best_val, epoch_seconds)
        for tag, value in (("train_loss", train_loss),
                           ("train_oa", train_oa), ("lr", lr),
                           ("val_oa", val_oa), ("best_val", best_val)):
            summary.add_scalar(tag, value, epoch)
        summary.flush()
        if cfg.get("run_name"):
            save_checkpoint(cfg, model, optimizer, epoch, is_best=is_best,
                            additional={"best_val": best_val})

    # the last weights, then the best (train.py:306-319)
    test_macc, test_oa, test_accs, _ = validate(eval_step, state,
                                                test_loader, cfg)
    print_cls_results(test_oa, test_macc, test_accs, cfg.epochs, cfg)
    write_to_csv(test_oa, test_macc, test_accs, best_epoch, cfg)
    if cfg.get("run_name"):
        best_path = os.path.join(cfg.ckpt_dir,
                                 f"{cfg.run_name}_ckpt_best.pth")
        if os.path.exists(best_path):
            epoch_best, _ = load_checkpoint(model, best_path)
            test_macc, test_oa, test_accs, _ = validate(eval_step, state,
                                                        test_loader, cfg)
            print_cls_results(test_oa, test_macc, test_accs, epoch_best,
                              cfg)
    summary.close()
    return best_val
