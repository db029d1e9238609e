"""The AdaptPoint experiment loop: ``mode: adaptpoint`` and
``adaptpoint_modelnet``.

Counterpart of ``adaptpoint_tpu/engine/adapt_main.py`` (reference
examples/classification/train_autoaug.py:242-461). Each epoch past
``adaptpoint_adjustepoch``: (A) the augmentor and the discriminator train
over the whole train loader against the frozen classifier's feedback
(``train_gan_epoch``, under the card's default compute policy, bf16), and
the generated clouds are kept; the GAN pair is saved to
``<run_dir>/model_gan.pth``; (B) the classifier trains one epoch on those
clouds, shuffled with ``seed + epoch`` (with ``rsmix_params``, mixed by
RSMix on the host: ``corrupt_main.train_one_epoch_rsmix``). Earlier epochs
train the classifier on the real loader. Then, every 10 epochs, the
ScanObjectNN-C sweep (``mode: adaptpoint_modelnet``: every 20 epochs, the
ModelNet-C sweep); validation every ``val_freq`` epochs, summaries and
checkpoints; at the end the test of the last and of the best weights, each
with its sweep. A missing corruption tree is logged and the sweep skipped,
as in the JAX package. ``mode: test`` / ``val`` with ``pretrained_path``
evaluates the checkpoint. ``resume=True`` with ``pretrained_path``
continues a run at the checkpoint's epoch + 1 with its classifier, its
optimizer's state and its ``best_val``, and the GAN pair's weights and
batch statistics from ``<run_dir>/model_gan.pth``; the GAN pair's Adam
moments restart, as in the JAX package (that file holds no optimizer).

The classifier's steps are ``cls_main``'s, with its two switches
(``fused_switches``: ``ADAPTPOINT_TPU_TRAIN_FUSED``,
``ADAPTPOINT_TPU_EVAL_FUSED``) for phase B and evaluation.

Not ported yet (they raise, naming their ``ROADMAP.md`` item):
``adaptpoint_fused``, ``scan_batches > 1`` and ``use_voting``.
"""
from __future__ import annotations

import logging
import os
import time
from typing import Optional

import torch

from ..adapt.feedback import update_hardratio
from ..datasets import NumpyLoader, ScanObjectNNC, build_dataloader_from_cfg
from ..device import resolve_device
from ..metricslog import Summary
from ..models import build_model_from_cfg
from ..transforms import build_transforms_from_cfg
from ..utils.ckpt import load_checkpoint, resume_checkpoint, save_checkpoint
from ..utils.random import set_random_seed
from .adapt_trainer import build_gan, make_gan_step, train_gan_epoch
from .cls_main import fused_switches, print_cls_results
from .cls_trainer import (TrainState, build_train_tools, make_eval_step,
                          make_train_step, train_one_epoch, validate)
from .corrupt_main import (_corruption_eval, make_train_step_mixed,
                           train_one_epoch_rsmix)

__all__ = ["main", "validate_scanobjectnnc", "fake_loader"]

# switches the JAX package's loop takes and the port does not yet, with the
# ROADMAP.md item each waits for
NOT_PORTED = (("adaptpoint_fused", "§A.5"), ("use_voting", "§A.5"))


def _refuse_not_ported(cfg) -> None:
    mode = cfg.get("mode", "adaptpoint")
    if mode not in ("adaptpoint", "adaptpoint_modelnet", "test", "val"):
        raise NotImplementedError(f"mode {mode} is not ported yet")
    for key, item in NOT_PORTED:
        if cfg.get(key):
            raise NotImplementedError(f"{key} under mode: {mode} is not "
                                      f"ported yet (ROADMAP.md {item})")
    if int(cfg.get("scan_batches", 1) or 1) > 1:
        raise NotImplementedError("scan_batches > 1 is not ported yet "
                                  "(ROADMAP.md §A.2)")


def fake_loader(fake, batch_size: int, seed: int, epoch: int) -> NumpyLoader:
    """Phase B's loader over an epoch's fake clouds: shuffled with
    ``seed + epoch``, full batches only (``adapt_main.py:186-188``)."""
    return NumpyLoader(fake, batch_size, shuffle=True, drop_last=True,
                       seed=seed + epoch)


def validate_scanobjectnnc(split, eval_step, state, cfg):
    """One ScanObjectNN-C split through ``validate``: ``{"acc": OA / 100}``
    (reference train_autoaug.py:550-574)."""
    transform = build_transforms_from_cfg(
        "val", cfg.get("datatransforms_scanobjectnn_c"))
    data_dir = cfg.get("scanobjectnn_c_dir",
                       "./data/ScanObjectNN_C/scanobjectnn_c")
    ds = ScanObjectNNC(data_dir=data_dir, split=split, transform=transform)
    loader = NumpyLoader(ds, cfg.get("val_batch_size", cfg.batch_size))
    _, oa, _, _ = validate(eval_step, state, loader, cfg)
    return {"acc": oa / 100.0}


def main(cfg, device: Optional[str] = None) -> Optional[float]:
    """Run the AdaptPoint protocol on ``device`` (``None``: the card).
    Returns the best validation OA, or the OA for ``mode: test`` / ``val``."""
    _refuse_not_ported(cfg)
    mode = cfg.get("mode", "adaptpoint")
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
    test_loader = val_loader
    if hasattr(val_loader.dataset, "classes"):
        cfg.classes = list(val_loader.dataset.classes)

    criterion, optimizer, lr_fn = build_train_tools(cfg, model)
    fused_train_bn, fused_eval = fused_switches()
    logging.info("fused train-BN route: %s, fused eval route: %s",
                 fused_train_bn, fused_eval)
    state = TrainState(model, optimizer)
    train_step = make_train_step(model, optimizer, criterion, cfg,
                                 fused_train_bn=fused_train_bn)
    eval_step = make_eval_step(model, cfg, fused_eval=fused_eval)

    if mode in ("test", "val"):
        if not cfg.get("pretrained_path"):
            raise ValueError(f"mode {mode} needs pretrained_path")
        epoch_loaded, _ = load_checkpoint(model, cfg.pretrained_path)
        macc, oa, accs, _ = validate(eval_step, state, test_loader, cfg)
        print_cls_results(oa, macc, accs, epoch_loaded, cfg)
        return oa

    resume = bool(cfg.get("resume")) and bool(cfg.get("pretrained_path"))
    resumed_best = 0.0
    if resume:  # the classifier, its optimizer, epoch and best_val
        _, resumed_best = resume_checkpoint(cfg, model, optimizer)
    train_loader = build_dataloader_from_cfg(
        cfg.batch_size, cfg.dataset, cfg.dataloader,
        datatransforms_cfg=cfg.datatransforms, split="train", seed=seed)
    generator, discriminator, _, _, gan_state = build_gan(cfg, dev, seed)
    gan_path = os.path.join(cfg.get("run_dir") or "", "model_gan.pth")
    if resume and cfg.get("run_dir") and os.path.exists(gan_path):
        # the weights and batch statistics; the Adam moments restart
        saved = torch.load(gan_path, map_location=dev, weights_only=True)
        generator.load_state_dict(saved["generator"], strict=True)
        discriminator.load_state_dict(saved["discriminator"], strict=True)
        logging.info("resumed GAN pair from %s", gan_path)
    gan_step = make_gan_step(generator, discriminator, gan_state.g_opt,
                             gan_state.d_opt, model, cfg)
    # phase B mixes the fake clouds by RSMix where rsmix_params is set
    # (train_autoaug_modelnet.py:396-398)
    train_step_mixed = None
    if cfg.get("rsmix_params") is not None:
        train_step_mixed = make_train_step_mixed(
            model, optimizer, criterion, cfg, fused_train_bn=fused_train_bn)
    logging.info("Number of params: classifier %d, generator %d, "
                 "discriminator %d",
                 *(sum(p.numel() for p in m.parameters())
                   for m in (model, generator, discriminator)))
    logging.info("train size %d, val size %d", len(train_loader.dataset),
                 len(val_loader.dataset))

    summary = Summary(cfg.get("run_dir"))
    params_cfg = cfg.adaptpoint_params
    best_val, best_epoch = float(resumed_best or 0.0), 0
    val_oa = 0.0
    adjust_epoch = cfg.get("adaptpoint_adjustepoch", 0)
    # the sweep's cadence: every 10 epochs (train_autoaug.py:401), every 20
    # for ModelNet (train_autoaug_modelnet.py:412)
    sweep_every = 20 if mode == "adaptpoint_modelnet" else 10
    for epoch in range(cfg.get("start_epoch", 1), cfg.epochs + 1):
        train_loader.set_epoch(epoch)
        lr = lr_fn(epoch - 1)
        phase_a = phase_b = 0.0
        if epoch > adjust_epoch:
            # phase A: the augmentor against the discriminator, on the
            # real loader, with the frozen classifier's feedback
            hardratio = update_hardratio(params_cfg.hardratio_s,
                                         params_cfg.hardratio, epoch,
                                         cfg.epochs)
            t0 = time.perf_counter()
            gan_state, fake, _ = train_gan_epoch(
                gan_step, gan_state, train_loader, rng, hardratio, cfg,
                summary=summary, epoch=epoch)
            phase_a = time.perf_counter() - t0
            if cfg.get("run_dir"):
                torch.save({"generator": generator.state_dict(),
                            "discriminator": discriminator.state_dict()},
                           gan_path)
            # phase B: the classifier on the epoch's fake clouds
            loader_b = fake_loader(fake, cfg.batch_size, seed, epoch)
            t0 = time.perf_counter()
            if train_step_mixed is not None:
                state, train_loss, _, train_oa, _, _ = train_one_epoch_rsmix(
                    train_step_mixed, state, loader_b, rng, lr, cfg)
            else:
                state, train_loss, _, train_oa, _, _ = train_one_epoch(
                    train_step, state, loader_b, rng, lr, cfg)
            phase_b = time.perf_counter() - t0
            logging.info("phase B: %d batches of %d fake clouds",
                         len(loader_b), len(fake))
        else:
            t0 = time.perf_counter()
            state, train_loss, _, train_oa, _, _ = train_one_epoch(
                train_step, state, train_loader, rng, lr, cfg)
            phase_b = time.perf_counter() - t0

        if (epoch + 1) % sweep_every == 0:
            _corruption_eval(cfg, eval_step, state, epoch)

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
                     "phase_a_seconds %.3f phase_b_seconds %.3f", epoch, lr,
                     train_oa, val_oa, best_val, phase_a, phase_b)
        for tag, value in (("train_loss", train_loss),
                           ("train_oa", train_oa), ("lr", lr),
                           ("val_oa", val_oa), ("best_val", best_val)):
            summary.add_scalar(tag, value, epoch)
        summary.flush()
        if cfg.get("run_name"):
            save_checkpoint(cfg, model, optimizer, epoch, is_best=is_best,
                            additional={"best_val": best_val})

    # the last weights, then the best, each with its sweep
    # (train_autoaug.py:437-456)
    test_macc, test_oa, test_accs, _ = validate(eval_step, state,
                                                test_loader, cfg)
    print_cls_results(test_oa, test_macc, test_accs, best_epoch, cfg)
    _corruption_eval(cfg, eval_step, state, "final_latest")
    if cfg.get("run_name"):
        best_path = os.path.join(cfg.ckpt_dir,
                                 f"{cfg.run_name}_ckpt_best.pth")
        if os.path.exists(best_path):
            epoch_best, _ = load_checkpoint(model, best_path)
            test_macc, test_oa, test_accs, _ = validate(eval_step, state,
                                                        test_loader, cfg)
            print_cls_results(test_oa, test_macc, test_accs, epoch_best,
                              cfg)
            _corruption_eval(cfg, eval_step, state, "final_best")
    summary.close()
    return best_val
