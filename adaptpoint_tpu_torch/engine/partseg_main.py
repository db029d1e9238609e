"""The ShapeNetPart part-segmentation experiment loop: modes ``train``,
``test``, ``val``, ``resume`` and ``adaptpoint``.

Counterpart of ``adaptpoint_tpu/engine/partseg_main.py`` (reference
examples/shapenetpart/main.py:100-360 and train_adapt.py:119-278). The
train step is f32: the train-mode forward of ``BasePartSeg`` on the batch's
``pos``, ``x`` and shape category ``cls`` (no resampling), label-smoothed
cross entropy over every point's part logits, global-norm clipping and the
classifier's optimizer and schedule. Validation counts the points' accuracy
and each shape's mean IoU over its category's parts (``CLS2PARTS``),
averaged over shapes (instance mIoU) and over categories (class mIoU),
optionally after the kNN label refinement.

``mode: adaptpoint`` (or any cfg with ``adaptmodel_gan``) trains the
augmentor and the discriminator each epoch over the real loader first
(phase A, ``make_partseg_gan_step``). Unlike the classifier's step, the
generator learns from the adversarial loss alone: there is no feedback term
and no segmentation pass (train_adapt.py:215). The step runs in f32, as the
JAX package's does, whatever ``gan_precision`` says. The epoch's fake
clouds with the real batches' part labels, heights and categories make
``FormDatasetShapeNet``, on which the model then trains (phase B, ``x =
[pos || height]``). The GAN pair is saved to ``<run_dir>/model_gan.pth``
each epoch.

``mode: test`` / ``val`` evaluate ``pretrained_path`` (with ``refine``);
``mode: resume`` and ``resume=True`` continue it at its epoch + 1 with its
optimizer's state and ``best_val``, and the GAN pair's weights and batch
statistics from the run directory's ``model_gan.pth`` (their Adam moments
restart, as in the JAX package). ``eval_shapenet_c`` sweeps ShapeNet-C on
the latest and the best weights at the end (and on a tested checkpoint);
a missing split is logged and the sweep skipped, as in the JAX package.
Checkpoints are written at each validation. The two opt-in switches of
``cls_main.fused_switches`` select the fused train-BN and the fused eval
SA routes.
"""
from __future__ import annotations

import logging
import os
import time
from typing import Callable, Iterable, Optional, Union

import numpy as np
import torch
from torch import nn

from ..adapt.form_dataset import FormDatasetShapeNet
from ..datasets import (CLS2PARTS, NumpyLoader, ShapeNetPartC,
                        build_dataloader_from_cfg,
                        eval_corrupt_wrapper_shapenetc)
from ..device import resolve_device
from ..loss import BCELoss
from ..metricslog import Summary
from ..models import build_model_from_cfg
from ..optim import clip_by_global_norm_, set_lr
from ..transforms import build_transforms_from_cfg
from ..utils.ckpt import load_checkpoint, resume_checkpoint, save_checkpoint
from ..utils.metrics import AverageMeter
from ..utils.partseg import get_ins_mious, part_seg_refinement
from ..utils.random import set_random_seed
from .adapt_main import fake_loader
from .adapt_trainer import GanDraws, GanState, build_gan
from .cls_main import fused_switches
from .cls_trainer import TrainState, _in_channels, build_train_tools

__all__ = ["main", "make_partseg_train_step", "make_partseg_eval_step",
           "validate_partseg", "make_partseg_gan_step",
           "train_partseg_epoch", "train_partseg_gan_epoch",
           "partseg_batch"]

MODES = ("train", "test", "val", "resume", "adaptpoint")
_bce = BCELoss()


def partseg_batch(batch, device: torch.device) -> dict:
    """A loader batch as device tensors: ``pos``, ``x`` (f32; ``[pos ||
    heights]`` where the batch has no ``x``, as the fake loader's),
    ``y`` and ``cls`` (int64)."""
    x = batch.get("x")
    if x is None:
        x = np.concatenate([batch["pos"], batch["heights"]], axis=-1)

    def dev(v, dtype):
        return torch.as_tensor(v).to(device, dtype, non_blocking=True)

    return {"pos": dev(batch["pos"], torch.float32).contiguous(),
            "x": dev(x, torch.float32), "y": dev(batch["y"], torch.int64),
            "cls": dev(batch["cls"], torch.int64)}


def make_partseg_train_step(model: nn.Module,
                            optimizer: torch.optim.Optimizer,
                            criterion: Callable, cfg,
                            fused_train_bn: bool = False) -> Callable:
    """``train_step(state, batch, lr=None, dropout_mask=None,
    generator=None) -> (state, loss, preds)``.

    ``batch`` holds device tensors ``pos (B, N, 3)``, ``x (B, N, C)``, ``y
    (B, N)`` and ``cls (B,)``. The head's dropout keep-mask (B, N, C) is
    ``dropout_mask``, or drawn from ``generator`` (``None``: the default
    one). ``fused_train_bn`` sends the encoder's standard SA stages through
    the fused train-BN op. ``loss`` and ``preds (B, N)`` are device
    tensors."""
    in_channels = _in_channels(cfg)
    clip = cfg.get("grad_norm_clip")
    if str(cfg.get("optimizer", {}).get("NAME", "")).lower() == "adahessian":
        raise NotImplementedError("the adahessian train step is not ported "
                                  "yet")
    params = [p for group in optimizer.param_groups for p in group["params"]]

    def train_step(state: TrainState, batch, lr: Optional[float] = None,
                   dropout_mask=None,
                   generator: Optional[torch.Generator] = None):
        model.train()
        x = batch["x"][..., :in_channels].contiguous()
        optimizer.zero_grad(set_to_none=True)
        logits = model(batch["pos"], x, batch["cls"],
                       dropout_mask=dropout_mask, generator=generator,
                       fused_train_bn=fused_train_bn)
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


def make_partseg_eval_step(model: nn.Module, cfg,
                           fused_eval: bool = False) -> Callable:
    """``eval_step(state, batch) -> preds (B, N)``: the eval forward, on the
    fused route when asked."""
    in_channels = _in_channels(cfg)

    @torch.no_grad()
    def eval_step(state: TrainState, batch):
        model.eval()
        x = batch["x"][..., :in_channels].contiguous()
        return model(batch["pos"], x, batch["cls"],
                     fused_eval=fused_eval).argmax(dim=-1)

    return eval_step


def validate_partseg(eval_step: Callable, state: TrainState,
                     loader: Iterable, refine: bool = False) -> dict:
    """Point accuracy, instance mIoU and class mIoU over ``loader`` (in %
    for the mIoUs, a fraction for ``acc``). A padded last batch says how many
    of its rows are real in ``n_valid``; the rest are cut before they are
    counted. ``refine`` applies ``part_seg_refinement`` first. The
    predictions come back from the device after the last batch."""
    num_classes = len(CLS2PARTS)
    ins_mious_sum = np.zeros(num_classes)
    cls_counts = np.zeros(num_classes)
    correct = total = 0
    device = state.device
    pending = []
    for batch in loader:
        batch = dict(batch)
        n_valid = int(batch.pop("n_valid", len(batch["y"])))
        pending.append((eval_step(state, partseg_batch(batch, device)),
                        batch, n_valid))
    for preds, batch, n_valid in pending:
        preds = preds.cpu().numpy()[:n_valid]
        y = np.asarray(batch["y"])[:n_valid]
        cls0 = np.asarray(batch["cls"]).reshape(-1)[:n_valid]
        if refine:
            preds = part_seg_refinement(
                preds, np.asarray(batch["pos"])[:n_valid], cls0, CLS2PARTS)
        correct += (preds == y).sum()
        total += y.size
        for c, m in zip(cls0, get_ins_mious(preds, y, cls0, CLS2PARTS)):
            ins_mious_sum[int(c)] += m
            cls_counts[int(c)] += 1
    present = cls_counts > 0
    cls_mious = ins_mious_sum[present] / cls_counts[present]
    return {"acc": float(correct / max(total, 1)),
            "ins_miou": float(ins_mious_sum.sum() / max(cls_counts.sum(), 1)),
            "cls_miou": float(cls_mious.mean())}


def train_partseg_epoch(train_step: Callable, state: TrainState,
                        loader: Iterable, rng: Optional[torch.Generator],
                        lr: float):
    """One epoch over ``loader``; the dropout masks come from ``rng``. The
    losses stay on the device until the last batch is enqueued. Returns
    ``(state, mean loss)``."""
    device = state.device
    losses = []
    for batch in loader:
        state, loss, _ = train_step(state, partseg_batch(batch, device), lr,
                                    generator=rng)
        losses.append(loss)
    meter = AverageMeter()
    if losses:
        for v in torch.stack(losses).cpu().tolist():
            meter.update(v)
    return state, meter.avg


def make_partseg_gan_step(generator: nn.Module, discriminator: nn.Module,
                          g_opt: torch.optim.Optimizer,
                          d_opt: torch.optim.Optimizer) -> Callable:
    """``gan_step(state, batch, rng=None) -> (state, gen, metrics)``, in f32.

    The generator is updated on ``BCE(D(gen), 0.9)`` alone, the
    discriminator on ``(BCE(D(real), 0.9) + BCE(D(gen.detach()), 0.1)) / 2``
    from two passes, real then fake, as the JAX package's step makes them;
    the spectral norms' power iterations advance in each of the three
    discriminator passes. ``batch`` holds ``pos (B, N, 3)`` on the models'
    device. ``rng`` is a :class:`GanDraws` (its ``d_masks_d`` hold the real
    pass's masks in their first B rows and the fake pass's in the last B),
    or the ``torch.Generator`` every draw comes from (``None``: the default
    one). ``gen (B, N, 3)`` and the metrics (``g_loss``, ``d_loss``) are
    detached device tensors."""
    g_params = list(generator.parameters())

    def gan_step(state: GanState, batch,
                 rng: Union[GanDraws, torch.Generator, None] = None):
        input_pc = batch["pos"][..., :3].contiguous()
        bsz = input_pc.shape[0]
        if isinstance(rng, GanDraws):
            wolf, gumbel, gen_rng = rng.wolf, rng.gumbel, None
            masks_g = rng.d_masks_g
            masks_real = [m[:bsz] for m in rng.d_masks_d]
            masks_fake = [m[bsz:] for m in rng.d_masks_d]
        else:
            wolf = gumbel = gen_rng = rng
            masks_g = masks_real = masks_fake = None
        generator.train()
        discriminator.train()

        _, gen = generator(input_pc, wolf, gumbel)
        d_prob = discriminator(gen, dropout_mask=masks_g, generator=gen_rng)
        g_loss = _bce(d_prob, torch.full_like(d_prob, 0.9))
        # only the generator's gradients: the discriminator's parameters are
        # constants of this loss
        g_grads = torch.autograd.grad(g_loss, g_params, allow_unused=True)
        for p, g in zip(g_params, g_grads):
            p.grad = g
        g_opt.step()

        gen = gen.detach()
        real_prob = discriminator(input_pc, dropout_mask=masks_real,
                                  generator=gen_rng)
        fake_prob = discriminator(gen, dropout_mask=masks_fake,
                                  generator=gen_rng)
        d_loss = (_bce(real_prob, torch.full_like(real_prob, 0.9))
                  + _bce(fake_prob, torch.full_like(fake_prob, 0.1))) / 2.0
        d_opt.zero_grad(set_to_none=True)
        d_loss.backward()
        d_opt.step()

        state.step += 1
        return state, gen, {"g_loss": g_loss.detach(),
                            "d_loss": d_loss.detach()}

    return gan_step


def train_partseg_gan_epoch(gan_step: Callable, gan_state: GanState,
                            loader: Iterable,
                            rng: Optional[torch.Generator]):
    """Phase A over ``loader``'s real batches. The fake clouds and the
    metrics stay on the device until the last batch is enqueued. The log
    line gives the epoch's mean losses and how far the fake clouds moved
    from the real ones (mean |fake - real| of the coordinates).

    Returns ``(gan_state, fake, averages)``: ``fake`` the
    ``FormDatasetShapeNet`` of the epoch's fake clouds with each real
    batch's part labels, heights (``x[..., 3:4]``) and categories."""
    device = gan_state.device
    gens, rows, ys, heights, cls = [], [], [], [], []
    for batch in loader:
        dev_batch = partseg_batch(batch, device)
        gan_state, gen, metrics = gan_step(gan_state, dev_batch, rng)
        gens.append(gen)
        moved = (gen - dev_batch["pos"]).abs().mean()
        rows.append(torch.stack([metrics["g_loss"], metrics["d_loss"],
                                 moved]).float())
        ys.append(np.asarray(batch["y"]))
        heights.append(np.asarray(batch["x"])[..., 3:4])
        cls.append(np.asarray(batch["cls"]))
    if not gens:
        raise ValueError("train_partseg_gan_epoch: the loader gave no batch")
    means = torch.stack(rows).mean(dim=0).cpu().tolist()
    logging.info("GAN epoch: g_loss %.4f d_loss %.4f, mean |fake - real| "
                 "%.6g", *means)
    fake = FormDatasetShapeNet([g.cpu().numpy() for g in gens], ys, heights,
                               cls)
    return gan_state, fake, {"g_loss": means[0], "d_loss": means[1]}


def main(cfg, device: Optional[str] = None):
    """Run ``cfg.mode`` on ``device`` (``None``: the card). Returns the best
    instance mIoU (``train``, ``resume``, ``adaptpoint``) or the metrics
    (``test``, ``val``)."""
    mode = cfg.get("mode", "train")
    if mode not in MODES:
        raise NotImplementedError(f"mode {mode} is not ported for part "
                                  f"segmentation")
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

    criterion, optimizer, lr_fn = build_train_tools(cfg, model)
    logging.info("Number of params: %.4f M",
                 sum(p.numel() for p in model.parameters()) / 1e6)
    fused_train_bn, fused_eval = fused_switches()
    logging.info("fused train-BN route: %s, fused eval route: %s",
                 fused_train_bn, fused_eval)
    state = TrainState(model, optimizer)
    train_step = make_partseg_train_step(model, optimizer, criterion, cfg,
                                         fused_train_bn=fused_train_bn)
    eval_step = make_partseg_eval_step(model, cfg, fused_eval=fused_eval)

    def shapenetc_sweep(tag):
        """The ShapeNet-C sweep on the model's weights, appended to
        ``<run_dir>/outcorruption.txt`` under ``tag``."""
        transform = build_transforms_from_cfg(
            "val", cfg.get("datatransforms_shapenet_c"))

        def eval_c(split):
            ds = ShapeNetPartC(
                data_dir=cfg.get("shapenet_c_dir", "./data/shapenet_c"),
                split=split, transform=transform)
            return validate_partseg(eval_step, state,
                                    NumpyLoader(ds, val_bs))

        try:
            eval_corrupt_wrapper_shapenetc(eval_c, {}, cfg.get("run_dir"),
                                           tag)
        except FileNotFoundError as e:
            logging.warning("skipping shapenet-c eval: %s", e)

    if mode in ("test", "val"):
        if not cfg.get("pretrained_path"):
            raise ValueError(f"mode {mode} needs pretrained_path")
        load_checkpoint(model, cfg.pretrained_path)
        perf = validate_partseg(eval_step, state, val_loader,
                                refine=cfg.get("refine", False))
        logging.info("test: %s", perf)
        if cfg.get("eval_shapenet_c", False):
            shapenetc_sweep(f"test-{os.path.basename(cfg.pretrained_path)}")
        return perf

    resume = bool(cfg.get("pretrained_path")) and (
        mode == "resume" or bool(cfg.get("resume")))
    resumed_best = 0.0
    if resume:  # the model, its optimizer, epoch and best_val
        _, resumed_best = resume_checkpoint(cfg, model, optimizer)
    elif mode == "resume":
        raise ValueError("mode resume needs pretrained_path")
    train_loader = build_dataloader_from_cfg(
        cfg.batch_size, cfg.dataset, cfg.dataloader,
        datatransforms_cfg=cfg.datatransforms, split="train", seed=seed)
    logging.info("train size %d, val size %d", len(train_loader.dataset),
                 len(val_loader.dataset))

    gan_step = gan_state = None
    gan_path = os.path.join(cfg.get("run_dir") or "", "model_gan.pth")
    if mode == "adaptpoint" or cfg.get("adaptmodel_gan") is not None:
        generator, discriminator, g_opt, d_opt, gan_state = build_gan(
            cfg, dev, seed)
        if resume and cfg.get("run_dir") and os.path.exists(gan_path):
            # the weights and batch statistics; the Adam moments restart
            saved = torch.load(gan_path, map_location=dev, weights_only=True)
            generator.load_state_dict(saved["generator"], strict=True)
            discriminator.load_state_dict(saved["discriminator"],
                                          strict=True)
            logging.info("resumed GAN pair from %s", gan_path)
        gan_step = make_partseg_gan_step(generator, discriminator, g_opt,
                                         d_opt)

    summary = Summary(cfg.get("run_dir"))
    best_ins = float(resumed_best or 0.0)
    for epoch in range(cfg.get("start_epoch", 1), cfg.epochs + 1):
        train_loader.set_epoch(epoch)
        lr = lr_fn(epoch - 1)
        loader, phase_a = train_loader, 0.0
        if gan_step is not None:
            # phase A on the real loader, then phase B on its fake clouds
            t0 = time.perf_counter()
            gan_state, fake, _ = train_partseg_gan_epoch(
                gan_step, gan_state, train_loader, rng)
            phase_a = time.perf_counter() - t0
            if cfg.get("run_dir"):
                torch.save({"generator": gan_state.generator.state_dict(),
                            "discriminator":
                                gan_state.discriminator.state_dict()},
                           gan_path)
            loader = fake_loader(fake, cfg.batch_size, seed, epoch)
            logging.info("phase B: %d batches of %d fake clouds",
                         len(loader), len(fake))
        t0 = time.perf_counter()
        state, train_loss = train_partseg_epoch(train_step, state, loader,
                                                rng, lr)
        phase_b = time.perf_counter() - t0

        perf = {}
        if epoch % cfg.val_freq == 0:
            perf = validate_partseg(eval_step, state, val_loader)
            is_best = perf["ins_miou"] > best_ins
            if is_best:
                best_ins = perf["ins_miou"]
            if cfg.get("run_name"):
                save_checkpoint(cfg, model, optimizer, epoch,
                                is_best=is_best,
                                additional={"best_val": best_ins})
        logging.info("Epoch %d LR %.6f loss %.4f val %s best_ins %.2f "
                     "phase_a_seconds %.3f phase_b_seconds %.3f", epoch, lr,
                     train_loss, perf, best_ins, phase_a, phase_b)
        summary.add_scalar("train_loss", train_loss, epoch)
        if perf:
            summary.add_scalar("ins_miou", perf["ins_miou"], epoch)
        summary.flush()

    # the ShapeNet-C sweep on the latest weights, then on the best
    if cfg.get("eval_shapenet_c", False):
        shapenetc_sweep(f"{cfg.epochs}-latest")
        if cfg.get("run_name"):
            best_path = os.path.join(cfg.ckpt_dir,
                                     f"{cfg.run_name}_ckpt_best.pth")
            if os.path.exists(best_path):
                load_checkpoint(model, best_path)
                shapenetc_sweep(f"{cfg.epochs}-best")
    summary.close()
    return best_ins
