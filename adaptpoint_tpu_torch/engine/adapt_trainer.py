"""AdaptPoint adversarial-augmentation training engine: phase A.

Counterpart of ``adaptpoint_tpu/engine/adapt_trainer.py``. One ``gan_step``
runs, with the task classifier frozen in eval mode: one FPS of the raw cloud
to N/2 that the augmentor's anchors and first grouper and the classifier's
real pass all take prefixes of; the generator's fake clouds; the generator
update on ``BCE(D(gen), 0.9) + feedbackloss_ratio * feedback``; and the
discriminator update on ``(BCE(D(real), 0.9) + BCE(D(gen.detach()), 0.1)) / 2``
from one batched pass over ``real || fake``. The discriminator's
power-iteration state advances in the generator pass and the discriminator
pass continues from there.

The classifier sees the fake clouds differentiated with respect to the
clouds only, and the real clouds without a gradient. Where it is an f32
model on the card both passes take the fused SA route (``_fused_ok``), as
the JAX package does on its accelerator: the fake pass, under autograd, the
differentiable stage (``ops.sa_train``; the frozen weights take no gradient,
so its backward computes none), the real pass the eval stage
(``ops.sa_eval``). Elsewhere
both take the unfused eval-mode route (ball group, pointwise convs), as the JAX
package does off its accelerator.

Where the JAX package threads an immutable state through a jitted function,
the port updates the models and optimizers in place and :class:`GanState`
holds them. Nothing inside a step reads a value back from the device.
``train_gan_epoch`` returns the epoch's fake clouds as a ``FormDatasetCls``
for phase B (``cls_trainer``).

Precision: ``gan_precision`` picks the compute policy the whole step runs
under (``utils.precision``): ``bf16``, the JAX package's default on its
accelerator and the port's on the card, or ``f32``, the default on the CPU
(as the JAX package's off its accelerator). Under bf16 the generator, the
discriminator and both classifier passes compute their convs, attentions
and BatchNorms in bf16 (parameters, statistics, losses, the transforms and
the selections stay f32) and the augmentor's decode takes the weighted-gather
kernel (``ops.fpinterp``); the classifier keeps its f32 parameters and, on
the card, the fused routes. The single fused G/D/classifier step
(``make_fused_adapt_step``) is not ported yet.
"""
from __future__ import annotations

import contextlib
import logging
from dataclasses import dataclass
from typing import Callable, Iterable, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from .. import ops
from ..adapt import (WolfDraws, build_adaptpointmodels_from_cfg,
                     feedback_loss)
from ..adapt.form_dataset import FormDatasetCls
from ..loss import BCELoss, build_criterion_from_cfg
from ..utils.metrics import AverageMeter
from ..utils.precision import dtype_override, parse_precision
from .cls_trainer import _in_channels, _to_device

__all__ = ["GanState", "GanDraws", "build_gan", "gan_compute_dtype",
           "make_gan_step", "train_gan_epoch"]

_bce = BCELoss()


@dataclass
class GanState:
    """The generator, the discriminator, their optimizers and the number of
    steps taken; all four are updated in place by the step."""
    generator: nn.Module
    discriminator: nn.Module
    g_opt: torch.optim.Optimizer
    d_opt: torch.optim.Optimizer
    step: int = 0

    @property
    def device(self) -> torch.device:
        return next(self.generator.parameters()).device


@dataclass
class GanDraws:
    """Every random draw of one ``gan_step`` as tensors: the augmentor's
    PointWOLF draws and gumbel noise (B, N, 2), and the discriminator's two
    dropout keep-masks in the generator pass ((B, 512), (B, 256)) and in the
    discriminator pass over ``real || fake`` ((2B, 512), (2B, 256))."""
    wolf: WolfDraws
    gumbel: torch.Tensor
    d_masks_g: Sequence[torch.Tensor]
    d_masks_d: Sequence[torch.Tensor]


def build_gan(cfg, device: Optional[str] = None, seed: Optional[int] = None):
    """The generator, the discriminator and their Adam optimizers (lr
    ``lr_generator`` / ``lr_discriminator``, betas ``(b1, b2)``) on ``device``
    (``None``: the card). Returns ``(generator, discriminator, g_opt, d_opt,
    state)``."""
    params_cfg = cfg.adaptpoint_params
    generator = build_adaptpointmodels_from_cfg(cfg.adaptmodel_gan, device,
                                                seed)
    discriminator = build_adaptpointmodels_from_cfg(
        cfg.adaptmodel_dis, device, None if seed is None else seed + 1)
    betas = (float(params_cfg.b1), float(params_cfg.b2))
    g_opt = torch.optim.Adam(generator.parameters(),
                             lr=float(params_cfg.lr_generator), betas=betas)
    d_opt = torch.optim.Adam(discriminator.parameters(),
                             lr=float(params_cfg.lr_discriminator),
                             betas=betas)
    state = GanState(generator, discriminator, g_opt, d_opt)
    return generator, discriminator, g_opt, d_opt, state


@contextlib.contextmanager
def _frozen(model: nn.Module):
    """``model``'s parameters take no gradient inside."""
    flags = [(p, p.requires_grad) for p in model.parameters()]
    for p, _ in flags:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, flag in flags:
            p.requires_grad_(flag)


def _fused_ok(cls_model: nn.Module) -> bool:
    """Whether both classifier passes take the fused SA route: the fused
    stage works in bf16 and f32 and is written for the card, so only an f32
    classifier on a CUDA device does."""
    p = next(cls_model.parameters())
    return p.is_cuda and p.dtype == torch.float32


def gan_compute_dtype(cfg, device: torch.device) -> Optional[torch.dtype]:
    """The step's compute policy: ``cfg.gan_precision``, by default bf16 on
    a CUDA device and f32 (``None``) elsewhere, as the JAX package's default
    follows its backend (``adapt_trainer.py`` ``default_prec``)."""
    default = "bf16" if torch.device(device).type == "cuda" else "f32"
    return parse_precision(str(cfg.get("gan_precision", default)))


def make_gan_step(generator: nn.Module, discriminator: nn.Module,
                  g_opt: torch.optim.Optimizer, d_opt: torch.optim.Optimizer,
                  cls_model: nn.Module, cfg) -> Callable:
    """``gan_step(state, batch, rng, hardratio) -> (state, gen, metrics)``.

    ``batch`` holds ``x (B, N, C)`` with xyz in ``[..., :3]`` and ``y (B,)``
    on the models' device. ``rng`` is a :class:`GanDraws`, or the
    ``torch.Generator`` every draw comes from (``None``: the default one).
    ``gen (B, N, 3)`` and the six metrics (``g_loss``, ``g_loss_raw``,
    ``d_loss``, ``feedback``, ``loss_fake``, ``loss_real``) are detached
    device tensors. The step runs under the compute policy of
    :func:`gan_compute_dtype` for the generator's device."""
    compute = gan_compute_dtype(cfg, next(generator.parameters()).device)
    criterion = build_criterion_from_cfg(cfg.criterion_args)
    feedback_ratio = float(cfg.get("feedbackloss_ratio", 1))
    in_channels = _in_channels(cfg)
    g_params = list(generator.parameters())
    fused = _fused_ok(cls_model)

    def gan_step(state: GanState, batch,
                 rng: Union[GanDraws, torch.Generator, None] = None,
                 hardratio=1.0):
        with dtype_override(compute):
            return _gan_step(state, batch, rng, hardratio)

    def _gan_step(state, batch, rng, hardratio):
        points, label = batch["x"], batch["y"]
        input_pc = points[..., :3].contiguous()
        bsz = input_pc.shape[0]
        if isinstance(rng, GanDraws):
            wolf, gumbel = rng.wolf, rng.gumbel
            masks_g, masks_d, gen_rng = rng.d_masks_g, rng.d_masks_d, None
        else:
            wolf = gumbel = gen_rng = rng
            masks_g = masks_d = None
        generator.train()
        discriminator.train()
        cls_model.eval()

        # ONE sequential FPS of the raw cloud serves every consumer that
        # subsamples it this step: FPS is greedy, so the anchors, the first
        # grouper and the classifier's real pass all take prefixes. The fake
        # pass runs on the generated cloud and keeps its own FPS.
        fps_shared = ops.furthest_point_sample(input_pc,
                                               input_pc.shape[1] // 2)

        with _frozen(cls_model):
            _, gen = generator(input_pc, wolf, gumbel,
                               first_fps_idx=fps_shared)
            d_prob = discriminator(gen, dropout_mask=masks_g,
                                   generator=gen_rng)
            g_loss_raw = _bce(d_prob, torch.full_like(d_prob, 0.9))
            # two separate classifier calls: the real pass is a constant of
            # the generator's loss and needs no graph
            fake_x = torch.cat([gen, points[..., 3:in_channels]], dim=-1)
            logits_fake = cls_model(gen, fake_x, fused_eval=fused).float()
            with torch.no_grad():
                logits_real = cls_model(
                    input_pc, points[..., :in_channels].contiguous(),
                    fused_eval=fused,
                    first_fps_idx=fps_shared).float()
            loss_fake = criterion(logits_fake, label)
            loss_real = criterion(logits_real, label)
            fb = feedback_loss(loss_fake, loss_real, hardratio)
            g_loss = g_loss_raw + fb * feedback_ratio \
                if feedback_ratio > 0 else g_loss_raw
            # only the generator's gradients: the discriminator's and the
            # classifier's parameters are constants of this loss
            g_grads = torch.autograd.grad(g_loss, g_params, allow_unused=True)
        for p, g in zip(g_params, g_grads):
            p.grad = g
        g_opt.step()

        # ONE batched discriminator pass over real || fake: its spectral
        # norm reads only the weights, its dropout masks are per row, and it
        # has no BatchNorm, so the two halves do not see each other
        gen = gen.detach()
        both = torch.cat([input_pc, gen], dim=0)
        prob = discriminator(both, dropout_mask=masks_d, generator=gen_rng)
        real_prob, fake_prob = prob[:bsz], prob[bsz:]
        d_loss = (_bce(real_prob, torch.full_like(real_prob, 0.9))
                  + _bce(fake_prob, torch.full_like(fake_prob, 0.1))) / 2.0
        d_opt.zero_grad(set_to_none=True)
        d_loss.backward()
        d_opt.step()

        state.step += 1
        metrics = {"g_loss": g_loss.detach(),
                   "g_loss_raw": g_loss_raw.detach(),
                   "d_loss": d_loss.detach(), "feedback": fb.detach(),
                   "loss_fake": loss_fake.detach(),
                   "loss_real": loss_real.detach()}
        return state, gen, metrics

    return gan_step


_METRICS = ("g_loss", "g_loss_raw", "d_loss", "feedback", "loss_fake",
            "loss_real")


def _dump_fake_batch(cfg, epoch, i, gen_host, raw_host, label_host):
    """One batch's fake clouds, raw clouds and labels as
    ``<run_dir>/fakedata/epoch<epoch>/minibatch<i>.h5`` (reference
    train_autoaug.py:213-222). Needs ``h5py``."""
    import os
    import h5py
    path = os.path.join(cfg.run_dir, "fakedata", f"epoch{epoch}")
    os.makedirs(path, exist_ok=True)
    with h5py.File(os.path.join(path, f"minibatch{i}.h5"), "w") as f:
        f["pointcloud"] = gen_host
        f["raw"] = raw_host
        f["label"] = label_host


def train_gan_epoch(gan_step: Callable, gan_state: GanState, loader: Iterable,
                    rng: Optional[torch.Generator], hardratio: float, cfg,
                    summary=None, epoch: int = 0):
    """Phase A over ``loader``, any iterable of ``{"x", "y"}`` batches (numpy
    arrays or tensors). The fake clouds and the metrics stay on the device
    until the last batch is enqueued, then come back in one copy each.

    With a ``summary`` (``metricslog.Summary``) each step's six metrics and
    the hardratio go to ``train_G_iter/<name>`` at ``summary.train_iter_num``,
    which counts on over the run. The log line gives the epoch's means and
    how far the fake clouds moved from the real ones (mean |fake - real| of
    the coordinates). With ``cfg.dump_fakedata`` (off by
    default) and a ``run_dir``, steps 0, 10, ..., 100 also write their
    batch to an h5 file (``_dump_fake_batch``; without ``h5py`` that raises).

    Returns ``(gan_state, fake, averages)``: ``fake`` is the
    ``FormDatasetCls`` of the epoch's fake clouds (``pointcloud``), labels
    and full-channel points (``x``: fake xyz with the batch's remaining
    channels), ``averages`` the means of ``g_loss``, ``d_loss`` and
    ``feedback``."""
    device = gan_state.device
    dump = bool(cfg.get("dump_fakedata", False)) and bool(cfg.get("run_dir"))
    if dump:
        import h5py  # noqa: F401  (a requested dump needs it: fail first)
    gens, labels, points, rows, raws = [], [], [], [], {}
    for i, batch in enumerate(loader):
        dev_batch = _to_device(batch, device)
        gan_state, gen, metrics = gan_step(gan_state, dev_batch, rng,
                                           hardratio)
        gens.append(gen)
        labels.append(dev_batch["y"])
        # fake xyz + the original extra channels
        points.append(torch.cat([gen, dev_batch["x"][..., 3:]], dim=-1))
        # the metrics and how far the fake clouds moved from the real ones
        moved = (gen - dev_batch["x"][..., :3]).abs().mean()
        rows.append(torch.stack([metrics[k].float() for k in _METRICS]
                                + [moved.float()]))
        if dump and i % 10 == 0 and i < 110:
            raws[i] = dev_batch["x"][..., :3]
    if not gens:
        raise ValueError("train_gan_epoch: the loader gave no batch")
    gens_host = [g.cpu().numpy() for g in gens]
    labels_host = [y.cpu().numpy().astype(np.int64) for y in labels]
    meters = {k: AverageMeter() for k in ("g_loss", "d_loss", "feedback")}
    moved_meter = AverageMeter()
    for i, row in enumerate(torch.stack(rows).cpu().tolist()):
        values = dict(zip(_METRICS, row))
        for k, meter in meters.items():
            meter.update(values[k])
        moved_meter.update(row[-1])
        if summary is not None:
            for k, v in values.items():
                summary.add_scalar(f"train_G_iter/{k}", v,
                                   summary.train_iter_num)
            summary.add_scalar("train_G_iter/hardratio", float(hardratio),
                               summary.train_iter_num)
            summary.summary_train_iter_num_update()
        if i in raws:
            _dump_fake_batch(cfg, epoch, i, gens_host[i],
                             raws[i].cpu().numpy(), labels_host[i])
    logging.info("GAN epoch: g_loss %.4f d_loss %.4f feedback %.4f, "
                 "mean |fake - real| %.6g", meters["g_loss"].avg,
                 meters["d_loss"].avg, meters["feedback"].avg,
                 moved_meter.avg)
    fake = FormDatasetCls(gens_host, labels_host,
                          [p.cpu().numpy() for p in points])
    return gan_state, fake, {k: m.avg for k, m in meters.items()}
