"""Classification training engine (the baseline ``mode: train`` path and
phase B of the AdaptPoint protocol).

Counterpart of ``adaptpoint_tpu/engine/cls_trainer.py``. One train step does
the FPS point-budget resampling, the train-mode forward (BatchNorm updates
its running statistics), the criterion, the backward pass, global-norm
clipping and the optimizer update. Where the JAX package threads an immutable
state through a jitted function, the port updates the model and the optimizer
in place and :class:`TrainState` just holds them.

Nothing inside a step reads a value back from the device: the loss and the
predictions stay device tensors, and ``train_one_epoch`` / ``validate`` fetch
them once, after the last batch.

Not ported yet: the multi-batch scan step (a dispatch-latency device of the
JAX runtime), voting eval, the adahessian branch and the bf16 compute
policy; asking for the last two raises.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable, Optional, Union

import torch
from torch import nn

from .. import ops
from ..loss import build_criterion_from_cfg
from ..optim import build_optimizer_from_cfg, clip_by_global_norm_, set_lr
from ..scheduler import build_scheduler_from_cfg
from ..utils.metrics import AverageMeter, ConfusionMatrix

__all__ = ["TrainState", "build_train_tools", "make_train_step",
           "make_eval_step", "train_one_epoch", "validate", "resample_points",
           "set_lr"]

# npoints -> FPS budget the random subset is drawn from
_POINT_ALL = {1024: 1200, 4096: 4800, 8192: 8192}


@dataclass
class TrainState:
    """The model, its optimizer and the number of steps taken. The model and
    the optimizer are updated in place by the train step."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def resample_points(gen_or_cols: Union[torch.Generator, torch.Tensor, None],
                    points: torch.Tensor, npoints: int) -> torch.Tensor:
    """Train-time point-budget resampling: FPS to an intermediate budget,
    then one random subset of those columns shared by the whole batch.

    points (B, N, C) with xyz in ``[..., :3]``. ``gen_or_cols`` is the
    generator of the draw (``torch.randperm(point_all)[:npoints]``, unsorted:
    the first column drawn becomes point 0 of every cloud, where the first
    encoder stage's FPS starts), or the ``(npoints,)`` columns themselves.
    """
    num_curr = points.shape[1]
    if num_curr <= npoints:
        return points
    point_all = min(_POINT_ALL.get(npoints, npoints), num_curr)
    idx = ops.furthest_point_sample(points[..., :3], point_all)
    if isinstance(gen_or_cols, torch.Tensor):
        cols = gen_or_cols
    else:
        gen_dev = points.device if gen_or_cols is None else gen_or_cols.device
        cols = torch.randperm(point_all, generator=gen_or_cols,
                              device=gen_dev)[:npoints]
    idx = idx[:, cols.to(idx.device).long()]
    return ops.gather_rows(points, idx)


def build_train_tools(cfg, model: nn.Module):
    """``(criterion, optimizer, lr_fn)`` from ``cfg.criterion_args``,
    ``cfg.optimizer`` / ``cfg.lr`` and the scheduler keys."""
    criterion = build_criterion_from_cfg(cfg.criterion_args)
    optimizer = build_optimizer_from_cfg(model, lr=cfg.lr,
                                         **dict(cfg.optimizer))
    lr_fn = build_scheduler_from_cfg(cfg)
    return criterion, optimizer, lr_fn


def _in_channels(cfg) -> int:
    return int(cfg.model.get("in_channels", None)
               or cfg.model.encoder_args.in_channels)


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    criterion: Callable, cfg,
                    fused_train_bn: bool = False,
                    batch_loss: Optional[Callable] = None) -> Callable:
    """``train_step(state, batch, gen_or_cols, lr, dropout_mask=None) ->
    (state, loss, preds)``.

    ``fused_train_bn`` sends the encoder's standard SA stages through the
    fused train-BN op (``ops.sa_trainbn``; the JAX package's opt-in
    ``ADAPTPOINT_TPU_TRAIN_FUSED=1``); the default is the unfused route.
    ``batch_loss(logits, batch)`` replaces ``criterion(logits, batch["y"])``
    (the mixed-label loss of ``corrupt_main.make_train_step_mixed``).

    ``batch`` holds ``x (B, N, C)`` and ``y (B,)`` on the model's device.
    ``gen_or_cols`` goes to :func:`resample_points`; when it is a generator
    the dropout masks are drawn from it too, else ``dropout_mask`` gives them
    (``None`` draws from the default generator). ``lr`` is this step's
    learning rate. ``loss`` and ``preds`` are device tensors."""
    npoints = int(cfg.num_points)
    in_channels = _in_channels(cfg)
    clip = cfg.get("grad_norm_clip")
    if str(cfg.get("optimizer", {}).get("NAME", "")).lower() == "adahessian":
        raise NotImplementedError("the adahessian train step is not ported "
                                  "yet")
    if str(cfg.get("cls_precision", "f32")).lower() in ("bf16", "bfloat16"):
        raise NotImplementedError("cls_precision: bf16 is not ported yet")
    params = [p for group in optimizer.param_groups for p in group["params"]]

    def train_step(state: TrainState, batch, gen_or_cols=None,
                   lr: Optional[float] = None, dropout_mask=None):
        model.train()
        points = resample_points(gen_or_cols, batch["x"], npoints)
        pos = points[..., :3].contiguous()
        x = points[..., :in_channels].contiguous()
        gen = gen_or_cols if isinstance(gen_or_cols, torch.Generator) else None
        optimizer.zero_grad(set_to_none=True)
        logits = model(pos, x, dropout_mask=dropout_mask, generator=gen,
                       fused_train_bn=fused_train_bn)
        loss = (criterion(logits.float(), batch["y"]) if batch_loss is None
                else batch_loss(logits.float(), batch))
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


def make_eval_step(model: nn.Module, cfg, fused_eval: bool = False) -> Callable:
    """``eval_step(state, batch) -> preds (B,)``: the eval forward on the
    first ``cfg.num_points`` points, on the fused route when asked."""
    npoints = int(cfg.num_points)
    in_channels = _in_channels(cfg)

    @torch.no_grad()
    def eval_step(state: TrainState, batch):
        model.eval()
        points = batch["x"][:, :npoints]
        pos = points[..., :3].contiguous()
        x = points[..., :in_channels].contiguous()
        return model(pos, x, fused_eval=fused_eval).argmax(dim=-1)

    return eval_step


def _to_device(batch, device: torch.device):
    """The batch's ``x`` (f32) and ``y`` (int64) as tensors on ``device``."""
    return {"x": torch.as_tensor(batch["x"], dtype=torch.float32).to(
                device, non_blocking=True),
            "y": torch.as_tensor(batch["y"]).to(device, torch.int64,
                                                non_blocking=True)}


def train_one_epoch(train_step: Callable, state: TrainState,
                    loader: Iterable, rng: Optional[torch.Generator],
                    lr: float, cfg, cm: Optional[ConfusionMatrix] = None):
    """One epoch over ``loader``, any iterable of ``{"x", "y"}`` batches
    (numpy arrays or tensors). Losses and predictions stay on the device
    until the last batch is enqueued, then come back in one copy.

    Returns ``(state, mean loss, macc, oa, per-class accs, cm)``."""
    loss_meter = AverageMeter()
    cm = cm or ConfusionMatrix(num_classes=cfg.num_classes)
    device = state.device
    losses, preds, labels = [], [], []
    for batch in loader:
        dev_batch = _to_device(batch, device)
        state, loss, pred = train_step(state, dev_batch, rng, lr)
        losses.append(loss)
        preds.append(pred)
        labels.append(dev_batch["y"])
    if losses:
        for v in torch.stack(losses).cpu().tolist():
            loss_meter.update(v)
        cm.update(torch.cat(preds), torch.cat(labels))
    macc, oa, accs = cm.all_acc()
    return state, loss_meter.avg, macc, oa, accs, cm


def validate(eval_step: Callable, state: TrainState, loader: Iterable, cfg):
    """Full eval pass. A padded last batch says how many of its rows are real
    in ``n_valid``; the rest are trimmed before they are counted.

    Returns ``(macc, oa, per-class accs, cm)``."""
    cm = ConfusionMatrix(num_classes=cfg.num_classes)
    device = state.device
    preds, labels = [], []
    for batch in loader:
        batch = dict(batch)
        n_valid = int(batch.pop("n_valid", len(batch["y"])))
        dev_batch = _to_device(batch, device)
        preds.append(eval_step(state, dev_batch)[:n_valid])
        labels.append(dev_batch["y"][:n_valid])
    if preds:
        cm.update(torch.cat(preds), torch.cat(labels))
    macc, oa, accs = cm.all_acc()
    return macc, oa, accs, cm
