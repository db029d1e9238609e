"""The S3DIS scene-segmentation experiment loop: modes ``train``, ``val``,
``test``, ``resume`` and ``test_6fold``, on voxel crops or on spheres.

Counterpart of ``adaptpoint_tpu/engine/seg_main.py`` (reference
examples/segmentation/main.py:112-730, its core path, and
test_s3dis_6fold.py). The train step is f32: the train-mode forward of
``BaseSeg`` on the batch's ``pos`` and the features named by
``feature_keys`` (``x,heights`` for S3DIS: the colours and the height,
``in_channels: 4``), the criterion over every point's logits
(label-smoothed cross entropy, with ``cls_weighed_loss`` weighted by
``get_class_weights`` of the validation set's class counts; a criterion
whose name holds "mask", ``MaskedCrossEntropy``, over the points the
batch's ``mask`` keeps), global-norm clipping (optax's rule), and the
optimizer and schedule of the cfg (AdamW, cosine).

Validation on crops (``validate_seg``) fills a confusion matrix over every
point of every crop; on spheres (a dataset whose name holds "sphere",
``S3DISSphere``; ``validate_sphere``) it sums the logits of overlapping
spheres on each area's subsampled cloud, projects their argmax onto the
original points and scores the points some sphere covered. Both report
mIoU, mAcc and OA (``get_mious``).

``mode: test`` / ``val`` evaluate ``pretrained_path``; ``mode: resume``
continues it at its epoch + 1 with its optimizer's state and ``best_val``;
``mode: test_6fold`` evaluates ``pretrained_path.format(area=k)`` on Area_k
for k = 1..6 and sums the six confusion matrices. A checkpoint is written
every epoch (``_ckpt_best`` where the epoch's mIoU is the best), as in the
JAX package. The two opt-in switches of ``cls_main.fused_switches`` select
the fused train-BN and the fused eval SA routes.
"""
from __future__ import annotations

import logging
import os
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch
from torch import nn

from ..datasets import build_dataloader_from_cfg
from ..datasets.data_util import get_class_weights
from ..datasets.vis3d import write_obj
from ..device import resolve_device
from ..metricslog import Summary
from ..models import build_model_from_cfg
from ..optim import clip_by_global_norm_, set_lr
from ..utils.ckpt import load_checkpoint, resume_checkpoint, save_checkpoint
from ..utils.metrics import AverageMeter, ConfusionMatrix, get_mious
from ..utils.random import set_random_seed
from .cls_main import fused_switches
from .cls_trainer import TrainState, build_train_tools

__all__ = ["main", "main_6fold", "MODES", "seg_batch",
           "make_seg_train_step", "make_seg_eval_step",
           "make_sphere_logits_step", "validate_seg", "validate_sphere",
           "train_seg_epoch"]

MODES = ("train", "val", "test", "resume", "test_6fold")


def seg_batch(batch, device: torch.device, cfg) -> dict:
    """A loader batch as device tensors: ``pos`` (f32), ``x`` the features
    ``cfg.feature_keys`` names (``pos``, ``x``, ``heights``; default
    ``pos,heights``) side by side in that order, ``y`` (int64) and, where
    the batch has one, ``mask`` (int32: a sphere's real points). A
    sphere's ``cloud_index`` and ``input_inds`` stay on the host."""
    keys = cfg.get("feature_keys", "pos,heights").split(",")
    for k in keys:
        if k not in ("pos", "x", "heights"):
            raise ValueError(f"unknown feature key {k}")
    parts = [np.asarray(batch[k], np.float32) for k in keys]
    x = np.concatenate(parts, axis=-1) if len(parts) > 1 else parts[0]

    def dev(v, dtype):
        return torch.as_tensor(v).to(device, dtype, non_blocking=True)

    out = {"pos": dev(batch["pos"], torch.float32).contiguous(),
           "x": dev(x, torch.float32).contiguous(),
           "y": dev(batch["y"], torch.int64)}
    if "mask" in batch:
        out["mask"] = dev(batch["mask"], torch.int32)
    return out


def make_seg_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                        criterion: Callable, cfg,
                        fused_train_bn: bool = False) -> Callable:
    """``train_step(state, batch, lr=None, dropout_mask=None,
    generator=None) -> (state, loss, preds)``.

    ``batch`` holds device tensors ``pos (B, N, 3)``, ``x (B, N, C)`` and
    ``y (B, N)`` (:func:`seg_batch`), and ``mask (B, N)`` where the batch
    is of spheres: a criterion whose name holds "mask" then takes it (JAX
    ``make_seg_steps``). The head's dropout keep-mask (B, N, C') is
    ``dropout_mask``, or drawn from ``generator`` (``None``: the default
    one). ``fused_train_bn`` sends the encoder's standard SA stages through
    the fused train-BN op where they fit. ``loss`` and ``preds (B, N)`` are
    device tensors."""
    clip = cfg.get("grad_norm_clip")
    masked = "mask" in str(cfg.get("criterion_args", {}).get(
        "NAME", "")).lower()
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
        if masked and "mask" in batch:
            loss = criterion(logits.float(), batch["y"], batch["mask"])
        else:
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


def make_sphere_logits_step(model: nn.Module,
                            fused_eval: bool = False) -> Callable:
    """``logits_step(state, batch) -> logits (B, N, classes)``: the eval
    forward's logits for the sphere vote, on the fused route when asked."""

    @torch.no_grad()
    def logits_step(state: TrainState, batch):
        model.eval()
        return model(batch["pos"], batch["x"], fused_eval=fused_eval)

    return logits_step


def _metrics(cm: ConfusionMatrix) -> dict:
    miou, macc, oa, ious, accs = get_mious(cm.tp, cm.union, cm.count)
    return {"miou": miou, "macc": macc, "oa": oa, "ious": ious.tolist(),
            "accs": accs.tolist()}


def _seg_confusion(eval_step: Callable, state: TrainState,
                   loader: Iterable, cfg) -> ConfusionMatrix:
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
    return cm


def validate_seg(eval_step: Callable, state: TrainState, loader: Iterable,
                 cfg) -> dict:
    """``{"miou", "macc", "oa", "ious", "accs"}`` (percent) over every point
    of ``loader``'s crops. A padded last batch says how many of its rows are
    real in ``n_valid``; the rest are cut before they are counted."""
    return _metrics(_seg_confusion(eval_step, state, loader, cfg))


def _to_host(t: torch.Tensor):
    """Start ``t``'s copy to the host: (host tensor, event that marks it
    done, or None on the CPU)."""
    if t.device.type != "cuda":
        return t, None
    host = t.to("cpu", non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def validate_sphere(logits_step: Callable, state: TrainState, loader,
                    cfg) -> dict:
    """The sphere vote (parity: JAX ``validate_sphere``, reference
    examples/segmentation/main.py:433-506): each sphere's logits are summed
    in float64 onto its area's subsampled cloud (``np.add.at`` in the
    loader's order, the real rows of a padded last batch only), the argmax
    of each subsampled point is projected onto the area's original points
    (``loader.dataset.projections``) and the points that some sphere
    covered are scored. A batch's logits come to the host in one copy,
    summed while the next batch runs. With ``cfg.visualize`` and
    ``cfg.run_dir`` each area's input, ground truth and prediction go to
    ``<run_dir>/visualization/{input,gt,pred}-<area index>.obj``. Returns
    ``{"miou", "macc", "oa", "ious", "accs"}`` (percent)."""
    ds = loader.dataset
    sums = [np.zeros((p.shape[0], cfg.num_classes), np.float64)
            for p in ds.sub_points]
    counts = [np.zeros(p.shape[0], np.int64) for p in ds.sub_points]
    device = state.device

    def accumulate(host, done, inds, clouds, n_valid):
        if done is not None:
            done.synchronize()
        logits = host.numpy()
        for b in range(n_valid):
            ci = int(clouds[b])
            np.add.at(sums[ci], inds[b], logits[b])
            np.add.at(counts[ci], inds[b], 1)

    pending = None
    for batch in loader:
        batch = dict(batch)
        n_valid = int(batch.pop("n_valid", len(batch["y"])))
        inds = np.asarray(batch.pop("input_inds"))[:n_valid]
        clouds = np.asarray(batch.pop("cloud_index"))[:n_valid]
        logits = logits_step(state, seg_batch(batch, device, cfg)).float()
        if pending is not None:
            accumulate(*pending)
        pending = (*_to_host(logits), inds, clouds, n_valid)
    if pending is not None:
        accumulate(*pending)
    cm = ConfusionMatrix(num_classes=cfg.num_classes,
                         ignore_index=cfg.get("ignore_index"))
    for ci in range(len(sums)):
        seen = counts[ci] > 0
        sub_pred = np.argmax(sums[ci], -1)
        proj = ds.projections[ci]
        keep = seen[proj]
        cm.update(sub_pred[proj][keep], ds.clouds_labels[ci][keep])
        if cfg.get("visualize") and cfg.get("run_dir"):
            _write_sphere_objs(ds, ci, sub_pred[proj], cfg.run_dir)
    return _metrics(cm)


def _write_sphere_objs(ds, ci: int, pred: np.ndarray, run_dir: str) -> None:
    """Area ``ci``'s input colours, ground truth and prediction as OBJ
    files (reference examples/segmentation/main.py:481-505)."""
    vis_dir = os.path.join(run_dir, "visualization")
    os.makedirs(vis_dir, exist_ok=True)
    cmap = getattr(ds, "cmap", None)
    coord = ds.clouds_points[ci]
    rgb = ds.clouds_colors[ci].astype(np.float32)
    rgb = rgb / 255.0 if rgb.max() > 1 else rgb
    write_obj(coord, rgb, os.path.join(vis_dir, f"input-{ci}.obj"))
    if cmap is not None:
        write_obj(coord, cmap[ds.clouds_labels[ci]] / 255.0,
                  os.path.join(vis_dir, f"gt-{ci}.obj"))
        write_obj(coord, cmap[pred] / 255.0,
                  os.path.join(vis_dir, f"pred-{ci}.obj"))


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


def main_6fold(cfg, device: Optional[str] = None) -> dict:
    """S3DIS six-fold test (parity: JAX ``main_6fold``, reference
    examples/segmentation/test_s3dis_6fold.py:23-45): for k = 1..6 the
    validation loader of ``test_area: k`` and the checkpoint
    ``pretrained_path.format(area=k)``, the eval forward over every crop,
    each area's confusion matrix and their sum. Returns ``{k: {"miou",
    "macc", "oa"}, ..., "overall": {...}}`` (percent)."""
    if not cfg.get("pretrained_path"):
        raise ValueError("mode test_6fold needs pretrained_path (a format "
                         "string with {area})")
    dev = resolve_device(device)
    seed = cfg.get("seed") or 0
    if cfg.model.get("in_channels", None) is None:
        cfg.model.in_channels = cfg.model.encoder_args.in_channels
    model = build_model_from_cfg(cfg.model, device=dev, seed=seed)
    _, fused_eval = fused_switches()
    eval_step = make_seg_eval_step(model, fused_eval=fused_eval)
    state = TrainState(model, None)
    total = ConfusionMatrix(num_classes=cfg.num_classes,
                            ignore_index=cfg.get("ignore_index"))
    results = {}
    for area in range(1, 7):
        cfg.dataset.common.test_area = area
        val_loader = build_dataloader_from_cfg(
            cfg.get("val_batch_size", cfg.batch_size), cfg.dataset,
            cfg.dataloader, datatransforms_cfg=cfg.datatransforms,
            split="val", seed=seed)
        load_checkpoint(model, cfg.pretrained_path.format(area=area))
        cm = _seg_confusion(eval_step, state, val_loader, cfg)
        total.value += cm.value
        perf = _metrics(cm)
        logging.info("Area %d: miou %.2f macc %.2f oa %.2f", area,
                     perf["miou"], perf["macc"], perf["oa"])
        results[area] = {k: perf[k] for k in ("miou", "macc", "oa")}
    perf = _metrics(total)
    logging.info("6-fold overall: miou %.2f macc %.2f oa %.2f ious %s",
                 perf["miou"], perf["macc"], perf["oa"],
                 np.round(perf["ious"], 2))
    results["overall"] = {k: perf[k] for k in ("miou", "macc", "oa")}
    return results


def main(cfg, device: Optional[str] = None):
    """Run ``cfg.mode`` on ``device`` (``None``: the card). Returns the best
    mIoU (``train``, ``resume``), the metrics of ``validate_seg`` or
    ``validate_sphere`` (``test``, ``val``) or those of
    :func:`main_6fold` (``test_6fold``)."""
    mode = cfg.get("mode", "train")
    if mode not in MODES:
        raise NotImplementedError(f"mode {mode} is not ported for scene "
                                  f"segmentation")
    if mode == "test_6fold":
        return main_6fold(cfg, device)
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
    if "sphere" in str(cfg.dataset.common.NAME).lower():
        logits_step = make_sphere_logits_step(model, fused_eval=fused_eval)

        def validate(st):
            return validate_sphere(logits_step, st, val_loader, cfg)
    else:
        eval_step = make_seg_eval_step(model, fused_eval=fused_eval)

        def validate(st):
            return validate_seg(eval_step, st, val_loader, cfg)

    if mode in ("test", "val"):
        if not cfg.get("pretrained_path"):
            raise ValueError(f"mode {mode} needs pretrained_path")
        load_checkpoint(model, cfg.pretrained_path)
        perf = validate(state)
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
            perf = validate(state)
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
