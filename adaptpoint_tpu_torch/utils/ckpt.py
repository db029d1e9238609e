"""Checkpoints, torch-native.

Counterpart of ``adaptpoint_tpu/utils/ckpt.py`` (reference
openpoints/utils/ckpt_util.py:61-216). ``save_checkpoint`` writes
``<ckpt_dir>/<run_name>_ckpt_latest.pth`` with ``torch.save``, copies it to
``_ckpt_best.pth`` on a best epoch and to ``_E<epoch>.pth`` every
``save_freq`` epochs; the file holds ``model`` (the state_dict, reference
names), ``optimizer``, ``epoch`` and ``best_val``. ``load_checkpoint``
restores the model (and the optimizer when given one) and raises on a
missing or unexpected key, so that a checkpoint of another model is never
evaluated as if it were loaded. ``resume_checkpoint`` restores the model,
the optimizer, ``epoch`` and ``best_val`` and sets ``cfg.start_epoch =
epoch + 1`` (JAX ``utils/ckpt.py`` ``resume_checkpoint``).

The ``.pth`` carries torch's own optimizer state (Adam's moments and step
count), so loading it is what the JAX package's ``maybe_splice_opt_moments``
does for checkpoints converted from the reference: the moments continue
where the saved run left them.
"""
from __future__ import annotations

import logging
import os
import shutil
from typing import Optional, Tuple

import torch
from torch import nn

__all__ = ["save_checkpoint", "load_checkpoint", "resume_checkpoint"]


def save_checkpoint(cfg, model: nn.Module,
                    optimizer: Optional[torch.optim.Optimizer], epoch: int,
                    is_best: bool = False,
                    additional: Optional[dict] = None) -> str:
    payload = {"model": model.state_dict(), "epoch": int(epoch)}
    if optimizer is not None:
        payload["optimizer"] = optimizer.state_dict()
    payload.update(additional or {})
    os.makedirs(cfg.ckpt_dir, exist_ok=True)
    path = os.path.join(cfg.ckpt_dir, f"{cfg.run_name}_ckpt_latest.pth")
    torch.save(payload, path)
    if is_best:
        shutil.copyfile(path, os.path.join(
            cfg.ckpt_dir, f"{cfg.run_name}_ckpt_best.pth"))
    save_freq = cfg.get("save_freq", -1)
    if save_freq and save_freq > 0 and epoch % save_freq == 0:
        shutil.copyfile(path, os.path.join(
            cfg.ckpt_dir, f"{cfg.run_name}_E{epoch}.pth"))
    return path


def load_checkpoint(model: nn.Module, path: str,
                    optimizer: Optional[torch.optim.Optimizer] = None
                    ) -> Tuple[int, float]:
    """Load ``path`` into ``model`` (and ``optimizer``); returns
    ``(epoch, best_val)``. A file holding a bare state_dict loads too; a
    key the model lacks, or one of the model's keys the file lacks, raises."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(payload.get("model", payload), strict=True)
    if optimizer is not None and "optimizer" in payload:
        optimizer.load_state_dict(payload["optimizer"])
    return int(payload.get("epoch", 0)), float(payload.get("best_val", 0.0))


def resume_checkpoint(cfg, model: nn.Module,
                      optimizer: Optional[torch.optim.Optimizer],
                      pretrained_path: Optional[str] = None
                      ) -> Tuple[int, float]:
    """Restore ``model`` and ``optimizer`` from ``pretrained_path`` (default
    ``cfg.pretrained_path``) and continue at the next epoch: sets
    ``cfg.start_epoch = epoch + 1``. Returns ``(epoch, best_val)``."""
    path = pretrained_path or cfg.get("pretrained_path")
    epoch, best_val = load_checkpoint(model, path, optimizer)
    cfg.start_epoch = epoch + 1
    logging.info("Resumed from %s at epoch %d (best_val=%s)", path, epoch,
                 best_val)
    return epoch, best_val
