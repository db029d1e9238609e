"""Checkpoints, torch-native.

Counterpart of ``adaptpoint_tpu/utils/ckpt.py`` (reference
openpoints/utils/ckpt_util.py:61-216). ``save_checkpoint`` writes
``<ckpt_dir>/<run_name>_ckpt_latest.pth`` with ``torch.save``, copies it to
``_ckpt_best.pth`` on a best epoch and to ``_E<epoch>.pth`` every
``save_freq`` epochs; the file holds ``model`` (the state_dict, reference
names), ``optimizer``, ``epoch`` and ``best_val``. ``load_checkpoint``
restores the model (and the optimizer when given one) and raises on a
missing or unexpected key, so that a checkpoint of another model is never
evaluated as if it were loaded. Resuming a run waits for its slice.
"""
from __future__ import annotations

import os
import shutil
from typing import Optional, Tuple

import torch
from torch import nn

__all__ = ["save_checkpoint", "load_checkpoint"]


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
