"""Perception-guidance feedback loss.

Counterpart of ``adaptpoint_tpu/adapt/feedback.py``: the frozen classifier's
loss on the fake batch against its loss on the real batch; the target
hardness ratio anneals ``hardratio_s -> hardratio`` over training;
``loss = |1 - exp(loss_fake - ratio * loss_real)|``.
"""
from __future__ import annotations

import torch

__all__ = ["update_hardratio", "feedback_loss"]


def update_hardratio(start: float, end: float, epoch, total_epoch):
    return start + (end - start) * epoch / total_epoch


def feedback_loss(loss_fake: torch.Tensor, loss_real: torch.Tensor,
                  hardratio) -> torch.Tensor:
    return torch.abs(1.0 - torch.exp(loss_fake - hardratio * loss_real))
