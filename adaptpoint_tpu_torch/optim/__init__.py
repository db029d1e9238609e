"""Optimizer factory.

Counterpart of ``adaptpoint_tpu/optim/__init__.py`` for ``adamw``, ``adam``
and ``sgd``: NAME dispatch, and weight decay that exempts every parameter
with fewer than two dimensions (biases, norm scales) unless
``filter_bias_and_bn`` is off. The update rules are PyTorch's own
optimizers, which compute what the JAX package's optax chains compute
(``p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)`` for adamw). The learning
rate is a per-step input: :func:`set_lr` writes it into the parameter groups.

Global-norm clipping, which the JAX factory chains in front of the
optimizer, is :func:`clip_by_global_norm_` here and the train step calls it.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Union

import torch
from torch import nn

__all__ = ["build_optimizer_from_cfg", "weight_decay_mask", "set_lr",
           "clip_by_global_norm_"]

_LATER = ("lamb", "lars", "radam", "adagrad", "rmsprop", "rmsproptf",
          "rmsprop_tf", "adabelief", "adafactor", "nadam", "nadamw",
          "novograd", "nvnovograd", "adamp", "sgdp", "adahessian",
          "lookahead")


def weight_decay_mask(params: Iterable[torch.Tensor]) -> List[bool]:
    """True where weight decay applies: only parameters with ndim >= 2."""
    return [p.ndim >= 2 for p in params]


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set the learning rate of every parameter group (no device sync)."""
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


def clip_by_global_norm_(grads: List[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place by ``max_norm / norm`` when their global
    2-norm reaches ``max_norm``, and leave them as they are below it (the
    rule of ``optax.clip_by_global_norm``; ``clip_grad_norm_`` divides by
    ``norm + 1e-6`` instead). One norm, one multiply, no host sync. Returns
    the norm before clipping."""
    norm = torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


def build_optimizer_from_cfg(params: Union[nn.Module, Iterable[torch.Tensor]],
                             lr: float, NAME: str = "adamw",
                             weight_decay: float = 0.0,
                             momentum: float = 0.9, betas=(0.9, 0.999),
                             eps: float = 1e-8,
                             filter_bias_and_bn: bool = True,
                             **kwargs) -> torch.optim.Optimizer:
    """``params`` is a module or its parameters. Two parameter groups carry
    the decay mask: group 0 decays, group 1 (ndim < 2) does not."""
    name = NAME.lower()
    if isinstance(params, nn.Module):
        params = params.parameters()
    params = [p for p in params if p.requires_grad]
    if kwargs.get("layer_decay") is not None:
        raise NotImplementedError("layer_decay is not ported yet")
    if filter_bias_and_bn:
        mask = weight_decay_mask(params)
        groups = [
            {"params": [p for p, m in zip(params, mask) if m],
             "weight_decay": weight_decay},
            {"params": [p for p, m in zip(params, mask) if not m],
             "weight_decay": 0.0}]
    else:
        groups = [{"params": params, "weight_decay": weight_decay}]
    if name in ("adamw", "admw"):
        return torch.optim.AdamW(groups, lr=lr, betas=tuple(betas), eps=eps)
    if name == "adam":  # the JAX factory applies no decay for plain adam
        for g in groups:
            g["weight_decay"] = 0.0
        return torch.optim.Adam(groups, lr=lr, betas=tuple(betas), eps=eps)
    if name == "sgd":
        return torch.optim.SGD(groups, lr=lr, momentum=momentum,
                               nesterov=kwargs.get("nesterov", False))
    if name in _LATER:
        raise NotImplementedError(
            f"optimizer {NAME} is not ported yet: it comes with the slice "
            f"that ports the remaining optimizers of the factory")
    raise ValueError(f"unsupported optimizer {NAME}")
