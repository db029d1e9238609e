"""Model registry and the device-placing build entry point.

Counterpart of ``adaptpoint_tpu/models/build.py``. Modules build their
children with ``MODELS.build``; :func:`build_model_from_cfg` is the entry
point a user calls, and it places the model on the card unless asked for
the CPU.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ..utils.registry import Registry

__all__ = ["MODELS", "build_model_from_cfg", "init_weights_"]

MODELS = Registry("models")


def init_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded torch-default init: U(+-1/sqrt(fan_in)) for every conv/linear
    weight and bias (kaiming-uniform with a=sqrt(5)); BN keeps 1/0/0/1, and
    a layer marked ``zero_init`` (PointNet's T-Net output) its zeros. Then a
    module with its own distributions (``seeded_init_``: the ViT's
    xavier-uniform Linears and normal tokens) draws them from the same
    generator."""
    with torch.no_grad():
        for mod in model.modules():
            if getattr(mod, "zero_init", False):
                continue
            if isinstance(mod, (nn.Conv1d, nn.Conv2d, nn.Linear)):
                bound = 1.0 / math.sqrt(mod.weight[0].numel())
                mod.weight.uniform_(-bound, bound, generator=generator)
                if mod.bias is not None:
                    mod.bias.uniform_(-bound, bound, generator=generator)
        for mod in model.modules():
            if hasattr(mod, "seeded_init_"):
                mod.seeded_init_(generator)
    return model


def build_model_from_cfg(cfg, device: Optional[str] = None,
                         seed: Optional[int] = None) -> nn.Module:
    """Build ``cfg['NAME']`` from the registry and move it to ``device``
    (``None``: the card, raising without one). ``seed`` re-initialises the
    weights from a ``torch.Generator``. The model keeps its cfg as
    ``model.model_cfg`` so a serving artifact can rebuild it."""
    dev = resolve_device(device)
    model = MODELS.build(cfg)
    if seed is not None:
        init_weights_(model, torch.Generator().manual_seed(int(seed)))
    model.model_cfg = _plain(cfg)
    return model.to(dev)


def _plain(node):
    """EasyConfig / nested mappings -> plain dicts and lists (JSON-able)."""
    if isinstance(node, dict):
        return {k: _plain(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_plain(v) for v in node]
    return node
