"""AdaptPoint model registry (augmentor and discriminator).

Counterpart of ``adaptpoint_tpu/adapt/build.py``.
:func:`build_adaptpointmodels_from_cfg` is the entry point a user calls: it
places the model on the card unless asked for the CPU, and ``seed``
re-initialises the weights from a ``torch.Generator``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ..models.build import init_weights_
from ..utils.registry import Registry

__all__ = ["ADAPTMODELS", "build_adaptpointmodels_from_cfg"]

ADAPTMODELS = Registry("adaptmodels")


def build_adaptpointmodels_from_cfg(cfg, device: Optional[str] = None,
                                    seed: Optional[int] = None,
                                    **kwargs) -> nn.Module:
    dev = resolve_device(device)
    model = ADAPTMODELS.build(cfg, default_args=kwargs or None)
    if seed is not None:
        gen = torch.Generator().manual_seed(int(seed))
        init_weights_(model, gen)
        for mod in model.modules():  # layers that hold no Conv/Linear module
            if hasattr(mod, "reset_parameters_"):
                mod.reset_parameters_(gen)
    return model.to(dev)
