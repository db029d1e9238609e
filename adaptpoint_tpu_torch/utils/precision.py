"""Scoped compute-dtype policy.

Counterpart of ``adaptpoint_tpu/utils/precision.py``. ``dtype_override("bf16")``
scopes the bf16 compute policy over the module calls made inside the
``with`` block; :func:`compute_dtype` is what the modules read in their
``forward``, where the JAX package's flax modules read it at trace time.
The phase-A ``gan_step`` enters it around the generator, the discriminator
and both classifier passes; phase B's train step never does.

Under the policy parameters stay f32 and only the places flax rounds round
(``models.layers.blocks.dense`` and ``BatchNorm``): a pointwise linear map
takes bf16 operands and gives a bf16 product, its bias added in bf16; a
BatchNorm takes its statistics in f32 and rounds its output to bf16 once.
Without it (``None``) every module computes in its tensors' own type.
This is not ``torch.autocast``: autocast's per-op lists round elsewhere and
would recast the kernels' inputs.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Union

import torch

__all__ = ["dtype_override", "compute_dtype", "parse_precision"]

_OVERRIDE: contextvars.ContextVar = contextvars.ContextVar(
    "adaptpoint_torch_dtype_override", default=None)


def parse_precision(name: Union[str, torch.dtype, None]
                    ) -> Optional[torch.dtype]:
    """``"bf16"`` / ``"bfloat16"`` / ``torch.bfloat16`` -> ``torch.bfloat16``;
    ``"f32"`` / ``"float32"`` / ``torch.float32`` / ``None`` -> ``None`` (no
    policy)."""
    if name is None or name == torch.float32:
        return None
    if name == torch.bfloat16:
        return torch.bfloat16
    key = str(name).lower()
    if key in ("bf16", "bfloat16"):
        return torch.bfloat16
    if key in ("f32", "float32", "fp32"):
        return None
    raise ValueError(f"unknown precision {name!r}: bf16 or f32")


@contextlib.contextmanager
def dtype_override(dtype: Union[str, torch.dtype, None]):
    """Scope a compute dtype (see :func:`parse_precision`) over the module
    calls inside."""
    token = _OVERRIDE.set(parse_precision(dtype))
    try:
        yield
    finally:
        _OVERRIDE.reset(token)


def compute_dtype() -> Optional[torch.dtype]:
    """The active compute dtype: ``torch.bfloat16`` inside a bf16
    :func:`dtype_override`, else ``None``."""
    return _OVERRIDE.get()
