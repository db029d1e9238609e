"""Device policy of the port.

Every entry point takes a ``device`` argument. ``None`` means the card:
``cuda`` when PyTorch sees one, and an error when it does not -- the port
never drops quietly to the CPU. The CPU runs only when the caller asks for
it (the tests do), and then every op takes its plain PyTorch version.

Resolving a device also turns TF32 off for matmuls and cuDNN, so that
float32 means float32 on the card as it does on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda`` (raises without a GPU); else ``torch.device(device)``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{dev} requested but no CUDA device is available")
    return dev
