"""Seeding (reference openpoints/utils/random.py:6).

Counterpart of ``adaptpoint_tpu/utils/random.py``: seeds Python's and
numpy's global generators and PyTorch's, and returns the
``torch.Generator`` on ``device`` that the engine hands to its train steps
(the JAX package returns a root key instead).
"""
from __future__ import annotations

import random

import numpy as np
import torch

__all__ = ["set_random_seed"]


def set_random_seed(seed: int = 0, device="cpu",
                    deterministic: bool = False) -> torch.Generator:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    if deterministic:
        # the kernels' atomic scatters stay unordered either way
        torch.use_deterministic_algorithms(True, warn_only=True)
    return torch.Generator(device=device).manual_seed(seed)
