"""Transform registry and composition.

Counterpart of ``adaptpoint_tpu/transforms/transforms_factory.py``
(reference openpoints/transforms/transforms_factory.py:4-60). A transform
is a numpy callable ``(data dict, np.random.Generator) -> data dict``.
Only the transforms the classification cfgs name are ported; any other
name raises.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..utils.registry import Registry

__all__ = ["DataTransforms", "Compose", "build_transforms_from_cfg"]

DataTransforms = Registry("datatransforms")


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, data, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        for t in self.transforms:
            data = t(data, rng)
        return data


def build_transforms_from_cfg(split: str,
                              datatransforms_cfg) -> Optional[Compose]:
    if datatransforms_cfg is None:
        return None
    names = datatransforms_cfg.get(split, None)
    kwargs = datatransforms_cfg.get("kwargs", None) or {}
    if not names:
        return None
    for name in names:
        if name not in DataTransforms:
            raise NotImplementedError(f"transform {name} is not ported yet")
    return Compose([DataTransforms.build({"NAME": name}, default_args=kwargs)
                    for name in names])
