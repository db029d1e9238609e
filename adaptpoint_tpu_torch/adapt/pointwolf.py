"""Non-learned PointWOLF augmentation, batched on the device.

Counterpart of ``adaptpoint_tpu/adapt/pointwolf.py``: the random variant of
the anchor-local deformation (the ``wpointwolf`` / ``wolfmix`` baselines).
"""
from __future__ import annotations

from typing import Union

import torch

from .. import ops
from .common import WolfDraws, pointwolf_transform

__all__ = ["pointwolf", "PointWOLF"]


def pointwolf(draws: Union[WolfDraws, torch.Generator, None],
              xyz: torch.Tensor, w_num_anchor: int = 4, w_sigma: float = 0.5,
              w_R_range: float = 10.0, w_S_range: float = 3.0,
              w_T_range: float = 0.25):
    """xyz (B, N, 3) -> (xyz, xyz_new); anchors by FPS."""
    fps_idx = ops.furthest_point_sample(xyz, w_num_anchor)
    anchors = ops.index_points(xyz, fps_idx)
    new = pointwolf_transform(draws, xyz, anchors, sigma=w_sigma,
                              r_range=w_R_range, s_range=w_S_range,
                              t_range=w_T_range, probs=None)
    return xyz, new


class PointWOLF:
    """Callable wrapper keeping the reference's constructor signature."""

    def __init__(self, w_num_anchor=4, w_sigma=0.5, w_R_range=10,
                 w_S_range=3, w_T_range=0.25, **kwargs):
        self.args = (int(w_num_anchor), float(w_sigma), float(w_R_range),
                     float(w_S_range), float(w_T_range))

    def __call__(self, draws, xyz):
        return pointwolf(draws, xyz, *self.args)
