"""Anchor-local deformation math shared by PointWOLF and the AdaptPoint
augmentor: plain functions on tensors with explicit randomness.

Counterpart of ``adaptpoint_tpu/adapt/common.py``: random axis subsets,
per-anchor rotation / scale / translation with a Bernoulli dropout per
transform, Euler-angle rotation composition, Gaussian kernel regression along
a random projection axis, and unit-sphere normalisation.

Every random draw is an argument. :class:`WolfDraws` holds the draws of one
call as tensors (a test hands in the JAX package's draws);
:func:`draw_wolf` makes them from a ``torch.Generator`` on the input's device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch

__all__ = ["WolfDraws", "draw_wolf", "random_axis", "apply_local_transform",
           "kernel_regression", "normalize_cloud", "pointwolf_transform"]


@dataclass
class WolfDraws:
    """The random draws of one ``pointwolf_transform`` call.

    ``drop`` (B, M, 3): 1 keeps, 0 drops each anchor's rotation, scale and
    translation; ``axis_code`` (B, M) and ``proj_code`` (B, 1): integers in
    1..7 whose three bits select the axes a scale / translation acts on and
    the kernel regression projects on; ``values``: for random PointWOLF
    (``probs=None``) the three (B, M, 3) uniform draws, rotation in degrees
    in [-R, R], scale in [1, S], translation in [-T, T]."""
    drop: torch.Tensor
    axis_code: torch.Tensor
    proj_code: torch.Tensor
    values: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None


def draw_wolf(generator: Optional[torch.Generator], batch: int, n_anchor: int,
              device, *, r_range: float = 0.0, s_range: float = 1.0,
              t_range: float = 0.0, with_values: bool = False) -> WolfDraws:
    """The draws of one call from ``generator`` (``None``: the default one of
    ``device``)."""
    def rand(*shape):
        return torch.rand(shape, generator=generator, device=device)

    drop = (rand(batch, n_anchor, 3) < 0.5).float()
    axis_code = torch.randint(1, 8, (batch, n_anchor), generator=generator,
                              device=device)
    proj_code = torch.randint(1, 8, (batch, 1), generator=generator,
                              device=device)
    values = None
    if with_values:
        values = (rand(batch, n_anchor, 3) * (2.0 * r_range) - r_range,
                  rand(batch, n_anchor, 3) * (s_range - 1.0) + 1.0,
                  rand(batch, n_anchor, 3) * (2.0 * t_range) - t_range)
    return WolfDraws(drop, axis_code, proj_code, values)


def random_axis(code: torch.Tensor) -> torch.Tensor:
    """Axis codes 1..7 (B, n) -> their 0/1 bits (B, n, 3): a non-empty axis
    subset."""
    shifts = torch.arange(3, device=code.device)
    return ((code.long()[..., None] >> shifts) & 1).float()


def _rotation_matrix(degree: torch.Tensor) -> torch.Tensor:
    """Euler angles (B, M, 3) -> rotations (B, M, 3, 3), ZYX composition."""
    s, c = torch.sin(degree), torch.cos(degree)
    sx, sy, sz = s[..., 0], s[..., 1], s[..., 2]
    cx, cy, cz = c[..., 0], c[..., 1], c[..., 2]
    row0 = torch.stack([cz * cy, cz * sy * sx - sz * cx,
                        cz * sy * cx + sz * sx], -1)
    row1 = torch.stack([sz * cy, sz * sy * sx + cz * cy,
                        sz * sy * cx - cz * sx], -1)
    row2 = torch.stack([-sy, cy * sx, cy * cx], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def apply_local_transform(pos_normalize: torch.Tensor, degree: torch.Tensor,
                          scale: torch.Tensor,
                          trl: torch.Tensor) -> torch.Tensor:
    """pos (B, M, N, 3) @ R @ diag(scale) + trl."""
    rot = _rotation_matrix(degree)
    out = torch.einsum("bmnc,bmcd->bmnd", pos_normalize, rot)
    out = out * scale[:, :, None, :]
    return out + trl[:, :, None, :]


def _randomize_transform(draws: WolfDraws, degree, scale_raw, trl):
    """The per-transform dropout and the random-axis masking: degree,
    scale_raw (in [1, S]) and trl (B, M, 3) -> masked (degree, scale, trl)."""
    drop = draws.drop.to(degree.dtype)
    axis = random_axis(draws.axis_code).to(degree.dtype)
    degree = degree * drop[:, :, 0:1]
    scale = scale_raw * drop[:, :, 1:2] * axis
    scale = scale + (scale == 0).to(scale.dtype)  # zeros -> 1: no scaling
    trl = trl * drop[:, :, 2:3] * axis
    return degree, scale, trl


def kernel_regression(proj_code: torch.Tensor, pos: torch.Tensor,
                      pos_anchor: torch.Tensor, pos_transformed: torch.Tensor,
                      sigma: float) -> torch.Tensor:
    """Gaussian-kernel blend of the M per-anchor transformed copies along the
    projection axes ``proj_code`` (B, 1) selects: pos (B, N, 3), pos_anchor
    (B, M, 3), pos_transformed (B, M, N, 3) -> (B, N, 3)."""
    sub = pos_anchor[:, :, None, :] - pos[:, None, :, :]  # (B, M, N, 3)
    proj = random_axis(proj_code).to(pos.dtype)  # (B, 1, 3)
    sub = sub * proj[:, :, None, :]
    d2 = (sub ** 2).sum(dim=-1)  # (B, M, N)
    weight = torch.exp(-0.5 * d2 / (sigma ** 2))
    num = (weight[..., None] * pos_transformed).sum(dim=1)
    den = weight.sum(dim=1)[..., None]
    return num / den


def normalize_cloud(pos: torch.Tensor) -> torch.Tensor:
    """Centre and scale into the unit sphere."""
    pos = pos - pos.mean(dim=-2, keepdim=True)
    scale = 1.0 / torch.sqrt((pos ** 2).sum(dim=-1)).amax(dim=-1) * 0.999999
    return pos * scale[:, None, None]


def pointwolf_transform(draws: Union[WolfDraws, torch.Generator, None],
                        xyz: torch.Tensor, anchors: torch.Tensor, *,
                        sigma: float, r_range: float, s_range: float,
                        t_range: float,
                        probs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The PointWOLF pipeline from anchors: canonicalise, per-anchor
    rotation / scale / translation (random, or squashed from the ``probs``
    logits of the learned augmentor), kernel regression, unit-sphere
    normalisation. xyz (B, N, 3), anchors (B, M, 3), probs ``None`` or
    (B, M, 9) -> (B, N, 3). ``draws`` is a :class:`WolfDraws`, or the
    generator to draw them from."""
    b, m = anchors.shape[:2]
    if not isinstance(draws, WolfDraws):
        draws = draw_wolf(draws, b, m, xyz.device, r_range=r_range,
                          s_range=s_range, t_range=t_range,
                          with_values=probs is None)
    if probs is None:
        if draws.values is None:
            raise ValueError("random PointWOLF needs WolfDraws.values")
        deg, scale_raw, trl = (v.to(xyz.dtype) for v in draws.values)
        degree = math.pi * deg / 180.0
    else:
        probs = probs.to(xyz.dtype)
        degree = math.pi * torch.tanh(probs[:, :, 0:3]) * r_range / 180.0
        scale_raw = torch.sigmoid(probs[:, :, 3:6]) * (s_range - 1.0) + 1.0
        trl = torch.tanh(probs[:, :, 6:9]) * t_range
    degree, scale, trl = _randomize_transform(draws, degree, scale_raw, trl)
    pos_normalize = xyz[:, None, :, :] - anchors[:, :, None, :]
    transformed = apply_local_transform(pos_normalize, degree, scale, trl)
    transformed = transformed + anchors[:, :, None, :]
    new = kernel_regression(draws.proj_code, xyz, anchors, transformed, sigma)
    return normalize_cloud(new)
