"""PointNet encoder with input and feature T-Nets, channels-last.

Counterpart of ``adaptpoint_tpu/models/backbone/pointnet.py`` (``TNet``,
``PointNetEncoder``; reference openpoints pointnet.py STN3d / STNkd /
PointNetEncoder): the shared MLP 64-64, the feature transform, 64-128-1024
and a global max-pool; the input transform turns the xyz channels only.
Every conv and linear layer has a bias and a BatchNorm after it, computed in
float32 as the JAX package's bare flax ``Dense`` / ``BatchNorm`` are. Module
names follow the reference layout (``stn.conv1`` ... ``stn.fc3``,
``stn.bn1`` ... ``bn5``, ``conv0_1`` ... ``conv3``, ``bn0_1`` ... ``bn3``).
No kernel of the port is on this path: it is matrix products and
reductions. The segmentation form (``is_seg``) waits with the segmentation
decoders (ROADMAP A.7).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..build import MODELS
from ..layers.blocks import BatchNorm

__all__ = ["TNet", "PointNetEncoder"]


def _bn(c: int) -> BatchNorm:
    return BatchNorm(c, eps=1e-5, momentum=0.1)


def _conv_bn(x: torch.Tensor, conv: nn.Module, bn: BatchNorm,
             relu: bool = True) -> torch.Tensor:
    """``bn(x @ W^T + b)`` over the last axis [+ ReLU]."""
    y = F.linear(x, conv.weight.flatten(1), conv.bias)
    y = bn(y.reshape(-1, y.shape[-1])).reshape(y.shape)
    return F.relu(y) if relu else y


class TNet(nn.Module):
    """A k x k transform, identity at the start: its last layer starts at
    zeros and the identity is added (parity: pointnet.py STN3d / STNkd)."""

    def __init__(self, k: int, in_channels: Optional[int] = None):
        super().__init__()
        self.k = int(k)
        c_in = in_channels or k
        self.conv1 = nn.Conv1d(c_in, 64, 1)
        self.conv2 = nn.Conv1d(64, 128, 1)
        self.conv3 = nn.Conv1d(128, 1024, 1)
        self.fc1 = nn.Linear(1024, 512)
        self.fc2 = nn.Linear(512, 256)
        self.fc3 = nn.Linear(256, self.k * self.k)
        for i, c in enumerate((64, 128, 1024, 512, 256), 1):
            setattr(self, f"bn{i}", _bn(c))
        nn.init.zeros_(self.fc3.weight)
        nn.init.zeros_(self.fc3.bias)
        self.fc3.zero_init = True  # build_model_from_cfg's seed keeps it

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _conv_bn(x, self.conv1, self.bn1)
        h = _conv_bn(h, self.conv2, self.bn2)
        h = _conv_bn(h, self.conv3, self.bn3).amax(dim=1)  # (B, 1024)
        h = _conv_bn(h, self.fc1, self.bn4)
        h = _conv_bn(h, self.fc2, self.bn5)
        h = self.fc3(h)
        iden = torch.eye(self.k, dtype=h.dtype, device=h.device).reshape(1, -1)
        return (h + iden).reshape(-1, self.k, self.k)


@MODELS.register_module()
class PointNetEncoder(nn.Module):
    """parity: pointnet.py PointNetEncoder."""

    out_channels = 1024

    def __init__(self, in_channels: int = 3, input_transform: bool = True,
                 feature_transform: bool = True):
        super().__init__()
        self.stn = TNet(3, in_channels) if input_transform else None
        self.fstn = TNet(64) if feature_transform else None
        self.conv0_1 = nn.Conv1d(in_channels, 64, 1)
        self.conv0_2 = nn.Conv1d(64, 64, 1)
        self.conv1 = nn.Conv1d(64, 64, 1)
        self.conv2 = nn.Conv1d(64, 128, 1)
        self.conv3 = nn.Conv1d(128, 1024, 1)
        for name, c in (("bn0_1", 64), ("bn0_2", 64), ("bn1", 64),
                        ("bn2", 128), ("bn3", 1024)):
            setattr(self, name, _bn(c))

    def forward_cls_feat(self, pos: torch.Tensor,
                         x: Optional[torch.Tensor] = None) -> torch.Tensor:
        if x is None:
            x = pos
        if self.stn is not None:
            trans = self.stn(x)
            xyz = torch.einsum("bnc,bcd->bnd", x[..., :3], trans)
            x = torch.cat([xyz, x[..., 3:]], dim=-1) if x.shape[-1] > 3 \
                else xyz
        x = _conv_bn(x, self.conv0_1, self.bn0_1)
        x = _conv_bn(x, self.conv0_2, self.bn0_2)
        if self.fstn is not None:
            x = torch.einsum("bnc,bcd->bnd", x, self.fstn(x))
        x = _conv_bn(x, self.conv1, self.bn1)
        x = _conv_bn(x, self.conv2, self.bn2)
        return _conv_bn(x, self.conv3, self.bn3, relu=False).amax(dim=1)

    def forward(self, pos: torch.Tensor,
                x: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.forward_cls_feat(pos, x)
