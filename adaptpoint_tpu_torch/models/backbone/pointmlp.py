"""PointMLP encoder and classifier, channels-last.

Counterpart of ``adaptpoint_tpu/models/backbone/pointmlp.py``
(``_ConvBNAct``, ``_ResMLP``, ``LocalGrouper``, ``PointMLPEncoder``,
``PointMLP``; reference openpoints pointmlp.py). Each stage groups with FPS
(row 1) and the kNN of the centres on xyz (row 11, ``ops.knn_idx``), gathers
the neighbours (row 14, its scatter-add row 15 in the backward), normalises
them by the anchor and one per-cloud population std with learnt affine
parameters, then runs the residual MLPs over the neighbours, a max-pool and
the residual MLPs over the points. Module names follow the reference layout
(``embedding.net``, ``local_grouper_list.{i}.affine_*``,
``pre_blocks_list.{i}.transfer`` / ``.operation.{j}.net{1,2}``,
``pos_blocks_list.{i}.operation.{j}.net{1,2}``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..build import MODELS
from ..classification.cls_base import BaseCls
from ..layers.blocks import ConvBlock, create_act
from ... import ops

__all__ = ["LocalGrouper", "PointMLPEncoder", "PointMLP"]

_BN = {"norm": "bn"}


class _ConvBNAct(nn.Module):
    """ConvBNReLU1D (parity: pointmlp.py ConvBNReLU1D): ``net`` is conv, BN
    and the activation."""

    def __init__(self, in_channels: int, out_channels: int,
                 bias: bool = False, act: str = "relu"):
        super().__init__()
        self.net = ConvBlock(in_channels, out_channels, _BN, {"act": act},
                             kind="conv1d", bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class _ResMLP(nn.Module):
    """ConvBNReLURes1D (parity: pointmlp.py ConvBNReLURes1D):
    ``act(net2(net1(x)) + x)``, ``net2`` without its activation."""

    def __init__(self, channels: int, res_expansion: float = 1.0,
                 bias: bool = False, act: str = "relu"):
        super().__init__()
        mid = int(channels * res_expansion)
        self.net1 = ConvBlock(channels, mid, _BN, {"act": act},
                              kind="conv1d", bias=bias)
        self.net2 = ConvBlock(mid, channels, _BN, None, kind="conv1d",
                              bias=bias)
        self.act = create_act({"act": act})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.net2(self.net1(x)) + x)


class _Blocks(nn.Module):
    """A stage's residual MLPs (``operation``), after its ``transfer`` conv
    where it has one (the pre-extraction)."""

    def __init__(self, channels: int, n: int, res_expansion: float,
                 bias: bool, act: str, in_channels: Optional[int] = None):
        super().__init__()
        if in_channels is not None:
            self.transfer = _ConvBNAct(in_channels, channels, bias, act)
        self.operation = nn.ModuleList(
            [_ResMLP(channels, res_expansion, bias, act) for _ in range(n)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "transfer"):
            x = self.transfer(x)
        for blk in self.operation:
            x = blk(x)
        return x


class LocalGrouper(nn.Module):
    """FPS + kNN grouping with geometric-affine normalisation (parity:
    pointmlp.py LocalGrouper)."""

    def __init__(self, channel: int, sample_ratio: int, kneighbors: int,
                 use_xyz: bool = False, normalize: Optional[str] = "anchor"):
        super().__init__()
        self.sample_ratio, self.k = int(sample_ratio), int(kneighbors)
        self.use_xyz, self.normalize = bool(use_xyz), normalize
        if normalize is not None:
            c = channel + (3 if use_xyz else 0)
            self.affine_alpha = nn.Parameter(torch.ones(1, 1, 1, c))
            self.affine_beta = nn.Parameter(torch.zeros(1, 1, 1, c))

    def forward(self, xyz: torch.Tensor, points: torch.Tensor):
        b, n, _ = xyz.shape
        fps_idx = ops.furthest_point_sample(xyz, n // self.sample_ratio)
        new_xyz = ops.index_points(xyz, fps_idx)
        new_points = ops.index_points(points, fps_idx)
        idx = ops.knn_idx(self.k, xyz, new_xyz)
        grouped = ops.index_points(points, idx)  # (B, S, K, C)
        if self.use_xyz:
            grouped = torch.cat([grouped, ops.index_points(xyz, idx)], -1)
        if self.normalize is not None:
            if self.normalize == "center":
                mean = grouped.mean(dim=2, keepdim=True)
            else:  # anchor
                mean = (torch.cat([new_points, new_xyz], -1) if self.use_xyz
                        else new_points)[:, :, None, :]
            diff = grouped - mean
            # one population std a cloud over all its entries (jnp.std)
            std = torch.std(diff.reshape(b, -1), dim=-1, correction=0)
            grouped = diff / (std[:, None, None, None] + 1e-5)
            grouped = self.affine_alpha * grouped + self.affine_beta
        center = new_points[:, :, None, :].expand(-1, -1, self.k, -1)
        return new_xyz, torch.cat([grouped, center], dim=-1)


@MODELS.register_module()
class PointMLPEncoder(nn.Module):
    """parity: pointmlp.py PointMLPEncoder."""

    def __init__(self, in_channels: int = 3, embed_dim: int = 64,
                 res_expansion: float = 1.0, activation: str = "relu",
                 bias: bool = False, use_xyz: bool = False,
                 normalize: str = "anchor",
                 dim_expansion: Sequence[int] = (2, 2, 2, 2),
                 pre_blocks: Sequence[int] = (2, 2, 2, 2),
                 pos_blocks: Sequence[int] = (2, 2, 2, 2),
                 k_neighbors: Sequence[int] = (24, 24, 24, 24),
                 reducers: Sequence[int] = (2, 2, 2, 2)):
        super().__init__()
        self.embedding = _ConvBNAct(in_channels, embed_dim, bias, activation)
        groupers, pre, pos = [], [], []
        last = embed_dim
        for i in range(len(pre_blocks)):
            out = last * dim_expansion[i]
            groupers.append(LocalGrouper(last, reducers[i], k_neighbors[i],
                                         use_xyz, normalize))
            pre.append(_Blocks(out, pre_blocks[i], res_expansion, bias,
                               activation,
                               in_channels=2 * last + (3 if use_xyz else 0)))
            pos.append(_Blocks(out, pos_blocks[i], res_expansion, bias,
                               activation))
            last = out
        self.local_grouper_list = nn.ModuleList(groupers)
        self.pre_blocks_list = nn.ModuleList(pre)
        self.pos_blocks_list = nn.ModuleList(pos)
        self._out_channels = last

    @property
    def out_channels(self) -> int:
        return self._out_channels

    def forward_cls_feat(self, p: torch.Tensor,
                         x: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.embedding(p if x is None else x)
        for grouper, pre, pos in zip(self.local_grouper_list,
                                     self.pre_blocks_list,
                                     self.pos_blocks_list):
            p, x = grouper(p, x)
            x = pos(pre(x).amax(dim=2))  # pool the neighbours
        return x.amax(dim=1)

    def forward(self, p: torch.Tensor,
                x: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.forward_cls_feat(p, x)


@MODELS.register_module()
class PointMLP(BaseCls):
    """The self-contained classifier (parity: pointmlp.py PointMLP): the
    encoder and the original head, Linear-BN-act-Dropout(0.5) at 512 and
    256, then the class projection: a :class:`BaseCls` with that
    ``ClsHead``."""

    def __init__(self, in_channels: int = 3, num_classes: int = 15,
                 embed_dim: int = 64, res_expansion: float = 1.0,
                 activation: str = "relu", bias: bool = False,
                 use_xyz: bool = False, normalize: str = "anchor",
                 dim_expansion: Sequence[int] = (2, 2, 2, 2),
                 pre_blocks: Sequence[int] = (2, 2, 2, 2),
                 pos_blocks: Sequence[int] = (2, 2, 2, 2),
                 k_neighbors: Sequence[int] = (24, 24, 24, 24),
                 reducers: Sequence[int] = (2, 2, 2, 2)):
        super().__init__(
            {"NAME": "PointMLPEncoder", "in_channels": in_channels,
             "embed_dim": embed_dim, "res_expansion": res_expansion,
             "activation": activation, "bias": bias, "use_xyz": use_xyz,
             "normalize": normalize, "dim_expansion": dim_expansion,
             "pre_blocks": pre_blocks, "pos_blocks": pos_blocks,
             "k_neighbors": k_neighbors, "reducers": reducers},
            {"NAME": "ClsHead", "num_classes": num_classes,
             "mlps": [512, 256], "norm_args": {"norm": "bn1d"},
             "act_args": {"act": activation}, "dropout": 0.5})
