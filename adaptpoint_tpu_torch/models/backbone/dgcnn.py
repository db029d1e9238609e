"""DGCNN (dynamic graph CNN, EdgeConv) and BallDGCNN, channels-last.

Counterpart of ``adaptpoint_tpu/models/backbone/dgcnn.py`` (reference
openpoints dgcnn.py, graph_conv.py EdgeConv, ball_dgcnn.py). A static
EdgeConv head on the kNN graph of xyz, then ``n_blocks - 2`` EdgeConvs whose
kNN graphs are recomputed in feature space, the concat of every block's
output, a bias-free fusion conv and the max || mean global feature
(``out_channels = 2 * embed_dim``). ``BallDGCNN`` takes its edges from a
ball query on xyz for every block and orders its convs conv-act-norm. The
segmentation form (``is_seg``, ``forward_seg_feat``) waits with the
segmentation decoders (ROADMAP A.7).

The graphs are the kNN kernel's indices (``ops.knn_idx``: row 11, the tiled
instance at the feature-space widths), the edges the row gather (row 14, its
scatter-add row 15 in the backward). Module names follow the reference
layout (``head.gconv.nn``, ``backbone.{i}.gconv.nn``, ``fusion_block``), so
a reference ``.pth`` loads as it is.

A kNN graph is a discrete choice: two runs whose features differ in the last
bits can pick other neighbours at near-ties. :func:`graph_tape` records the
graphs a forward takes, or hands recorded ones back, so that a comparison
can hold two runs on one graph; the main path never enters it.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional

import torch
from torch import nn

from ..build import MODELS
from ..layers.blocks import ConvBlock
from ... import ops

__all__ = ["EdgeConv", "DynConv", "DGCNN", "BallDGCNN", "GraphTape",
           "graph_tape"]


class GraphTape:
    """The kNN graphs of DGCNN forwards in call order: appended to while
    recording, read back in order (cycling) while replaying."""

    def __init__(self, graphs: Optional[List[torch.Tensor]] = None):
        self.graphs = list(graphs) if graphs is not None else []
        self.replay = graphs is not None
        self.pos = 0

    def take(self, compute):
        if not self.replay:
            idx = compute()
            self.graphs.append(idx)
            return idx
        idx = self.graphs[self.pos % len(self.graphs)]
        self.pos += 1
        return idx


@contextlib.contextmanager
def graph_tape(model: nn.Module, graphs: Optional[List[torch.Tensor]] = None):
    """Inside, every DGCNN of ``model`` records its kNN graphs on the tape
    it yields (``graphs`` None) or takes them from ``graphs`` in call order
    instead of computing them. For comparisons that must share the graph
    (the CPU tests against the JAX package, ``chip_smoke.py``'s kernels
    against the plain versions); nothing of the port enters it."""
    tape = GraphTape(graphs)
    nets = [m for m in model.modules() if isinstance(m, DGCNN)]
    for m in nets:
        m.tape = tape
    try:
        yield tape
    finally:
        for m in nets:
            m.tape = None


class EdgeConv(nn.Module):
    """``max_K MLP([x_i, x_j - x_i])`` (parity: graph_conv.py EdgeConv)."""

    def __init__(self, in_channels: int, out_channels: int,
                 norm_args: Optional[dict], act_args: Optional[dict],
                 order: str):
        super().__init__()
        self.nn = ConvBlock(2 * in_channels, out_channels, norm_args,
                            act_args, kind="conv2d", order=order)

    def forward(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        xj = ops.index_points(x, idx)  # (B, N, K, C)
        xi = x[:, :, None, :].expand_as(xj)
        return self.nn(torch.cat([xi, xj - xi], dim=-1)).amax(dim=2)


class DynConv(nn.Module):
    """The reference's graph-conv wrapper: holds the EdgeConv as ``gconv``."""

    def __init__(self, *args):
        super().__init__()
        self.gconv = EdgeConv(*args)

    def forward(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        return self.gconv(x, idx)


@MODELS.register_module()
class DGCNN(nn.Module):
    """parity: dgcnn.py DGCNN (channels 64, embed 1024, 5 blocks, k = 20,
    leakyrelu 0.2, BatchNorm, conv-norm-act by default). ``graph='ball'``
    is the BallDGCNN variant."""

    def __init__(self, in_channels: int = 3, channels: int = 64,
                 embed_dim: int = 1024, n_blocks: int = 5, k: int = 20,
                 graph: str = "knn", radius: float = 0.15,
                 norm_args: Optional[dict] = None,
                 act_args: Optional[dict] = None,
                 conv_args: Optional[dict] = None):
        super().__init__()
        if graph not in ("knn", "ball"):
            raise ValueError(f"unknown DGCNN graph {graph}")
        self.k, self.graph, self.radius = int(k), graph, float(radius)
        self.embed_dim = int(embed_dim)
        norm_args = norm_args or {"norm": "bn"}
        act_args = act_args or {"act": "leakyrelu", "negative_slope": 0.2}
        # the reference BallDGCNN defaults to conv-act-norm, DGCNN to
        # conv-norm-act
        conv_args = conv_args or ({"order": "conv-act-norm"}
                                  if graph == "ball" else None)
        order = (conv_args or {}).get("order", "conv-norm-act")
        self.head = DynConv(in_channels, channels, norm_args, act_args, order)
        blocks, ch, fused = [], channels, channels
        c_in = channels
        for _ in range(n_blocks - 2):
            blocks.append(DynConv(c_in, ch, norm_args, act_args, order))
            fused += ch
            c_in, ch = ch, ch * 2
        self.backbone = nn.ModuleList(blocks)
        self.fusion_block = ConvBlock(fused, self.embed_dim, norm_args,
                                      act_args, kind="conv1d", order=order,
                                      bias=False)
        self.tape: Optional[GraphTape] = None  # see graph_tape

    @property
    def out_channels(self) -> int:
        return 2 * self.embed_dim  # the max || mean global feature

    def _knn(self, x: torch.Tensor) -> torch.Tensor:
        if self.tape is None:
            return ops.knn_idx(self.k, x, x)
        return self.tape.take(lambda: ops.knn_idx(self.k, x, x))

    def _backbone(self, pos: torch.Tensor,
                  features: Optional[torch.Tensor]) -> torch.Tensor:
        if features is None:
            features = pos
        # the ball variant's xyz graph serves every block (ball_dgcnn.py)
        ball = (ops.ball_query(self.radius, self.k, pos, pos)
                if self.graph == "ball" else None)
        feats = [self.head(features, ball if ball is not None
                           else self._knn(pos))]
        for blk in self.backbone:
            # the graph recomputed in feature space (graph_conv.py DynConv)
            feats.append(blk(feats[-1], ball if ball is not None
                             else self._knn(feats[-1])))
        return self.fusion_block(torch.cat(feats, dim=-1))  # (B, N, embed)

    def forward_cls_feat(self, pos: torch.Tensor,
                         features: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
        fusion = self._backbone(pos, features)
        return torch.cat([fusion.amax(dim=1), fusion.mean(dim=1)], dim=-1)

    def forward(self, pos: torch.Tensor,
                features: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self._backbone(pos, features)


@MODELS.register_module()
class BallDGCNN(DGCNN):
    """DGCNN whose edges come from a ball query on xyz (radius 0.1 by
    default) for every block (parity: ball_dgcnn.py BallDGCNN)."""

    def __init__(self, in_channels: int = 3, channels: int = 64,
                 embed_dim: int = 1024, n_blocks: int = 5, k: int = 20,
                 graph: str = "ball", radius: float = 0.1,
                 norm_args: Optional[dict] = None,
                 act_args: Optional[dict] = None,
                 conv_args: Optional[dict] = None):
        super().__init__(in_channels, channels, embed_dim, n_blocks, k, graph,
                         radius, norm_args, act_args, conv_args)
