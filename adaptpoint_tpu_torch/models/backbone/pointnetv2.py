"""PointNet++ encoder (single-scale grouping), channels-last.

Counterpart of ``adaptpoint_tpu/models/backbone/pointnetv2.py``
``PointNet2SA`` / ``PointNet2Encoder`` (reference openpoints pointnetv2.py):
each stage is FPS + ball query + grouping (``ops.ball_group``: rows 1, 2
and 4), the shared MLP chain and a max-pool over the neighbours; a stage
with ``radius: null`` groups all points. After the first FPS subsample a
stage's input is in FPS selection order, so its FPS is the identity prefix
(``ops.fps_prefix_idx``). Module names follow the reference layout
(``SA_modules.{s}.local_aggregations.0.SA_CONFIG_operator.convs.{j}``).

Not ported yet: the decoders (``PointNet2Decoder``,
``PointNet2PartDecoder``).
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence

import torch
from torch import nn

from ..build import MODELS
from ..layers.blocks import CHANNEL_MAP, ConvBlock
from ..layers.group_layers import create_grouper, get_aggregation_features
from .pointnext import _aggregation_features_kfirst
from ... import ops

__all__ = ["PointNet2SA", "PointNet2Encoder"]


class _Convs(nn.Module):
    """The reference's conv chain holder (``SA_CONFIG_operator.convs``)."""

    def __init__(self, convs: List[nn.Module]):
        super().__init__()
        self.convs = nn.ModuleList(convs)


class _Aggregation(nn.Module):
    """The reference's local aggregation (``SA_CONFIG_operator``)."""

    def __init__(self, convs: List[nn.Module]):
        super().__init__()
        self.SA_CONFIG_operator = _Convs(convs)


class PointNet2SA(nn.Module):
    """One SA stage with an explicit MLP channel chain."""

    def __init__(self, in_channels: int, channels: Sequence[int], stride: int,
                 radius: Optional[float], nsample: Optional[int],
                 group_args: Optional[dict] = None,
                 norm_args: Optional[dict] = None,
                 act_args: Optional[dict] = None,
                 conv_args: Optional[dict] = None,
                 feature_type: str = "dp_fj",
                 input_fps_ordered: bool = False):
        super().__init__()
        self.stride, self.feature_type = int(stride), feature_type
        self.input_fps_ordered = input_fps_ordered
        self.all_aggr = radius is None or nsample is None
        self.group_args = dict(group_args or {"NAME": "ballquery"})
        self.group_args["radius"] = None if self.all_aggr else float(radius)
        self.group_args["nsample"] = None if self.all_aggr else int(nsample)
        order = (conv_args or {}).get("order", "conv-norm-act")
        c_in, convs = CHANNEL_MAP[feature_type](in_channels), []
        for c in channels:
            convs.append(ConvBlock(c_in, c, norm_args or {"norm": "bn"},
                                   act_args or {"act": "relu"},
                                   kind="conv2d", order=order))
            c_in = c
        self.local_aggregations = nn.ModuleList([_Aggregation(convs)])

    @property
    def convs(self) -> nn.ModuleList:
        return self.local_aggregations[0].SA_CONFIG_operator.convs

    def forward(self, p: torch.Tensor, f: torch.Tensor):
        g = self.group_args
        if self.all_aggr:
            new_p = p
        else:
            npoint = max(p.shape[1] // self.stride, 1)
            idx = (ops.fps_prefix_idx(p.shape[0], npoint, p.device)
                   if self.input_fps_ordered
                   else ops.furthest_point_sample(p, npoint))
        if not self.all_aggr and g.get("NAME", "ballquery") == "ballquery":
            # fused center gather + ball query + grouping, neighbour-first
            # (B, K, M, 3 + C): pool over dim 1
            new_p, fi, dpfj, _ = ops.ball_group(
                g["radius"], g["nsample"], p, idx, f,
                relative=g.get("relative_xyz", True),
                normalize_dp=g.get("normalize_dp", False))
            x = _aggregation_features_kfirst(new_p, dpfj, fi,
                                             self.feature_type)
            pool_dim = 1
        else:
            if not self.all_aggr:
                new_p = ops.index_points(p, idx)
            dp, fj = create_grouper(g)(new_p, p, f)
            x = get_aggregation_features(new_p, dp, None, fj,
                                         self.feature_type)
            pool_dim = 2
        for cb in self.convs:
            x = cb(x)
        return new_p, x.amax(dim=pool_dim)


@MODELS.register_module()
class PointNet2Encoder(nn.Module):
    """parity: pointnetv2.py PointNet2Encoder. ``mlps``: a conv chain a
    stage (the classification form ``[[chain]]`` too); a null radius groups
    all points."""

    def __init__(self, in_channels: int = 4, mlps: Any = None,
                 radius: Any = (0.2, 0.4, None),
                 num_samples: Any = (32, 64, None),
                 strides: Sequence[int] = (4, 4, 1),
                 width: Optional[int] = None, layers: int = 3,
                 aggr_args: Optional[dict] = None,
                 group_args: Optional[dict] = None,
                 conv_args: Optional[dict] = None,
                 norm_args: Optional[dict] = None,
                 act_args: Optional[dict] = None, use_res: bool = False,
                 query_as_support: bool = False, sampler: str = "fps"):
        super().__init__()
        strides = list(strides)
        if mlps is not None:
            chains = [list(m[0]) if isinstance(m[0], (list, tuple))
                      else list(m) for m in mlps]
        else:
            chains, w = [], width or 64
            for s in strides:
                chain = [w] * (layers - 1)
                w = w * 2 if s > 1 else w
                chains.append(chain + [w])
        radii = (list(radius) if isinstance(radius, (list, tuple))
                 else [radius] * len(strides))
        nsamples = (list(num_samples)
                    if isinstance(num_samples, (list, tuple))
                    else [num_samples] * len(strides))
        feature_type = dict(aggr_args or {}).get("feature_type", "dp_fj")
        self.channel_list = [c[-1] for c in chains]
        stages, c_in, fps_ordered = [], in_channels, False
        for i, chain in enumerate(chains):
            stages.append(PointNet2SA(
                c_in, chain, strides[i], radii[i], nsamples[i],
                group_args=group_args, norm_args=norm_args,
                act_args=act_args, conv_args=conv_args,
                feature_type=feature_type, input_fps_ordered=fps_ordered))
            if (radii[i] is not None and nsamples[i] is not None
                    and sampler == "fps"):
                fps_ordered = True
            c_in = chain[-1]
        self.SA_modules = nn.ModuleList(stages)

    @property
    def out_channels(self) -> int:
        return self.channel_list[-1]

    def forward_seg_feat(self, p0: torch.Tensor,
                         f0: Optional[torch.Tensor] = None):
        p, f = p0, (p0 if f0 is None else f0)
        ps, fs = [p], [f]
        for sa in self.SA_modules:
            p, f = sa(p, f)
            ps.append(p)
            fs.append(f)
        return ps, fs

    def forward_cls_feat(self, p0: torch.Tensor,
                         f0: Optional[torch.Tensor] = None) -> torch.Tensor:
        _, fs = self.forward_seg_feat(p0, f0)
        f = fs[-1]
        return f.squeeze(1) if f.shape[1] == 1 else f.amax(dim=1)

    def forward(self, p0: torch.Tensor, f0: Optional[torch.Tensor] = None):
        return self.forward_seg_feat(p0, f0)
