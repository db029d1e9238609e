"""PointNeXt encoder, channels-last.

Counterpart of ``adaptpoint_tpu/models/backbone/pointnext.py`` for the
stages PointNeXt-S instantiates: the stem, the strided SetAbstraction
stages (ball-group route or fused route, differentiable under autograd as
the GAN step's fake pass needs it) and the group-all stage.
``InvResMLP`` depth blocks (``blocks[i] > 1``) wait for the PointNeXt-B
slice and raise. Module names follow the reference openpoints layout
(``encoder.{stage}.{block}.convs.{j}.{0|1}``, ``skipconv.0``).

Under the bf16 compute policy (``utils.precision``) the convs and their
BatchNorms give bf16, the skip conv computes in f32 from its input (bf16 or
f32), and a stage's residual sum is f32; the fused kernels take bf16
features as the f32 that holds them, and the unfused route's ball group
gives a bf16 ``dpfj``, as the JAX package's stages do.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence

import torch
from torch import nn

from ..build import MODELS
from ..layers.blocks import CHANNEL_MAP, ConvBlock, create_act, norm_kind
from ..layers.group_layers import create_grouper, get_aggregation_features
from ... import ops

__all__ = ["SetAbstraction", "PointNextEncoder"]


def _aggregation_features_kfirst(p, dpfj, fi, feature_type):
    """get_aggregation_features for the (B, K, M, 3+C) neighbor-first layout
    of ``ops.ball_group`` (pool over dim 1 downstream)."""
    if feature_type == "dp_fj":
        return dpfj
    dp, fj = dpfj[..., :3], dpfj[..., 3:]
    df = fj - fi[:, None, :, :]
    if feature_type in ("dp_fj_df", "dp_fi_df"):
        return torch.cat([dpfj, df], dim=-1)
    if feature_type == "pi_dp_fj_df":
        pi = p[:, None, :, :].expand_as(dp)
        return torch.cat([pi, dpfj, df], dim=-1)
    if feature_type == "dp_df":
        return torch.cat([dp, df], dim=-1)
    raise ValueError(feature_type)


class SetAbstraction(nn.Module):
    """SA block: FPS downsample + grouped shared-MLP + max-pool (+ residual).

    (parity: pointnext.py SetAbstraction)
    """

    def __init__(self, in_channels: int, out_channels: int, layers: int = 1,
                 stride: int = 1, group_args: Optional[dict] = None,
                 norm_args: Optional[dict] = None,
                 act_args: Optional[dict] = None,
                 conv_args: Optional[dict] = None, sampler: str = "fps",
                 feature_type: str = "dp_fj", use_res: bool = False,
                 is_head: bool = False, input_fps_ordered: bool = False):
        super().__init__()
        self.stride = stride
        self.is_head = is_head
        self.sampler = sampler
        self.feature_type = feature_type
        self.input_fps_ordered = input_fps_ordered
        self.group_args = dict(group_args or {})
        self.norm_args = norm_args
        self.act_args = act_args
        self.order = (conv_args or {}).get("order", "conv-norm-act")
        self.all_aggr = (not is_head) and stride == 1
        self.use_res = use_res and not self.all_aggr and not is_head
        self.layers = layers

        mid = out_channels // 2 if stride > 1 else out_channels
        channels = [in_channels] + [mid] * (layers - 1) + [out_channels]
        if not is_head:
            channels[0] = CHANNEL_MAP[feature_type](channels[0])
        if is_head:
            # stem: plain pointwise conv, no norm/act (pointnext.py:119-127)
            convs = [ConvBlock(channels[i], channels[i + 1], kind="conv1d",
                               order=self.order)
                     for i in range(len(channels) - 1)]
        else:
            convs = []
            for i in range(len(channels) - 1):
                last = i == len(channels) - 2
                convs.append(ConvBlock(
                    channels[i], channels[i + 1], norm_args=norm_args,
                    act_args=None if (last and self.use_res) else act_args,
                    kind="conv2d", order=self.order))
        # skipconv registers first: the reference state_dict lists it first
        self.skipconv = None
        if self.use_res and in_channels != channels[-1]:
            # a flax Dense without a dtype in the JAX package: f32 under
            # the bf16 policy too
            self.skipconv = ConvBlock(in_channels, channels[-1],
                                      kind="conv1d", policy=False)
        self.convs = nn.ModuleList(convs)
        self.act = create_act(act_args)
        self._fused_cache = None  # see _fused_weights
        self.use_fused = (not self.all_aggr and not is_head and
                          self.group_args.get("NAME", "ballquery")
                          == "ballquery")

    def _sample_idx(self, p: torch.Tensor, npoint: int,
                    first_fps_idx: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
        if self.input_fps_ordered and self.sampler == "fps":
            return ops.fps_prefix_idx(p.shape[0], npoint, p.device)
        if (first_fps_idx is not None and self.sampler == "fps"
                and first_fps_idx.shape[0] == p.shape[0]
                and first_fps_idx.shape[1] >= npoint):
            # FPS is greedy: a longer FPS of the same cloud holds this one
            # as its prefix
            return first_fps_idx[:, :npoint]
        return ops.furthest_point_sample(p, npoint)

    def _fused_eval_ok(self) -> bool:
        """The fused kernels cover eval forwards of the standard stage: two
        convs, conv-norm-act with BN, relu, dp_fj features (the gate of both
        fused routes, as ``_fused_eval_ok`` is in the JAX package)."""
        return (not self.training and self.layers == 2
                and self.feature_type == "dp_fj"
                and self.order == "conv-norm-act"
                and norm_kind(self.norm_args) == "bn"
                and (self.act_args or {}).get("act") == "relu")

    def folded_convs(self):
        """Eval BN folded into each conv, in f32 (pointnext.py:285-303):
        ``s = gamma / sqrt(var + eps)``, ``w * s``, ``beta - mean * s``.
        Returns ``[(w (in, out), b (out,)), ...]``."""
        out = []
        for cb in self.convs:
            bn = cb.bn
            s = bn.weight / torch.sqrt(bn.running_var + bn.eps)
            out.append((cb.weight_matrix().t() * s[None, :],
                        bn.bias - bn.running_mean * s))
        return out

    def _fused_weights(self, device: torch.device):
        """Folded weights (and on CUDA their kernel packing), recomputed only
        when a conv or BN tensor changed: the key holds each tensor's storage
        and version counter, which ``load_state_dict``, ``.to()`` and
        in-place updates all move. Where the stage's parameters take a
        gradient, the weights are folded on the graph each call instead."""
        tensors = [t for cb in self.convs for t in (
            cb.conv.weight, cb.bn.weight, cb.bn.bias, cb.bn.running_mean,
            cb.bn.running_var)]
        if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
            (w1, b1), (w2, b2) = self.folded_convs()
            return (w1, b1, w2, b2), None
        key = tuple((t.data_ptr(), t._version) for t in tensors)
        if self._fused_cache is None or self._fused_cache[0] != key:
            with torch.no_grad():
                (w1, b1), (w2, b2) = self.folded_convs()
                packed = (ops.saeval.pack_weights(w1, b1, w2, b2)
                          if device.type == "cuda" else None)
            self._fused_cache = (key, (w1, b1, w2, b2), packed)
        return self._fused_cache[1], self._fused_cache[2]

    def _radius_nsample(self):
        return (float(self.group_args.get("radius", 0.1)),
                int(self.group_args.get("nsample", 16)))

    def _fused_stage(self, p, f, first_fps_idx=None):
        """The stage through the fused kernel: ``ops.sa_train`` where
        autograd asks for a gradient of the cloud, the features or the folded
        weights (the eval kernel has no backward), ``ops.sa_eval`` otherwise.
        The residual's skip conv and activation stay outside it."""
        radius, nsample = self._radius_nsample()
        idx = self._sample_idx(p, p.shape[1] // self.stride, first_fps_idx)
        (w1, b1, w2, b2), packed = self._fused_weights(p.device)
        differentiable = torch.is_grad_enabled() and any(
            t.requires_grad for t in (p, f, w1, b1, w2, b2))
        op = ops.sa_train if differentiable else ops.sa_eval
        new_p, fi, out = op(
            radius, nsample, p, idx, f, w1, b1, w2, b2,
            relative=self.group_args.get("relative_xyz", True),
            normalize_dp=self.group_args.get("normalize_dp", False),
            packed=packed)
        if self.use_res:
            identity = self.skipconv(fi) if self.skipconv is not None else fi
            return new_p, self.act(out + identity)
        # relu(max(x)) == max(relu(x)): relu is monotone
        return new_p, self.act(out)

    def forward(self, p: torch.Tensor, f: torch.Tensor,
                fused_eval: bool = False,
                first_fps_idx: Optional[torch.Tensor] = None):
        """``first_fps_idx`` (B, >= M): FPS indices of ``p`` the caller
        already has; a stage that would run FPS on ``p`` takes its prefix.
        ``fused_eval`` asks for the fused route where the stage's form allows
        it, differentiable where autograd needs it (``_fused_stage``)."""
        if self.is_head:
            x = f
            for cb in self.convs:
                x = cb(x)
            return p, x
        if self.use_fused and fused_eval and self._fused_eval_ok():
            return self._fused_stage(p, f, first_fps_idx)
        if self.use_fused:
            radius, nsample = self._radius_nsample()
            idx = self._sample_idx(p, p.shape[1] // self.stride,
                                   first_fps_idx)
            new_p, fi, dpfj, _ = ops.ball_group(
                radius, nsample, p, idx, f,
                relative=self.group_args.get("relative_xyz", True),
                normalize_dp=self.group_args.get("normalize_dp", False))
            x = _aggregation_features_kfirst(new_p, dpfj, fi,
                                             self.feature_type)
            pool_dim = 1
        else:
            group_args = dict(self.group_args)
            if self.all_aggr:
                idx, new_p = None, p
                group_args["nsample"] = None
                group_args["radius"] = None
            else:
                idx = self._sample_idx(p, p.shape[1] // self.stride,
                                       first_fps_idx)
                new_p = ops.index_points(p, idx)
            fi = None
            if self.use_res or "df" in self.feature_type:
                fi = ops.index_points(f, idx) if idx is not None else f
            dp, fj = create_grouper(group_args)(new_p, p, f)
            x = get_aggregation_features(new_p, dp, fi, fj, self.feature_type)
            pool_dim = 2
        if self.use_res:
            identity = self.skipconv(fi) if self.skipconv is not None else fi
        for cb in self.convs:
            x = cb(x)
        x = x.amax(dim=pool_dim)  # pool over neighbors
        if self.use_res:
            x = self.act(x + identity)
        return new_p, x


def _to_full_list(param, blocks, strides, param_scaling=1):
    """Per-stage/per-block radius & nsample expansion
    (parity: pointnext.py _to_full_list)."""
    param_list = []
    if isinstance(param, (list, tuple)):
        for i, value in enumerate(param):
            value = list(value) if isinstance(value, (list, tuple)) else [value]
            if len(value) != blocks[i]:
                value += [value[-1]] * (blocks[i] - len(value))
            param_list.append(value)
    else:
        for i, stride in enumerate(strides):
            if stride == 1:
                param_list.append([param] * blocks[i])
            else:
                param_list.append([param] + [param * param_scaling]
                                  * (blocks[i] - 1))
                param *= param_scaling
    return param_list


@MODELS.register_module()
class PointNextEncoder(nn.Module):
    """PointNeXt encoder (parity: pointnext.py PointNextEncoder)."""

    def __init__(self, in_channels: int = 4, width: int = 32,
                 blocks: Sequence[int] = (1, 4, 7, 4, 4),
                 strides: Sequence[int] = (4, 4, 4, 4),
                 block: str = "InvResMLP", nsample: Any = 32,
                 radius: Any = 0.1, aggr_args: Optional[dict] = None,
                 group_args: Optional[dict] = None,
                 norm_args: Optional[dict] = None,
                 act_args: Optional[dict] = None,
                 conv_args: Optional[dict] = None, sa_layers: int = 1,
                 sa_use_res: bool = False, expansion: int = 4,
                 sampler: str = "fps", use_res: bool = True,
                 radius_scaling: float = 2.0, nsample_scaling: float = 1.0):
        super().__init__()
        if block != "InvResMLP":
            raise ValueError(f"unsupported block {block}")
        if any(b > 1 for b in blocks):
            raise NotImplementedError(
                "InvResMLP depth blocks (blocks > 1) are not ported yet")
        self.blocks, self.strides = list(blocks), list(strides)
        aggr_args = dict(aggr_args or {"feature_type": "dp_fj",
                                       "reduction": "max"})
        norm_args = norm_args or {"norm": "bn"}
        act_args = act_args or {"act": "relu"}
        radii = _to_full_list(radius, blocks, strides, radius_scaling)
        nsamples = _to_full_list(nsample, blocks, strides, nsample_scaling)
        self.channel_list = self._channel_list(width, strides)

        stages = []
        in_ch = in_channels
        fps_ordered = False  # True after the first FPS subsample
        for i in range(len(blocks)):
            is_head = i == 0 and strides[i] == 1
            g = dict(group_args or {"NAME": "ballquery"})
            g["radius"] = radii[i][0]
            g["nsample"] = nsamples[i][0]
            stages.append(nn.ModuleList([SetAbstraction(
                in_ch, self.channel_list[i],
                layers=sa_layers if not is_head else 1, stride=strides[i],
                group_args=g, norm_args=norm_args, act_args=act_args,
                conv_args=conv_args, sampler=sampler,
                feature_type=aggr_args.get("feature_type", "dp_fj"),
                use_res=sa_use_res, is_head=is_head,
                input_fps_ordered=fps_ordered)]))
            if strides[i] > 1 and not is_head and sampler == "fps":
                fps_ordered = True
            in_ch = self.channel_list[i]
        self.encoder = nn.ModuleList(stages)

    @staticmethod
    def _channel_list(width: int, strides) -> List[int]:
        channels = []
        for stride in strides:
            if stride != 1:
                width *= 2
            channels.append(width)
        return channels

    @property
    def out_channels(self) -> int:
        return self.channel_list[-1]

    def forward_seg_feat(self, p0, f0=None, fused_eval: bool = False,
                         first_fps_idx: Optional[torch.Tensor] = None):
        """``first_fps_idx``: FPS indices of ``p0`` computed by the caller;
        the first subsampling stage takes its prefix instead of running FPS
        (the stages after it are in FPS order anyway)."""
        p, f = p0, (p0 if f0 is None else f0)
        ps, fs = [p], [f]
        for stage in self.encoder:
            for blk in stage:
                # only a stage that still sees the input cloud may use it
                shared = first_fps_idx if p is p0 else None
                p, f = blk(p, f, fused_eval, shared)
            ps.append(p)
            fs.append(f)
        return ps, fs

    def forward_cls_feat(self, p0, f0=None, fused_eval: bool = False,
                         first_fps_idx: Optional[torch.Tensor] = None):
        ps, fs = self.forward_seg_feat(p0, f0, fused_eval, first_fps_idx)
        f = fs[-1]
        # the group-all stage pools to (B, 1, C) (pointnext.py:441)
        return f.squeeze(1) if f.shape[1] == 1 else f.amax(dim=1)

    def forward(self, p0, f0=None, fused_eval: bool = False,
                first_fps_idx: Optional[torch.Tensor] = None):
        return self.forward_seg_feat(p0, f0, fused_eval, first_fps_idx)
