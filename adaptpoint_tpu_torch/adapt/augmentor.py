"""AdaptPoint learned augmentor: the deformation and mask controllers.

Counterpart of ``adaptpoint_tpu/adapt/augmentor.py``.

- ``AdaptPoint_Augmentor``: FPS picks M = 4 anchors; ``SAComponent`` predicts
  9 rotation / scale / translation logits per anchor and a 2-class keep/drop
  mask per point; the squashed, range-bounded, randomly axis- and
  dropout-masked local transforms are blended by Gaussian kernel regression,
  normalised into the unit sphere, and the points the mask drops are zeroed.
- ``SAComponent``: ConvBNReLU embedding; four stages of a pointwise
  expansion and a ``PointsetGrouper`` (FPS / 2, ball query at radii 0.1 -
  0.8, k = 24, anchor-normalised affine, max-pool); U-Net feature-propagation
  decode; the deformation head (kNN(24) anchor pooling, anchor
  self-attention, global max) and the mask head (self-attention over all
  points, global feature, 2-logit gumbel-softmax at tau 0.1, hard, straight
  through).

Everything is channels-last. Parameters live in the reference modules
(``Conv1d`` at Sequential slot 0, ``BatchNorm`` at slot 1, ``Linear`` for
``to_qkv``) under the reference names, so a reference ``state_dict`` loads as
it is. Randomness is explicit: the PointWOLF draws (``adapt.common``) and the
gumbel noise are tensors, or come from a ``torch.Generator``.

The grouper takes the JAX package's default route: ``ops.ball_group_max``,
the max-pooled ball group whose values are rounded to bf16 as the TPU kernel
rounds them, and the affine applied to the max or the min over K by the sign
of ``alpha`` (the max over K of a per-channel affine with ``alpha >= 0`` is
the affine of the max, with ``alpha < 0`` of the min), so the (B, K, M, C)
grouped tensor never exists. The JAX package's exact route
(``ADAPTPOINT_TPU_CONTROLLER_EXACT=1``, ball group + affine + max) is a
switch for golden comparisons and is not carried over.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from .. import ops
from ..models.layers.blocks import BatchNorm
from .build import ADAPTMODELS
from .common import WolfDraws, pointwolf_transform

__all__ = ["gumbel_softmax", "ConvBN", "ConvBNReLU", "PointsetGrouper",
           "AnchorSelfAttention", "FeaturePropagationFuse", "ProduceFactor",
           "SAComponent", "AdaptPoint_Augmentor"]


def gumbel_softmax(noise: Union[torch.Tensor, torch.Generator, None],
                   logits: torch.Tensor, tau: float = 1.0, hard: bool = False,
                   dim: int = -1) -> torch.Tensor:
    """Gumbel-softmax with straight-through hard sampling. ``noise`` is the
    gumbel noise itself (``logits``' shape), or the generator to draw it
    from (``None``: the default one of ``logits``' device)."""
    if not isinstance(noise, torch.Tensor):
        tiny = torch.finfo(logits.dtype).tiny
        u = torch.rand(logits.shape, generator=noise, device=logits.device,
                       dtype=logits.dtype).clamp_(min=tiny)
        noise = -torch.log(-torch.log(u))
    y = torch.softmax((logits + noise.to(logits.dtype)) / tau, dim=dim)
    if hard:
        y_hard = F.one_hot(y.argmax(dim=dim), logits.shape[dim]).to(y.dtype)
        if dim not in (-1, logits.dim() - 1):
            y_hard = y_hard.movedim(-1, dim)
        y = (y_hard - y).detach() + y
    return y


class ConvBN(nn.Sequential):
    """Pointwise ``Conv1d`` (slot 0) + ``BatchNorm`` (slot 1) [+ relu] over
    the last axis of a channels-last tensor."""

    def __init__(self, in_channels: int, out_channels: int, bias: bool = True,
                 act: bool = False):
        super().__init__(nn.Conv1d(in_channels, out_channels, 1, bias=bias),
                         BatchNorm(out_channels, eps=1e-5, momentum=0.1))
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x, self[0].weight.flatten(1), self[0].bias)
        y = self[1](y.reshape(-1, y.shape[-1])).reshape(y.shape)
        return F.relu(y) if self.act else y


class ConvBNReLU(nn.Module):
    """Pointwise conv + BN + act, parameters under ``net.0`` / ``net.1``."""

    def __init__(self, in_channels: int, out_channels: int, bias: bool = True,
                 act: bool = True):
        super().__init__()
        self.net = ConvBN(in_channels, out_channels, bias=bias, act=act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class PointsetGrouper(nn.Module):
    """FPS downsample + ball-query grouping with an anchor-normalised affine
    and a max-pool over the K neighbours, through the max-pooled ball group:
    ``where(alpha >= 0, (fmax - fi) alpha, (fmin - fi) alpha) + beta``. Each
    max / min hands its gradient to its first winning neighbour."""

    def __init__(self, channels: int, reduce: int, kneighbors: int,
                 radius: float, input_fps_ordered: bool = False):
        super().__init__()
        self.reduce, self.kneighbors = int(reduce), int(kneighbors)
        self.radius = float(radius)
        # the input is already in FPS selection order (every grouper after
        # the first): its FPS is the identity prefix
        self.input_fps_ordered = input_fps_ordered
        self.affine_alpha = nn.Parameter(torch.ones(1, 1, 1, channels))
        self.affine_beta = nn.Parameter(torch.zeros(1, 1, 1, channels))

    def forward(self, xyz: torch.Tensor, points: torch.Tensor,
                first_fps_idx: Optional[torch.Tensor] = None):
        """xyz (B, N, 3), points (B, N, C) -> (B, N/r, 3), (B, N/r, C).
        ``first_fps_idx`` (B, >= N/r): FPS indices of ``xyz`` computed by
        the caller, whose prefix spares this stage its FPS."""
        npoint = xyz.shape[1] // self.reduce
        if self.input_fps_ordered:
            fps_idx = ops.fps_prefix_idx(xyz.shape[0], npoint, xyz.device)
        elif first_fps_idx is not None and first_fps_idx.shape[1] >= npoint:
            fps_idx = first_fps_idx[:, :npoint]
        else:
            fps_idx = ops.furthest_point_sample(xyz, npoint)
        new_xyz, fi, fmax, fmin = ops.ball_group_max(
            self.radius, self.kneighbors, xyz, fps_idx, points)
        a = self.affine_alpha[0]  # (1, 1, C) over (B, M, C)
        pooled = torch.where(a >= 0, (fmax - fi) * a, (fmin - fi) * a)
        return new_xyz, pooled + self.affine_beta[0]


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Rounded to bf16, held in f32 (exact products, f32 sums downstream)."""
    return x.to(torch.bfloat16).float()


class AnchorSelfAttention(nn.Module):
    """QKV self-attention with a relative-position embedding added to q, k
    and v. Attention over ``m >= 512`` points (``m % 8 == 0``) is the flash
    kernel of ``ops.fused_self_attention``; the tiny anchor attention is
    written out with bf16 operands and an f32 softmax."""

    def __init__(self, dim: int, head_num: int = 4):
        super().__init__()
        self.dim, self.head_num = dim, head_num
        self.to_qkv = nn.Linear(dim, dim * 3, bias=False)
        self.pos_embedding = ConvBN(3, dim, bias=True)
        self.res = ConvBN(dim, dim, bias=True)

    def forward(self, x: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
        b, m, _ = x.shape
        head_dim = self.dim // self.head_num
        rel = xyz - xyz.mean(dim=1, keepdim=True)
        pe = self.pos_embedding(rel)
        q, k, v = self.to_qkv(x).chunk(3, dim=-1)
        q, k, v = q + pe, k + pe, v + pe

        def heads(t):
            return t.reshape(b, m, self.head_num, head_dim).permute(0, 2, 1, 3)

        q, k, v = heads(q), heads(k), heads(v)
        scale = head_dim ** 0.5
        if m >= 512 and m % 8 == 0:
            flat = (b * self.head_num, m, head_dim)
            out = ops.fused_self_attention(
                q.reshape(flat), k.reshape(flat), v.reshape(flat),
                scale).reshape(b, self.head_num, m, head_dim)
        else:
            attn = torch.matmul(_bf16(q), _bf16(k).transpose(-1, -2)) / scale
            attn = torch.softmax(attn, dim=-1)
            out = torch.matmul(_bf16(attn), _bf16(v))
        # the attention's output is f32 whatever the module's type
        out = out.permute(0, 2, 1, 3).reshape(b, m, self.dim).to(x.dtype)
        return self.res(out)


class FeaturePropagationFuse(nn.Module):
    """3-NN interpolation + skip concat + ConvBNReLU fuse."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.fuse = ConvBNReLU(in_channels, out_channels, bias=False)

    def forward(self, xyz1, xyz2, points1, points2):
        interp = ops.three_interpolation(xyz1, xyz2, points2)
        x = interp if points1 is None else torch.cat([points1, interp], -1)
        return self.fuse(x)


class ProduceFactor(nn.Module):
    """Deformation-controller head -> (B, M, 9) R/S/T logits."""

    def __init__(self, kneighbors: int = 24, out_channels: int = 1024):
        super().__init__()
        self.kneighbors = kneighbors
        self.global_layer = ConvBN(3, out_channels, bias=False)
        self.prob_head = ConvBN(out_channels * 2, 9, bias=False)
        self.anchor_selfattention = AnchorSelfAttention(out_channels, 4)

    def forward(self, a_points, sa_x, sa_xyz):
        _, idx = ops.knn_point(self.kneighbors, sa_xyz, a_points)  # (B, M, k)
        local = ops.index_points(sa_x, idx).amax(dim=2)  # (B, M, C)
        local = local + self.anchor_selfattention(local, a_points)
        glob = self.global_layer(a_points).amax(dim=1, keepdim=True)
        feat = torch.cat([local, glob.expand_as(local)], dim=-1)
        return self.prob_head(feat).float()


class SAComponent(nn.Module):
    """Controller backbone: encoder stages, U-Net decode and the two heads."""

    def __init__(self, in_channel: int = 3, embed_dim: int = 64,
                 dim_expansion: Sequence[int] = (2, 2, 2, 2),
                 radii: Sequence[float] = (0.1, 0.2, 0.4, 0.8),
                 k_neighbors: Sequence[int] = (24, 24, 24, 24),
                 reducers: Sequence[int] = (2, 2, 2, 2)):
        super().__init__()
        self.embedding = ConvBNReLU(in_channel, embed_dim, bias=False)
        channels = [embed_dim]
        pre, groupers = [], []
        for i, exp in enumerate(dim_expansion):
            out_ch = channels[-1] * exp
            pre.append(ConvBNReLU(channels[-1], out_ch, bias=False))
            groupers.append(PointsetGrouper(out_ch, reducers[i],
                                            k_neighbors[i], radii[i],
                                            input_fps_ordered=i > 0))
            channels.append(out_ch)
        self.extract_feat_list = nn.ModuleList(pre)
        self.pointset_grouper_list = nn.ModuleList(groupers)
        self.head = ProduceFactor(24, channels[-1])
        self.decode_list = nn.ModuleList([
            FeaturePropagationFuse(channels[-(i + 2)] + channels[-(i + 1)],
                                   channels[-(i + 2)])
            for i in range(len(dim_expansion))])
        self.localfeat_mask_selfattention = AnchorSelfAttention(embed_dim, 4)
        self.extract_local_feat_masking = ConvBN(embed_dim, 3, bias=False)
        self.extract_global_feat_masking = ConvBN(channels[-1], 3, bias=False)
        self.fuse_masking = ConvBN(6, 2, bias=False)

    def forward(self, x: torch.Tensor, a_index: torch.Tensor, gumbel=None,
                first_fps_idx: Optional[torch.Tensor] = None):
        """x (B, N, 3), a_index (B, M) anchor indices -> (prob (B, M, 9),
        masking (B, N, 2)). ``gumbel`` goes to :func:`gumbel_softmax`."""
        a_points = ops.index_points(x, a_index)
        xyz, feat = x, self.embedding(x)
        xyz_list, x_list = [xyz], [feat]
        for i, (pre, grouper) in enumerate(zip(self.extract_feat_list,
                                               self.pointset_grouper_list)):
            xyz, feat = grouper(xyz, pre(feat),
                                first_fps_idx if i == 0 else None)
            xyz_list.append(xyz)
            x_list.append(feat)

        # the deformation head reads the deepest stage, before the decode
        prob = self.head(a_points, feat, xyz)

        for i, decode in enumerate(self.decode_list):  # updates every level
            x_list[-(i + 2)] = decode(xyz_list[-(i + 2)], xyz_list[-(i + 1)],
                                      x_list[-(i + 2)], x_list[-(i + 1)])

        mask_local = self.localfeat_mask_selfattention(x_list[0], xyz_list[0])
        mask_local = self.extract_local_feat_masking(mask_local + x_list[0])
        mask_global = self.extract_global_feat_masking(x_list[-1]).amax(
            dim=1, keepdim=True)  # (B, 1, 3)
        masking = self.fuse_masking(
            torch.cat([mask_local, mask_global.expand_as(mask_local)], -1))
        masking = gumbel_softmax(gumbel, masking.float(), tau=0.1, hard=True)
        return prob, masking


@ADAPTMODELS.register_module()
class AdaptPoint_Augmentor(nn.Module):
    """The imitator. ``forward(xyz, wolf, gumbel)``: ``wolf`` is the
    :class:`~.common.WolfDraws` of the local transforms (axis codes, dropout
    bits, projection axis) or a generator, ``gumbel`` the mask's gumbel noise
    (B, N, 2) or a generator."""

    def __init__(self, w_num_anchor: int = 4, w_sigma: float = 0.5,
                 w_R_range: float = 10.0, w_S_range: float = 3.0,
                 w_T_range: float = 0.25):
        super().__init__()
        self.w_num_anchor = int(w_num_anchor)
        self.w_sigma, self.w_R_range = float(w_sigma), float(w_R_range)
        self.w_S_range, self.w_T_range = float(w_S_range), float(w_T_range)
        self.predict_prob_layer = SAComponent()

    def forward(self, xyz: torch.Tensor,
                wolf: Union[WolfDraws, torch.Generator, None] = None,
                gumbel: Union[torch.Tensor, torch.Generator, None] = None,
                first_fps_idx: Optional[torch.Tensor] = None):
        """xyz (B, N, 3) -> (xyz, xyz_new). ``first_fps_idx`` (B, >= N/2):
        FPS indices of ``xyz`` the caller already has; the anchors and the
        first grouper take its prefixes."""
        if (first_fps_idx is not None
                and first_fps_idx.shape[1] >= self.w_num_anchor):
            fps_idx = first_fps_idx[:, :self.w_num_anchor]
        else:
            fps_idx = ops.furthest_point_sample(xyz, self.w_num_anchor)
        anchors = ops.index_points(xyz, fps_idx)
        probs, masking = self.predict_prob_layer(xyz, fps_idx, gumbel,
                                                 first_fps_idx)
        xyz_new = pointwolf_transform(
            wolf, xyz, anchors, sigma=self.w_sigma, r_range=self.w_R_range,
            s_range=self.w_S_range, t_range=self.w_T_range, probs=probs)
        xyz_new = xyz_new * masking[:, :, 0:1]  # learned point dropout
        return xyz, xyz_new
