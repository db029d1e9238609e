"""PointViT and its family: a vision transformer over point patches,
channels-last.

Counterpart of ``adaptpoint_tpu/models/backbone/pointvit.py`` (reference
openpoints pointvit.py, layers/group_embed.py, layers/attention.py,
layers/kmeans.py, graphvit3d.py):

- :class:`PointPatchEmbed`: FPS group centers (row 1), kNN neighbours from
  the kNN kernel's indices alone (row 11; or a ball query), every gather
  through ``ops.index_points`` (row 14), a two-half shared MLP whose first
  half's K-pooled code is concatenated before the per-neighbour features,
  and a max over each group. Its norms: ``in2d`` (per sample and channel
  over (G, K), biased variance, no parameters), ``bn`` (flax BatchNorm,
  momentum 0.9) or ``ln``.
- :class:`Attention` / :class:`TransformerBlock`: timm's packed-qkv
  attention in plain PyTorch ops (the JAX package computes it outside any
  TPU kernel; row 9's kernel is another function, with P rounded to bf16),
  softmax in f32, pre-norm blocks with LayerNorm eps 1e-6 and flax's tanh
  GELU.
- :class:`PointViT`: cls (and distillation) tokens, a positional MLP on the
  centers added to the input of every block, a final LayerNorm, the
  ``global_feat`` read-outs and ``forward_seg_feat``.
- :class:`PointViTDecoder`, :class:`PointViTPartDecoder`: feature
  propagation from the patch centers back to the cloud through
  ``ops.three_interpolation``; :class:`KMeansEmbed`, :class:`ViTGraph` and
  :class:`P3Embed`.

Module names of :class:`PointViT` follow the reference layout
(``patch_embed.conv{1,2}.{j}.0``, ``pos_embed.0.0`` / ``pos_embed.1``,
``blocks.{i}.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,mlp.fc2}``, ``norm``),
so a reference ``.pth`` loads as it is. The others, which have no
reference layout in the repository, are named after the JAX modules.

Dropout (``drop_rate > 0``) takes its keep-masks as tensors or draws them
from a ``torch.Generator``, as ``ClsHead`` does: one mask for each block's
attention matrix and one for its projection, in block order.

Initialisation follows the JAX package's distributions: xavier-uniform
weights and zero biases for ``qkv``, ``proj``, ``fc1`` and ``fc2``,
normal(0.02) tokens, PyTorch's default (U(+-1/sqrt(fan_in))) elsewhere;
``models.build.init_weights_`` re-draws them so from its generator.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..build import MODELS
from ..layers.blocks import (CHANNEL_MAP, BatchNorm, ConvBlock, Dropout,
                             create_act)
from ..layers.kmeans import kmeans
from ... import ops

__all__ = ["Attention", "TransformerBlock", "PointPatchEmbed", "PointViT",
           "PointViTDecoder", "PointViTPartDecoder", "KMeansEmbed",
           "ViTGraph", "P3Embed"]


def _xavier_(linear: nn.Linear, generator: Optional[torch.Generator]):
    with torch.no_grad():
        nn.init.xavier_uniform_(linear.weight, generator=generator)
        if linear.bias is not None:
            linear.bias.zero_()


def _tokens_(params, generator: Optional[torch.Generator]):
    with torch.no_grad():
        for p in params:
            p.normal_(0.0, 0.02, generator=generator)


class Attention(nn.Module):
    """timm-style packed-qkv attention (parity: openpoints layers/
    attention.py Attention): one ``qkv`` Linear (bias only with
    ``qkv_bias``), softmax(q k^T * hd^-0.5) v over ``dim // num_heads`` head
    channels in f32, and a ``proj`` Linear with a bias."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = False,
                 drop: float = 0.0):
        super().__init__()
        self.num_heads = int(num_heads)
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.attn_drop = Dropout(drop)
        self.proj_drop = Dropout(drop)
        self.seeded_init_(None)

    def seeded_init_(self, generator: Optional[torch.Generator]) -> None:
        _xavier_(self.qkv, generator)
        _xavier_(self.proj, generator)

    def forward(self, x: torch.Tensor, masks=(None, None),
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, n, c = x.shape
        hd = c // self.num_heads
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # (B, N, H, hd)
        attn = torch.einsum("bnhd,bmhd->bhnm", q, k) * (hd ** -0.5)
        attn = torch.softmax(attn.float(), dim=-1)
        attn = self.attn_drop(attn, masks[0], generator)
        out = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(b, n, c)
        return self.proj_drop(self.proj(out), masks[1], generator)


class Mlp(nn.Module):
    """fc1, GELU (flax's tanh form), fc2; no dropout (the JAX package's
    block has none)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.act = create_act({"act": "gelu"})
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class TransformerBlock(nn.Module):
    """Pre-norm MHSA + MLP block (parity: layers/attention.py Block),
    LayerNorms with eps 1e-6."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, drop: float = 0.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, qkv_bias, drop)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.seeded_init_(None)

    def seeded_init_(self, generator: Optional[torch.Generator]) -> None:
        # its Attention draws its own
        _xavier_(self.mlp.fc1, generator)
        _xavier_(self.mlp.fc2, generator)

    def forward(self, x: torch.Tensor, masks=(None, None),
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), masks, generator)
        return x + self.mlp(self.norm2(x))


def _block_masks(dropout_mask, depth: int):
    """Per-block ``(attention, projection)`` keep-masks from a flat list of
    ``2 * depth`` (None: drawn from the generator)."""
    if dropout_mask is None:
        return [(None, None)] * depth
    masks = list(dropout_mask)
    if len(masks) != 2 * depth:
        raise ValueError(f"{2 * depth} dropout masks expected (attention "
                         f"and projection of each block), got {len(masks)}")
    return [(masks[2 * i], masks[2 * i + 1]) for i in range(depth)]


class InstanceNormGK(nn.Module):
    """``in2d`` of the patch embed: torch InstanceNorm2d with its default
    ``affine=False`` over the (G, K) axes of a (B, G, K, C) tensor, biased
    variance, eps 1e-5; no parameters."""

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        var, mu = torch.var_mean(h, dim=(1, 2), keepdim=True, correction=0)
        return (h - mu) * torch.rsqrt(var + 1e-5)


class EmbedConv(nn.Sequential):
    """One patch-embed conv: ``Conv2d`` 1x1 at slot 0 (reference
    create_convblock2d), then its norm and act, or bare with a bias where
    ``norm`` is None (each half's last conv). Applied channels-last in
    f32."""

    def __init__(self, in_channels: int, out_channels: int,
                 norm: Optional[str], act: Optional[str]):
        layers = [nn.Conv2d(in_channels, out_channels, 1, bias=norm is None)]
        if norm is not None:
            if norm.startswith("in"):
                layers.append(InstanceNormGK())
            elif norm.startswith("bn"):
                layers.append(BatchNorm(out_channels, eps=1e-5, momentum=0.1))
            elif norm.startswith("ln"):
                layers.append(nn.LayerNorm(out_channels, eps=1e-5))
            else:
                raise ValueError(f"unknown embed norm {norm}")
            layers.append(create_act({"act": act}))
        super().__init__(*layers)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        conv = self[0]
        h = F.linear(h, conv.weight.flatten(1), conv.bias)
        for mod in list(self)[1:]:
            if isinstance(mod, BatchNorm):
                h = mod(h.reshape(-1, h.shape[-1])).reshape(h.shape)
            else:
                h = mod(h)
        return h


# a MODELS entry as in the reference (group_embed.py:58) and the JAX package
@MODELS.register_module()
class PointPatchEmbed(nn.Module):
    """Sample centers + group + two-stage shared-MLP patch embedding (parity:
    group_embed.py PointPatchEmbed). ``num_groups = 0`` takes
    ``int(N * sample_ratio)`` groups. ``forward(p, x)`` -> ``(centers
    (B, G, 3), tokens (B, G, embed_dim))``."""

    def __init__(self, num_groups: int = 256, group_size: int = 32,
                 embed_dim: int = 384, in_channels: int = 3, layers: int = 4,
                 sample_ratio: float = 0.0625, feature_type: str = "fj",
                 norm: str = "in2d", act: str = "relu", group: str = "knn",
                 relative_xyz: bool = True, normalize_dp: bool = False,
                 radius: float = 0.1):
        super().__init__()
        self.num_groups, self.group_size = int(num_groups), int(group_size)
        self.sample_ratio, self.feature_type = sample_ratio, feature_type
        self.group, self.radius = group, float(radius)
        self.relative_xyz, self.normalize_dp = relative_xyz, normalize_dp
        e, L = int(embed_dim), int(layers)
        channels = ([CHANNEL_MAP[feature_type](in_channels)]
                    + [e] * (L // 2) + [e * 2] * (L // 2 - 1) + [e])
        self.conv1 = nn.Sequential(*(
            EmbedConv(channels[i], channels[i + 1],
                      None if i == L // 2 - 1 else norm, act)
            for i in range(L // 2)))
        # conv2's input is the doubled concat of the pooled code and h
        self.conv2 = nn.Sequential(*(
            EmbedConv(channels[i] * (2 if i == L // 2 else 1),
                      channels[i + 1], None if i == L - 1 else norm, act)
            for i in range(L // 2, L)))

    def forward(self, p: torch.Tensor, x: torch.Tensor):
        g = self.num_groups or int(p.shape[1] * self.sample_ratio)
        idx = ops.furthest_point_sample(p, g)
        centers = ops.index_points(p, idx)
        if "knn" in self.group:
            nidx = ops.knn_idx(self.group_size, p, centers)
        else:
            nidx = ops.ball_query(self.radius, self.group_size, p, centers)
        fj = ops.index_points(x, nidx)  # (B, G, K, C)
        ft = self.feature_type
        if ft in ("dp", "dp_fj", "dp_df"):
            dp = ops.index_points(p, nidx)
            if self.relative_xyz:
                dp = dp - centers[:, :, None, :]
                if self.normalize_dp:
                    dp = dp / self.radius
            if ft == "dp":
                h = dp
            elif ft == "dp_fj":
                h = torch.cat([dp, fj], dim=-1)
            else:
                cx = ops.index_points(x, idx)[:, :, None, :]
                h = torch.cat([dp, fj - cx], dim=-1)
        elif ft == "df":
            h = fj - ops.index_points(x, idx)[:, :, None, :]
        else:  # fj
            h = fj
        h = self.conv1(h)
        pooled = h.amax(dim=2, keepdim=True)
        h = torch.cat([pooled.expand_as(h), h], dim=-1)
        h = self.conv2(h)
        return centers, h.amax(dim=2)  # (B, G, embed_dim)


def _pos_mlp(dim: int) -> nn.Sequential:
    """Linear(3, 128), GELU, Linear(128, dim): reference ``pos_embed``
    (``create_linearblock`` at slot 0, so its Linear is ``0.0``)."""
    return nn.Sequential(nn.Sequential(nn.Linear(3, 128),
                                       create_act({"act": "gelu"})),
                         nn.Linear(128, dim))


@MODELS.register_module()
class PointViT(nn.Module):
    """parity: pointvit.py PointViT. ``distill=True`` adds a distillation
    token at position 1; ``forward_cls_feat`` then returns ``(global_feat,
    dist_token_feat)`` in training."""

    takes_dropout = True

    def __init__(self, in_channels: int = 3, embed_dim: int = 384,
                 depth: int = 12, num_heads: int = 6, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, drop_rate: float = 0.0,
                 num_groups: int = 256, group_size: int = 32,
                 global_feat: str = "cls,max", distill: bool = False):
        super().__init__()
        e = int(embed_dim)
        self.in_channels, self.embed_dim = int(in_channels), e
        self.global_feat, self.distill = global_feat, bool(distill)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, e))
        self.cls_pos = nn.Parameter(torch.zeros(1, 1, e))
        if self.distill:
            self.dist_token = nn.Parameter(torch.zeros(1, 1, e))
            self.dist_pos = nn.Parameter(torch.zeros(1, 1, e))
        self.patch_embed = PointPatchEmbed(num_groups, group_size, e,
                                           in_channels)
        self.pos_embed = _pos_mlp(e)
        self.blocks = nn.ModuleList(
            TransformerBlock(e, num_heads, mlp_ratio, qkv_bias, drop_rate)
            for _ in range(int(depth)))
        self.norm = nn.LayerNorm(e, eps=1e-6)
        self.seeded_init_(None)

    def seeded_init_(self, generator: Optional[torch.Generator]) -> None:
        _tokens_(self._tokens(), generator)

    def _tokens(self) -> List[nn.Parameter]:
        return ([self.cls_token, self.cls_pos]
                + ([self.dist_token, self.dist_pos] if self.distill else []))

    @property
    def out_channels(self) -> int:
        return len(self.global_feat.split(",")) * self.embed_dim

    @property
    def distill_channels(self) -> int:
        return self.embed_dim

    @property
    def channel_list(self) -> List[int]:
        return [self.in_channels, self.embed_dim]

    @property
    def n_tokens(self) -> int:
        return 2 if self.distill else 1

    def _encode(self, p, x, dropout_mask=None, generator=None):
        if x is None:
            x = p
        centers, tokens = self.patch_embed(p, x)
        pos = self.pos_embed(centers)
        b, e = tokens.shape[0], self.embed_dim
        toks = [self.cls_token.expand(b, 1, e), tokens]
        poss = [self.cls_pos.expand(b, 1, e), pos]
        if self.distill:
            toks.insert(1, self.dist_token.expand(b, 1, e))
            poss.insert(1, self.dist_pos.expand(b, 1, e))
        hx, pos_all = torch.cat(toks, dim=1), torch.cat(poss, dim=1)
        for blk, masks in zip(self.blocks,
                              _block_masks(dropout_mask, len(self.blocks))):
            # the positions enter every block's input (add_pos_each_block)
            hx = blk(hx + pos_all, masks, generator)
        return centers, self.norm(hx)

    def forward_cls_feat(self, p: torch.Tensor,
                         x: Optional[torch.Tensor] = None, dropout_mask=None,
                         generator: Optional[torch.Generator] = None):
        _, hx = self._encode(p, x, dropout_mask, generator)
        tokens = hx[:, self.n_tokens:, :]
        feats = []
        for t in self.global_feat.split(","):
            if "cls" in t:
                feats.append(hx[:, 0, :])
            elif "max" in t:
                feats.append(tokens.amax(dim=1))
            elif t in ("avg", "mean"):
                feats.append(tokens.mean(dim=1))
        global_feat = torch.cat(feats, dim=-1)
        if self.distill and self.training:
            return global_feat, hx[:, 1, :]
        return global_feat

    def forward_seg_feat(self, p: torch.Tensor,
                         x: Optional[torch.Tensor] = None, dropout_mask=None,
                         generator: Optional[torch.Generator] = None):
        """``([p, centers], [x, tokens])``, the token sequence with its cls
        token first (the ViT decoders strip it)."""
        centers, hx = self._encode(p, x, dropout_mask, generator)
        return [p, centers], [x, hx]

    def forward(self, p: torch.Tensor, x: Optional[torch.Tensor] = None,
                dropout_mask=None,
                generator: Optional[torch.Generator] = None):
        return self.forward_cls_feat(p, x, dropout_mask, generator)


class ViTFP(nn.Module):
    """One ViT decoder FP stage (parity: pointvit.py _make_dec): the 3-NN
    interpolation of ``f2`` onto ``p1``, ``[f1 || interp]``, then
    ``decoder_layers`` conv-BN-ReLU blocks (``mlp{j}``)."""

    def __init__(self, in_channels: int, fp_channels: int,
                 decoder_layers: int = 2):
        super().__init__()
        for j in range(int(decoder_layers)):
            self.add_module(f"mlp{j}", ConvBlock(
                in_channels if j == 0 else fp_channels, fp_channels,
                {"norm": "bn1d"}, {"act": "relu"}, kind="conv1d"))

    def forward(self, p1, f1, p2, f2):
        interp = ops.three_interpolation(p1, p2, f2)
        h = torch.cat([f1, interp], dim=-1) if f1 is not None else interp
        for mod in self.children():
            h = mod(h)
        return h


def _vit_fp_channels(encoder_channel_list, n_decoder_stages, channel_scaling):
    fp_channels = [encoder_channel_list[-1] * channel_scaling]
    for _ in range(n_decoder_stages - 1):
        fp_channels.insert(0, fp_channels[0] * channel_scaling)
    return fp_channels


def _vit_fp_inputs(encoder_channel_list, fp_channels, n, extra0: int = 0):
    """Input widths of the FP stages i = -1 ... -n: the deeper stage's
    output (the tokens at i = -1) and, at i = -n, the cloud's features
    (plus ``extra0`` class features)."""
    ins = {}
    for i in range(-1, -n - 1, -1):
        deep = encoder_channel_list[-1] if i == -1 else fp_channels[i + 1]
        ins[i] = deep + (encoder_channel_list[0] + extra0 if i == -n else 0)
    return ins


def _vit_insert_levels(p, f, n_decoder_stages, scale, sampler):
    """Intermediate levels between the cloud and the patch centers (parity:
    pointvit.py:242-247): each of ``N // scale`` points of the cloud, by FPS
    or the JAX package's strided stand-in for the reference's random
    sample."""
    p, f = list(p), list(f)
    if len(p) != n_decoder_stages + 1:
        for _ in range(n_decoder_stages - 1):
            m = p[0].shape[1] // scale
            if sampler.lower() == "fps":
                idx = ops.furthest_point_sample(p[0], m)
                p.insert(1, ops.index_points(p[0], idx))
            else:
                p.insert(1, p[0][:, ::scale][:, :m])
            f.insert(1, None)
    return p, f


def _vit_global_concat(f_out, cls_token, global_feat):
    """``[global tokens || f_out]`` (parity: pointvit.py:255-266)."""
    if global_feat is None:
        return f_out
    feats = []
    for t in global_feat.split(","):
        if "cls" in t:
            feats.append(cls_token)
        elif "max" in t:
            feats.append(f_out.amax(dim=1, keepdim=True))
        elif t in ("avg", "mean"):
            feats.append(f_out.mean(dim=1, keepdim=True))
    g = torch.cat(feats, dim=-1)
    g = g.expand(f_out.shape[0], f_out.shape[1], g.shape[-1])
    return torch.cat([g, f_out], dim=-1)


class _ViTDecoderBase(nn.Module):

    def __init__(self, encoder_channel_list: Sequence[int],
                 decoder_layers: int, n_decoder_stages: int, scale: int,
                 channel_scaling: int, sampler: str,
                 global_feat: Optional[str]):
        super().__init__()
        self.n, self.scale, self.sampler = (int(n_decoder_stages), int(scale),
                                            sampler)
        self.global_feat = global_feat
        self.enc = [int(c) for c in encoder_channel_list]
        self.fp_channels = _vit_fp_channels(self.enc, self.n,
                                            int(channel_scaling))
        self.decoder_layers = int(decoder_layers)

    @property
    def out_channels(self) -> int:
        n_global = len(self.global_feat.split(",")) if self.global_feat else 0
        return self.fp_channels[0] * (n_global + 1)

    def _levels(self, p, f):
        p, f = _vit_insert_levels(p, f, self.n, self.scale, self.sampler)
        cls_token = f[-1][:, 0:1, :]
        f[-1] = f[-1][:, 1:, :]
        return p, f, cls_token


@MODELS.register_module()
class PointViTDecoder(_ViTDecoderBase):
    """FP decoder from the patch centers back to the input cloud (parity:
    pointvit.py PointViTDecoder). ``forward(p, f)`` takes
    ``PointViT.forward_seg_feat``'s lists."""

    def __init__(self, encoder_channel_list: Sequence[int],
                 decoder_layers: int = 2, n_decoder_stages: int = 2,
                 scale: int = 4, channel_scaling: int = 1,
                 sampler: str = "fps", global_feat: Optional[str] = None,
                 progressive_input: bool = False):
        super().__init__(encoder_channel_list, decoder_layers,
                         n_decoder_stages, scale, channel_scaling, sampler,
                         global_feat)
        ins = _vit_fp_inputs(self.enc, self.fp_channels, self.n)
        for i in range(-1, -self.n - 1, -1):
            self.add_module(f"fp{self.n + i}", ViTFP(
                ins[i], self.fp_channels[i], self.decoder_layers))

    def forward(self, p, f):
        n = self.n
        p, f, cls_token = self._levels(p, f)
        for i in range(-1, -n - 1, -1):
            f[i - 1] = getattr(self, f"fp{n + i}")(p[i - 1], f[i - 1], p[i],
                                                   f[i])
        return _vit_global_concat(f[-n - 1], cls_token, self.global_feat)


@MODELS.register_module()
class PointViTPartDecoder(_ViTDecoderBase):
    """Part-seg ViT decoder with shape-class conditioning (parity:
    pointvit.py PointViTPartDecoder): ``cls_map: pointnet2`` maps the
    one-hot class to a 64-wide conv without a norm (``convc``), whose
    features the shallowest stage ``fp0`` takes before the cloud's."""

    def __init__(self, encoder_channel_list: Sequence[int],
                 decoder_layers: int = 2, n_decoder_stages: int = 2,
                 scale: int = 4, channel_scaling: int = 1,
                 sampler: str = "fps", global_feat: Optional[str] = None,
                 progressive_input: bool = False, cls_map: str = "pointnet2",
                 num_classes: int = 16, act_args: Optional[dict] = None):
        super().__init__(encoder_channel_list, decoder_layers,
                         n_decoder_stages, scale, channel_scaling, sampler,
                         global_feat)
        self.cls_map, self.num_classes = cls_map, int(num_classes)
        extra = 0
        if cls_map == "pointnet2":
            self.convc = ConvBlock(self.num_classes, 64, None,
                                   act_args or {"act": "relu"},
                                   kind="conv1d")
            extra = 64
        ins = _vit_fp_inputs(self.enc, self.fp_channels, self.n, extra)
        for i in range(-1, -self.n - 1, -1):
            self.add_module(f"fp{self.n + i}", ViTFP(
                ins[i], self.fp_channels[i], self.decoder_layers))

    def forward(self, p, f, cls_label):
        n = self.n
        p, f, cls_token = self._levels(p, f)
        B, N = p[0].shape[0], p[0].shape[1]
        one_hot = F.one_hot(cls_label.reshape(B).long(),
                            self.num_classes).to(f[-1].dtype)
        cls_feat = None
        if self.cls_map == "pointnet2":
            cls_feat = self.convc(one_hot[:, None, :].expand(
                B, N, self.num_classes))
        for i in range(-1, -n, -1):
            f[i - 1] = getattr(self, f"fp{n + i}")(p[i - 1], f[i - 1], p[i],
                                                   f[i])
        i = -n  # the shallowest stage takes the class features
        f1 = f[i - 1]
        if cls_feat is not None:
            f1 = cls_feat if f1 is None else torch.cat([cls_feat, f1], dim=-1)
        f[i - 1] = self.fp0(p[i - 1], f1, p[i], f[i])
        return _vit_global_concat(f[-n - 1], cls_token, self.global_feat)


class KMeansEmbed(nn.Module):
    """K-means cluster centers as group centers, then a kNN patch embedding
    (parity: layers/kmeans.py KMeansEmbed): ``[rel xyz || grouped
    features]`` (3 + ``in_channels`` wide) through two conv-LayerNorm-GELU
    blocks (128, 256), a max over each group and a Linear."""

    def __init__(self, num_groups: int = 256, group_size: int = 32,
                 embed_dim: int = 384, in_channels: int = 3,
                 n_iters: int = 10):
        super().__init__()
        self.num_groups, self.group_size = int(num_groups), int(group_size)
        self.n_iters = int(n_iters)
        ln, gelu = {"norm": "ln"}, {"act": "gelu"}
        self.conv0 = ConvBlock(3 + int(in_channels), 128, ln, gelu)
        self.conv1 = ConvBlock(128, 256, ln, gelu)
        self.proj = nn.Linear(256, int(embed_dim))

    def forward(self, p: torch.Tensor, x: torch.Tensor):
        _, centers = kmeans(p, self.num_groups, self.n_iters)
        nidx = ops.knn_idx(min(self.group_size, p.shape[1]), p, centers)
        grouped = ops.index_points(x, nidx)
        rel = ops.index_points(p, nidx) - centers[:, :, None, :]
        h = self.conv1(self.conv0(torch.cat([rel, grouped], dim=-1)))
        return centers, self.proj(h.amax(dim=2))


@MODELS.register_module()
class ViTGraph(nn.Module):
    """Graph ViT for point clouds (parity: graphvit3d.py ViTGraph): a group
    or k-means patch embedding of ``in_channels``-wide features (the xyz
    when none are given, then ``in_channels`` must be 3), a Linear to
    ``encoder_dim``, cls token and learned cls position, the positional MLP
    added to every block's input, a final LayerNorm. ``forward`` returns
    ``(centers, tokens)`` with the cls token first."""

    def __init__(self, in_channels: int = 6, num_classes: int = 40,
                 encoder_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, embed_args: Optional[dict] = None,
                 norm_args: Optional[dict] = None,
                 act_args: Optional[dict] = None):
        super().__init__()
        emb = dict(embed_args or {"NAME": "groupembed", "num_groups": 256,
                                  "group_size": 32, "embed_dim": 256})
        kind = (KMeansEmbed if emb.get("NAME", "groupembed").lower()
                == "kmeans" else PointPatchEmbed)
        d, e = int(encoder_dim), int(emb.get("embed_dim", 256))
        self.in_channels, self.encoder_dim = int(in_channels), d
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.cls_pos = nn.Parameter(torch.zeros(1, 1, d))
        self.group_embed = kind(num_groups=int(emb.get("num_groups", 256)),
                                group_size=int(emb.get("group_size", 32)),
                                embed_dim=e, in_channels=self.in_channels)
        self.proj_layer = nn.Linear(e, d)
        self.pos_embed = _pos_mlp(d)
        self.blocks = nn.ModuleList(TransformerBlock(d, num_heads, mlp_ratio)
                                    for _ in range(int(depth)))
        self.norm = nn.LayerNorm(d, eps=1e-6)
        self.seeded_init_(None)

    def seeded_init_(self, generator: Optional[torch.Generator]) -> None:
        _tokens_([self.cls_token, self.cls_pos], generator)

    @property
    def out_channels(self) -> int:
        return self.encoder_dim

    def forward(self, xyz: torch.Tensor, features=None):
        feats = xyz if features is None else features
        if feats.shape[-1] != self.in_channels:
            raise ValueError(f"ViTGraph was built for {self.in_channels} "
                             f"feature channels, got {feats.shape[-1]}")
        centers, h = self.group_embed(xyz, feats)
        h = self.proj_layer(h)
        b, d = h.shape[0], self.encoder_dim
        h = torch.cat([self.cls_token.expand(b, 1, d), h], dim=1)
        pos = torch.cat([self.cls_pos.expand(b, 1, d),
                         self.pos_embed(centers)], dim=1)
        for blk in self.blocks:
            h = blk(h + pos)
        return centers, self.norm(h)

    def forward_cls_feat(self, xyz: torch.Tensor, features=None):
        _, h = self(xyz, features)
        return torch.cat([h[:, 0], h[:, 1:].amax(dim=1)], dim=-1)


@MODELS.register_module()
class P3Embed(nn.Module):
    """Progressive point patch embedding (parity: group_embed.py P3Embed):
    ``int(log_scale(1 / sample_ratio))`` stages, each an FPS downsample by
    ``scale``, a ball (or kNN) group, aggregation features, conv1, the
    concat of the pooled group code, conv2 and a pool. ``forward(p, f)``
    returns the positions and features of every level."""

    def __init__(self, sample_ratio: float = 0.0625, scale: int = 4,
                 group_size: int = 32, in_channels: int = 3, layers: int = 4,
                 embed_dim: int = 256, group: str = "ballquery",
                 radius: float = 0.1, feature_type: str = "dp_df",
                 reduction: str = "max"):
        super().__init__()
        self.sample_ratio, self.scale = sample_ratio, int(scale)
        self.group_size, self.in_channels = int(group_size), int(in_channels)
        self.embed_dim, self.group = int(embed_dim), group
        self.radius, self.feature_type = float(radius), feature_type
        self.mean_pool = reduction in ("mean", "avg", "meanpool", "avgpool")
        half = int(layers) // 2
        bn, relu = {"norm": "bn"}, {"act": "relu"}
        c, dim = self.in_channels, self.channel_list[1]
        for s in range(self.stages):
            width = {"dp_df": 3 + c, "dp_fj": 3 + c}.get(feature_type,
                                                          3 + 2 * c)
            for i in range(half):
                last = i == half - 1
                self.add_module(f"s{s}_conv1_{i}", ConvBlock(
                    width if i == 0 else dim, dim, None if last else bn,
                    None if last else relu))
            chain = [dim * 2] * (half - 1) + [dim]
            c_in = 2 * dim
            for i, out in enumerate(chain):
                self.add_module(f"s{s}_conv2_{i}", ConvBlock(c_in, out, bn,
                                                             relu))
                c_in = out
            c, dim = dim, dim * 2
        self.half = half

    @property
    def stages(self) -> int:
        return int(math.log(1.0 / self.sample_ratio, self.scale))

    @property
    def channel_list(self) -> List[int]:
        dims = [self.in_channels]
        d = int(self.embed_dim // 2 ** (self.stages - 1))
        for _ in range(self.stages):
            dims.append(d)
            d *= 2
        return dims

    @property
    def out_channels(self) -> int:
        return self.channel_list[-1]

    def _pool(self, t: torch.Tensor) -> torch.Tensor:
        return (t.mean(dim=2, keepdim=True) if self.mean_pool
                else t.amax(dim=2, keepdim=True))

    def forward(self, p: torch.Tensor, f: Optional[torch.Tensor] = None):
        if f is None:
            f = p
        out_p, out_f = [p], [f]
        n = p.shape[1]
        for s in range(self.stages):
            cur_p, cur_f = out_p[-1], out_f[-1]
            n = n // self.scale
            idx = ops.furthest_point_sample(cur_p, n)
            center_p = ops.index_points(cur_p, idx)
            center_f = ops.index_points(cur_f, idx)
            if "ball" in self.group or "query" in self.group:
                nidx = ops.ball_query(self.radius, self.group_size, cur_p,
                                      center_p)
            else:
                nidx = ops.knn_idx(self.group_size, cur_p, center_p)
            dp = ops.index_points(cur_p, nidx) - center_p[:, :, None, :]
            fj = ops.index_points(cur_f, nidx)  # (B, G, K, C)
            df = fj - center_f[:, :, None, :]
            if self.feature_type == "dp_df":
                h = torch.cat([dp, df], dim=-1)
            elif self.feature_type == "dp_fj":
                h = torch.cat([dp, fj], dim=-1)
            else:
                h = torch.cat([dp, fj, df], dim=-1)
            for i in range(self.half):
                h = getattr(self, f"s{s}_conv1_{i}")(h)
            h = torch.cat([self._pool(h).expand(-1, -1, h.shape[2], -1), h],
                          dim=-1)
            for i in range(self.half):
                h = getattr(self, f"s{s}_conv2_{i}")(h)
            out_f.append(self._pool(h)[:, :, 0, :])
            out_p.append(center_p)
        return out_p, out_f

