"""Segmentation wrappers and the per-point head.

Counterpart of ``adaptpoint_tpu/models/segmentation/base_seg.py``
(reference openpoints base_seg.py BaseSeg, BasePartSeg, SegHead): the
encoder's ``forward_seg_feat``, the FP decoder built from the encoder's args
and channel list, then a per-point MLP head. ``BasePartSeg`` hands the shape
category to the part decoder. Head layout: ``head.{i}`` = Conv1d (no bias)
+ BatchNorm1d + act for each hidden layer, a Dropout after the last one,
then a Conv1d with bias. As in the JAX package, only the last hidden layer
is followed by dropout. In training its keep-mask (B, N, C) comes from the
caller, as a tensor or as the ``torch.Generator`` to draw it from (the two
packages' random streams cannot match, so parity tests inject the mask).
``VariableSeg``, ``VariableSegHead`` and ``MultiSegHead`` wait for the
scene-segmentation slice.
"""
from __future__ import annotations

import copy
from typing import Optional, Sequence

import torch
from torch import nn

from ..build import MODELS
from ..layers.blocks import ConvBlock, Dropout

__all__ = ["SegHead", "BaseSeg", "BasePartSeg"]


@MODELS.register_module()
class SegHead(nn.Module):
    """Per-point MLP head (parity: base_seg.py SegHead). ``global_feat``
    (``"max"``, ``"avg"`` or both, comma-separated) appends each global
    pool of the input to every point's features."""

    def __init__(self, num_classes: int, in_channels: Optional[int] = None,
                 mlps: Optional[Sequence[int]] = None,
                 norm_args: Optional[dict] = None,
                 act_args: Optional[dict] = None, dropout: float = 0.5,
                 global_feat: Optional[str] = None):
        super().__init__()
        if in_channels is None:
            raise ValueError("SegHead needs in_channels")
        self.global_feat = global_feat.split(",") if global_feat else None
        c_in = in_channels * (1 + len(self.global_feat or ()))
        mlps = list(mlps) if mlps is not None else [c_in]
        layers = []
        for i, c in enumerate(mlps):
            layers.append(ConvBlock(
                c_in, c, norm_args=norm_args or {"norm": "bn1d"},
                act_args=act_args or {"act": "relu"}, kind="conv1d"))
            if dropout and i == len(mlps) - 1:
                layers.append(Dropout(dropout))
            c_in = c
        # a flax Dense without a dtype in the JAX package
        layers.append(ConvBlock(c_in, num_classes, kind="conv1d",
                                policy=False))
        self.head = nn.Sequential(*layers)

    def forward(self, f: torch.Tensor, dropout_mask=None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """f (B, N, C) -> logits (B, N, num_classes). ``dropout_mask``: the
        keep-mask tensor (or a sequence holding it); ``None`` draws it from
        ``generator``."""
        x = f
        if self.global_feat is not None:
            feats = [x]
            for pre in self.global_feat:
                g = (x.amax(dim=1, keepdim=True) if "max" in pre
                     else x.mean(dim=1, keepdim=True))
                feats.append(g.expand_as(x))
            x = torch.cat(feats, dim=-1)
        if isinstance(dropout_mask, (list, tuple)):
            dropout_mask = dropout_mask[0] if dropout_mask else None
        for layer in self.head:
            if isinstance(layer, Dropout):
                x = layer(x, dropout_mask, generator)
            else:
                x = layer(x)
        return x


@MODELS.register_module()
class BaseSeg(nn.Module):
    """Encoder + decoder + head (parity: base_seg.py BaseSeg). The decoder
    is built from the encoder's args updated with ``decoder_args`` and the
    encoder's channel list; the head's ``in_channels`` defaults to the
    decoder's ``out_channels`` (the encoder's without a decoder)."""

    def __init__(self, encoder_args: dict, decoder_args: Optional[dict] = None,
                 cls_args: Optional[dict] = None):
        super().__init__()
        self.encoder = MODELS.build(encoder_args)
        self.decoder = None
        if decoder_args is not None:
            dec = copy.deepcopy(dict(encoder_args))
            dec.update(dict(decoder_args))
            dec["encoder_channel_list"] = self.encoder.channel_list
            self.decoder = MODELS.build(dec)
        self.head = None
        if cls_args is not None:
            cls_args = dict(cls_args)
            if cls_args.get("in_channels") is None:
                cls_args["in_channels"] = getattr(
                    self.decoder, "out_channels", self.encoder.out_channels)
            self.head = MODELS.build(cls_args)

    def _features(self, pos, x, fused_eval, fused_train_bn):
        return self.encoder.forward_seg_feat(pos, x, fused_eval,
                                             fused_train_bn=fused_train_bn)

    def _head(self, f, dropout_mask, generator):
        if isinstance(f, list):
            f = f[-1]
        if self.head is None:
            return f
        return self.head(f, dropout_mask, generator)

    def forward(self, pos: torch.Tensor, x: Optional[torch.Tensor] = None,
                fused_eval: bool = False, dropout_mask=None,
                generator: Optional[torch.Generator] = None,
                fused_train_bn: bool = False) -> torch.Tensor:
        """pos (B, N, 3), x (B, N, C) -> (B, N, num_classes).
        ``fused_eval`` / ``fused_train_bn``: the encoder's SA stages take
        the fused eval / train-BN routes where they fit."""
        p, f = self._features(pos, x, fused_eval, fused_train_bn)
        if self.decoder is not None:
            f = self.decoder(p, f)
        return self._head(f, dropout_mask, generator)


@MODELS.register_module()
class BasePartSeg(BaseSeg):
    """Part segmentation: the shape category conditions the decoder
    (parity: base_seg.py BasePartSeg)."""

    def forward(self, pos: torch.Tensor, x: Optional[torch.Tensor] = None,
                cls0: Optional[torch.Tensor] = None,
                fused_eval: bool = False, dropout_mask=None,
                generator: Optional[torch.Generator] = None,
                fused_train_bn: bool = False) -> torch.Tensor:
        """pos (B, N, 3), x (B, N, C), cls0 (B,) or (B, 1) shape categories
        -> (B, N, num_classes)."""
        p, f = self._features(pos, x, fused_eval, fused_train_bn)
        if self.decoder is not None:
            f = self.decoder(p, f, cls0)
        return self._head(f, dropout_mask, generator)
