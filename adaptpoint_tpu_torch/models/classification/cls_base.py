"""Classification wrapper + head.

Counterpart of ``adaptpoint_tpu/models/classification/cls_base.py``
(reference openpoints cls_base.py BaseCls, ClsHead). Head layout follows the
reference: ``head.{2k}`` = Linear (no bias) + BatchNorm1d + act,
``head.{2k+1}`` = Dropout, last slot = Linear with bias. Dropout is inactive
in eval; in training its keep-masks come from the caller, as tensors or as
the ``torch.Generator`` to draw them from (the two packages' random streams
cannot match, so parity tests inject the masks). Under the bf16 compute
policy the hidden layers give bf16 and the last one f32 logits.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Optional, Sequence

import torch
from torch import nn

from ..build import MODELS
from ..layers.blocks import ConvBlock, Dropout

__all__ = ["ClsHead", "BaseCls"]


@MODELS.register_module()
class ClsHead(nn.Module):
    """MLP classification head (parity: cls_base.py ClsHead)."""

    def __init__(self, num_classes: int, in_channels: Optional[int] = None,
                 mlps: Optional[Sequence[int]] = (256,),
                 norm_args: Optional[dict] = None,
                 act_args: Optional[dict] = None, dropout: float = 0.5,
                 global_feat: Optional[str] = None, point_dim: int = 1):
        super().__init__()
        if in_channels is None:
            raise ValueError("ClsHead needs in_channels")
        self.global_feat = global_feat.split(",") if global_feat else None
        self.point_dim = point_dim
        c_in = in_channels * (len(self.global_feat) if self.global_feat else 1)
        act_args = act_args or {"act": "relu"}
        layers = []
        for c in (mlps or []):
            layers.append(ConvBlock(c_in, c, norm_args=norm_args,
                                    act_args=act_args, kind="linear"))
            if dropout > 0:
                layers.append(Dropout(dropout))
            c_in = c
        # the last layer is a flax Dense without a dtype in the JAX package:
        # f32 logits under the bf16 policy too
        layers.append(ConvBlock(c_in, num_classes, kind="linear",
                                policy=False))
        self.head = nn.Sequential(*layers)

    @property
    def num_classes(self) -> int:
        return self.head[-1].conv.out_features

    def forward(self, x: torch.Tensor, dropout_mask=None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``dropout_mask``: one keep-mask tensor, or a sequence with one per
        dropout layer in order; ``None`` draws them from ``generator``."""
        if self.global_feat is not None:
            feats = []
            for pre in self.global_feat:
                if "max" in pre:
                    feats.append(x.amax(dim=self.point_dim))
                elif pre in ("avg", "mean"):
                    feats.append(x.mean(dim=self.point_dim))
            x = torch.cat(feats, dim=-1)
        if isinstance(dropout_mask, torch.Tensor):
            dropout_mask = [dropout_mask]
        masks = iter(dropout_mask or ())
        for layer in self.head:
            if isinstance(layer, Dropout):
                x = layer(x, next(masks, None), generator)
            else:
                x = layer(x)
        return x


@MODELS.register_module()
class BaseCls(nn.Module):
    """Encoder + ClsHead composition (parity: cls_base.py BaseCls)."""

    def __init__(self, encoder_args: dict, cls_args: Optional[dict] = None,
                 criterion_args: Optional[dict] = None):
        super().__init__()
        self.encoder = MODELS.build(encoder_args)
        self.prediction = None
        if cls_args is not None:
            cls_args = dict(cls_args)
            if cls_args.get("in_channels") is None:
                cls_args["in_channels"] = self.encoder.out_channels
            self.prediction = MODELS.build(cls_args)

    @property
    def num_classes(self) -> int:
        return self.prediction.num_classes

    def forward(self, pos: torch.Tensor, x: Optional[torch.Tensor] = None,
                fused_eval: bool = False, dropout_mask=None,
                generator: Optional[torch.Generator] = None,
                first_fps_idx: Optional[torch.Tensor] = None,
                fused_train_bn: bool = False) -> torch.Tensor:
        """``first_fps_idx`` (B, >= first stage's M): FPS indices of ``pos``
        the caller already has, shared with the encoder's first subsampling
        stage. ``fused_train_bn``: in training the encoder's standard SA
        stages take the fused train-BN route (``ops.sa_trainbn``).
        ``fused_eval``, ``first_fps_idx`` and ``fused_train_bn`` reach only
        an encoder with fused stages (``fused_routes``: PointNeXt); the
        others take ``(pos, x)`` and ignore the switches, as the JAX
        package's do. An encoder with dropout of its own (``takes_dropout``:
        PointViT) also takes ``generator`` and, where ``dropout_mask`` is a
        mapping, its ``"encoder"`` masks (the head then takes its
        ``"head"`` ones)."""
        head_mask = dropout_mask
        if getattr(self.encoder, "fused_routes", False):
            feat = self.encoder.forward_cls_feat(pos, x, fused_eval,
                                                 first_fps_idx,
                                                 fused_train_bn)
        elif getattr(self.encoder, "takes_dropout", False):
            enc_mask = None
            if isinstance(dropout_mask, Mapping):
                enc_mask = dropout_mask.get("encoder")
                head_mask = dropout_mask.get("head")
            feat = self.encoder.forward_cls_feat(pos, x, enc_mask, generator)
        else:
            feat = self.encoder.forward_cls_feat(pos, x)
        if self.prediction is None:
            return feat
        return self.prediction(feat, head_mask, generator)
