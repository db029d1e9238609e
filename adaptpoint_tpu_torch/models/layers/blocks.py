"""Conv/norm/act building blocks, applied channels-last.

Counterpart of ``adaptpoint_tpu/models/layers/blocks.py``. The parameters
live in the reference openpoints modules (``Conv1d``/``Conv2d``/``Linear``
at Sequential slot 0, ``BatchNorm`` at slot 1), so a reference ``.pth``
loads with ``load_state_dict`` as it is; the forward applies them as a
pointwise matmul over the last axis, which is the same arithmetic.

BatchNorm: eps 1e-5, momentum 0.1 (flax's momentum 0.9 is torch's 0.1; eval
uses only the running statistics).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

__all__ = ["create_act", "ConvBlock", "CHANNEL_MAP", "norm_kind"]

# channel-size mapper per aggregation feature type
# (parity: openpoints/models/layers/local_aggregation.py CHANNEL_MAP)
CHANNEL_MAP = {
    "fj": lambda c: c,
    "df": lambda c: c,
    "assa": lambda c: c * 3,
    "assa_dp": lambda c: c * 3 + 3,
    "dp_fj": lambda c: 3 + c,
    "pj": lambda c: c,
    "dp": lambda c: 3,
    "pi_dp": lambda c: c + 3,
    "dp_fj_df": lambda c: c * 2 + 3,
    "dp_fi_df": lambda c: c * 2 + 3,
    "pi_dp_fj_df": lambda c: c * 2 + 6,
    "dp_df": lambda c: c + 3,
}


def create_act(act_args: Optional[dict]) -> Optional[nn.Module]:
    """Activation factory (parity: openpoints/models/layers/activation.py)."""
    if not act_args or act_args.get("act") is None:
        return None
    name = act_args["act"].lower()
    if name == "relu":
        return nn.ReLU()
    if name in ("leakyrelu", "rrelu"):
        # eval-mode rrelu is a leaky relu with the mean slope
        slope = (act_args.get("negative_slope", 0.01) if name == "leakyrelu"
                 else (1 / 8 + 1 / 3) / 2)
        return nn.LeakyReLU(slope)
    if name == "gelu":
        return nn.GELU(approximate="tanh")  # flax's nn.gelu default
    simple = {"sigmoid": nn.Sigmoid, "tanh": nn.Tanh, "silu": nn.SiLU,
              "swish": nn.SiLU, "hardswish": nn.Hardswish, "elu": nn.ELU,
              "selu": nn.SELU}
    if name in simple:
        return simple[name]()
    raise ValueError(f"unknown activation {name}")


def norm_kind(norm_args: Optional[dict]) -> Optional[str]:
    """'bn' when the args ask for batch norm, None for no norm."""
    if not norm_args or not norm_args.get("norm"):
        return None
    norm = norm_args["norm"].lower()
    if not norm.startswith("bn"):
        raise ValueError(f"norm {norm} is not ported yet (only bn)")
    return "bn"


class ConvBlock(nn.Sequential):
    """Pointwise conv [+ BatchNorm] [+ act] over the last axis.

    ``kind`` picks the reference module holding the weight: ``conv2d``
    (out, in, 1, 1) for grouped SA convs, ``conv1d`` (out, in, 1) for the
    stem and skip convs, ``linear`` (out, in) for head layers. The conv has
    a bias only when no norm follows (reference ``create_convblock*``).
    Only the ``conv-norm-act`` order is ported.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 norm_args: Optional[dict] = None,
                 act_args: Optional[dict] = None, kind: str = "conv2d",
                 order: str = "conv-norm-act"):
        if order != "conv-norm-act":
            raise ValueError(f"conv order {order} is not ported yet")
        norm = norm_kind(norm_args)
        bias = norm is None
        conv = {"conv2d": lambda: nn.Conv2d(in_channels, out_channels, 1,
                                            bias=bias),
                "conv1d": lambda: nn.Conv1d(in_channels, out_channels, 1,
                                            bias=bias),
                "linear": lambda: nn.Linear(in_channels, out_channels,
                                            bias=bias)}[kind]()
        mods = [conv]
        if norm is not None:
            mods.append(nn.BatchNorm1d(out_channels, eps=1e-5, momentum=0.1))
        act = create_act(act_args)
        if act is not None:
            mods.append(act)
        super().__init__(*mods)

    @property
    def conv(self) -> nn.Module:
        return self[0]

    @property
    def bn(self) -> Optional[nn.BatchNorm1d]:
        return self[1] if len(self) > 1 and isinstance(
            self[1], nn.BatchNorm1d) else None

    def weight_matrix(self) -> torch.Tensor:
        """The conv weight as an (out, in) matrix."""
        return self.conv.weight.flatten(1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.nn.functional.linear(x, self.weight_matrix(), self.conv.bias)
        for mod in list(self)[1:]:
            if isinstance(mod, nn.BatchNorm1d):
                y = mod(y.reshape(-1, y.shape[-1])).reshape(y.shape)
            else:
                y = mod(y)
        return y
