"""Conv/norm/act building blocks, applied channels-last.

Counterpart of ``adaptpoint_tpu/models/layers/blocks.py``. The parameters
live in the reference openpoints modules (``Conv1d``/``Conv2d``/``Linear``
at Sequential slot 0, ``BatchNorm`` at slot 1), so a reference ``.pth``
loads with ``load_state_dict`` as it is; the forward applies them as a
pointwise matmul over the last axis, which is the same arithmetic.

BatchNorm: eps 1e-5, momentum 0.1 (flax's momentum 0.9 is torch's 0.1; eval
uses only the running statistics). In training :class:`BatchNorm` follows
flax's ``nn.BatchNorm`` and keeps the *biased* batch variance in
``running_var`` (``nn.BatchNorm1d`` would keep the unbiased one). A fused SA
stage that computes its BatchNorms itself records its statistics through
:meth:`BatchNorm.record_stats`.

The bf16 compute policy (``utils.precision``) rounds where flax's
``nn.Dense(dtype=bf16)`` and ``nn.BatchNorm(dtype=bf16)`` round:
:func:`dense` and :class:`BatchNorm` read it; a :class:`ConvBlock` built
with ``policy=False`` stands for a flax ``Dense`` without a ``dtype`` and
computes in the promoted type of its input and its f32 parameters.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...utils.precision import compute_dtype

__all__ = ["create_act", "ConvBlock", "BatchNorm", "Dropout", "CHANNEL_MAP",
           "norm_kind", "dense"]

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


def dense(x: torch.Tensor, weight: torch.Tensor,
          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ weight.T + bias`` as flax's ``nn.Dense(dtype=compute_dtype())``
    computes it: under the bf16 policy the operands are rounded to bf16, the
    product is bf16 and the bias is added in bf16 after it (a second
    rounding); without a policy in the tensors' own type."""
    dt = compute_dtype()
    if dt is None:
        return F.linear(x, weight, bias)
    y = F.linear(x.to(dt), weight.to(dt))
    return y if bias is None else y + bias.to(dt)


def norm_kind(norm_args: Optional[dict]) -> Optional[str]:
    """'bn' when the args ask for batch norm, 'ln' for layer norm, None for
    no norm."""
    if not norm_args or not norm_args.get("norm"):
        return None
    norm = norm_args["norm"].lower()
    for kind in ("bn", "ln"):
        if norm.startswith(kind):
            return kind
    raise ValueError(f"norm {norm} is not ported yet (only bn and ln)")


class BatchNorm(nn.BatchNorm1d):
    """``nn.BatchNorm1d`` over (rows, C) whose training statistics follow the
    JAX package's (flax ``nn.BatchNorm``, momentum 0.9).

    Both normalise a training batch with its biased variance. They differ in
    what they remember: flax blends the *biased* variance into its running
    ``var``, ``nn.BatchNorm1d`` the unbiased one (n/(n-1) larger: 32/31 in the
    head at a batch of 32). This module follows flax. Parameter and buffer
    names, ``num_batches_tracked`` and the eval forward are
    ``nn.BatchNorm1d``'s.

    The variance is the two-pass one, not flax's ``max(0, E[x^2] -
    E[x]^2)``: in f32 the two formulas part as the mean outgrows the spread,
    but flax's own sums are then a few ulps from the exact ones, and any
    other summation order of its formula lands as far from flax's value as
    the two-pass variance does (``scripts/torch_bn_variance_vs_flax.py``).
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the bf16 policy (flax's nn.BatchNorm(dtype=bf16)): statistics and
        # normalisation in f32 from the bf16 input, one rounding after
        dt = compute_dtype()
        if dt is not None:
            return self._forward(x.float()).to(dt)
        return self._forward(x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or not self.track_running_stats:
            return super().forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=0, correction=0)
        self.record_stats(mean, var)
        return torch.nn.functional.batch_norm(
            x, None, None, self.weight, self.bias, True, 0.0, self.eps)

    @torch.no_grad()
    def record_stats(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """Blend a train batch's ``mean`` and biased ``var`` into the running
        statistics and count the batch, as a train forward does. A fused SA
        stage that normalises with statistics of its own records them here
        (the counterpart of the JAX package's ``BNStatsHandle``)."""
        if self.momentum is None:
            raise NotImplementedError("cumulative-average BatchNorm "
                                      "(momentum=None) is not ported")
        self.running_mean.lerp_(mean.detach().to(self.running_mean.dtype),
                                self.momentum)
        self.running_var.lerp_(var.detach().to(self.running_var.dtype),
                               self.momentum)
        self.num_batches_tracked += 1


class Dropout(nn.Dropout):
    """Dropout whose randomness is explicit: the caller hands in the keep-mask
    (1 keeps, 0 drops) or the ``torch.Generator`` it is drawn from. Kept
    units are divided by ``1 - p`` as flax's ``nn.Dropout`` does, the keep
    probability in the input's type (bf16(0.6) for a bf16 input, as JAX
    casts the python float); eval is the identity."""

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if mask is None:
            dev = x.device if generator is None else generator.device
            mask = (torch.rand(x.shape, generator=generator, device=dev)
                    >= self.p).to(x.device)
        keep = torch.tensor(1.0 - self.p, dtype=x.dtype)
        return x * mask.to(x.dtype) / keep


class ConvBlock(nn.Sequential):
    """Pointwise conv [+ BatchNorm] [+ act] over the last axis.

    ``kind`` picks the reference module holding the weight: ``conv2d``
    (out, in, 1, 1) for grouped SA convs, ``conv1d`` (out, in, 1) for the
    stem and skip convs, ``linear`` (out, in) for head layers. The conv has
    a bias only when no norm follows (reference ``create_convblock*``), or
    where ``bias`` says so (PointMLP's ``bias: True`` convs before a norm);
    ``bias=False`` drops it behind no norm too. ``order`` is
    ``conv-norm-act`` (slots conv, BatchNorm, act) or ``conv-act-norm``
    (conv, act, BatchNorm: BallDGCNN's default). ``norm: ln`` puts a
    ``LayerNorm`` (eps 1e-5, flax's) where the BatchNorm would be. The conv
    follows the compute policy (:func:`dense`), unless ``policy`` is False:
    then it computes in the promoted type of its input and its parameters,
    as a flax ``Dense`` without a ``dtype`` does (the SA stage's skip conv,
    the head's last layer).
    """

    def __init__(self, in_channels: int, out_channels: int,
                 norm_args: Optional[dict] = None,
                 act_args: Optional[dict] = None, kind: str = "conv2d",
                 order: str = "conv-norm-act", policy: bool = True,
                 bias: Optional[bool] = None):
        if order not in ("conv-norm-act", "conv-act-norm"):
            raise ValueError(f"conv order {order} is not ported yet")
        norm = norm_kind(norm_args)
        bias = norm is None if bias is None else bias
        conv = {"conv2d": lambda: nn.Conv2d(in_channels, out_channels, 1,
                                            bias=bias),
                "conv1d": lambda: nn.Conv1d(in_channels, out_channels, 1,
                                            bias=bias),
                "linear": lambda: nn.Linear(in_channels, out_channels,
                                            bias=bias)}[kind]()
        bn = {None: lambda: None,
              "bn": lambda: BatchNorm(out_channels, eps=1e-5, momentum=0.1),
              "ln": lambda: nn.LayerNorm(out_channels, eps=1e-5)}[norm]()
        act = create_act(act_args)
        tail = [bn, act] if order == "conv-norm-act" else [act, bn]
        super().__init__(conv, *(m for m in tail if m is not None))
        self.policy = policy

    @property
    def conv(self) -> nn.Module:
        return self[0]

    @property
    def bn(self) -> Optional[nn.BatchNorm1d]:
        return next((m for m in self if isinstance(m, nn.BatchNorm1d)), None)

    def weight_matrix(self) -> torch.Tensor:
        """The conv weight as an (out, in) matrix."""
        return self.conv.weight.flatten(1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight_matrix()
        if self.policy:
            y = dense(x, w, self.conv.bias)
        else:
            y = F.linear(x.to(torch.promote_types(x.dtype, w.dtype)), w,
                         self.conv.bias)
        for mod in list(self)[1:]:
            if isinstance(mod, nn.BatchNorm1d):
                y = mod(y.reshape(-1, y.shape[-1])).reshape(y.shape)
            elif isinstance(mod, nn.LayerNorm):
                # flax's LayerNorm gives the promoted type of its input and
                # its f32 parameters: f32
                y = mod(y.float())
            else:
                y = mod(y)
        return y
