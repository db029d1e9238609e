"""PointNet-style spectral-norm discriminator.

Counterpart of ``adaptpoint_tpu/adapt/discriminator.py``
(``PointDiscriminator1``): one group-all set abstraction of spectral-normed
pointwise convs [64, 128, 1024] with relu and no BatchNorm, a max-pool,
spectral-normed FC 1024 -> 512 -> 256 -> num_classes with dropout 0.4, and a
spectral-normed Linear -> sigmoid probability head.

The spectral norm is the port's own and follows ``flax.linen.SpectralNorm``,
not ``torch.nn.utils.parametrizations.spectral_norm``:

- one power iteration runs on *every* call, training or not, from the stored
  ``u``; only *storing* the new ``u`` (and ``v``, ``sigma``) waits for
  ``update_stats`` (PyTorch's iterates only in training);
- ``u`` and ``v`` carry no gradient, ``sigma = v W u^T`` is differentiated
  through ``W``;
- vectors are normalised as ``x * rsqrt(sum(x^2) + 1e-12)`` (PyTorch's
  divides by ``max(|x|, eps)``);
- the bias is not normalised.

Parameter and buffer names are those of the reference ``state_dict``
(``parametrizations.weight.original``, ``.0._u``, ``.0._v``), so one loads as
it is. ``sigma``, which flax keeps beside ``u``, has no slot there: it is a
non-persistent buffer.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers.blocks import Dropout
from .build import ADAPTMODELS

__all__ = ["SpectralNormLinear", "PointDiscriminator1"]

_EPS = 1e-12


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum() + _EPS)


class _PowerIterationState(nn.Module):
    def __init__(self, out_features: int, in_features: int):
        super().__init__()
        u = F.normalize(torch.randn(out_features), dim=0)
        self.register_buffer("_u", u)
        self.register_buffer("_v", F.normalize(torch.randn(in_features),
                                               dim=0))
        self.register_buffer("_sigma", torch.ones(()), persistent=False)


class _NormedWeight(nn.Module):
    def __init__(self, weight_shape):
        super().__init__()
        self.original = nn.Parameter(torch.empty(weight_shape))
        fan_in = int(torch.tensor(weight_shape[1:]).prod())
        self.add_module("0", _PowerIterationState(weight_shape[0], fan_in))

    @property
    def state(self) -> _PowerIterationState:
        return getattr(self, "0")


class SpectralNormLinear(nn.Module):
    """Pointwise linear map over the last axis whose weight is divided by
    its largest singular value, estimated as flax's SpectralNorm does.

    ``weight_shape`` is the reference module's: (out, in) for a Linear,
    (out, in, 1, 1) for a 1x1 Conv2d."""

    def __init__(self, in_features: int, out_features: int,
                 conv2d: bool = False):
        super().__init__()
        shape = (out_features, in_features) + ((1, 1) if conv2d else ())
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.parametrizations = nn.ModuleDict(
            {"weight": _NormedWeight(shape)})
        self.reset_parameters_(None)

    def reset_parameters_(self, generator: Optional[torch.Generator]) -> None:
        """U(+-1/sqrt(fan_in)) weight, zero bias, unit-norm normal ``u``,
        ``v`` (flax's initial state), drawn from ``generator``."""
        st = self.state
        with torch.no_grad():
            bound = self.weight_original[0].numel() ** -0.5
            self.weight_original.uniform_(-bound, bound, generator=generator)
            self.bias.zero_()
            for vec in (st._u, st._v):
                vec.copy_(F.normalize(torch.randn(
                    vec.shape, generator=generator), dim=0))
            st._sigma.fill_(1.0)

    @property
    def weight_original(self) -> torch.Tensor:
        return self.parametrizations["weight"].original

    @property
    def state(self) -> _PowerIterationState:
        return self.parametrizations["weight"].state

    def normed_weight(self, update_stats: bool) -> torch.Tensor:
        """(out, in) weight over sigma; stores u, v, sigma when asked."""
        w = self.weight_original.flatten(1)  # (out, in)
        st = self.state
        with torch.no_grad():
            v0 = _l2_normalize(torch.matmul(st._u[None, :], w))      # (1, in)
            u0 = _l2_normalize(torch.matmul(v0, w.t()))              # (1, out)
        sigma = torch.matmul(torch.matmul(v0, w.t()), u0.t())[0, 0]
        w_bar = w / torch.where(sigma != 0, sigma, torch.ones_like(sigma))
        if update_stats:
            with torch.no_grad():
                st._u.copy_(u0[0])
                st._v.copy_(v0[0])
                st._sigma.copy_(sigma)
        return w_bar

    def forward(self, x: torch.Tensor, update_stats: bool) -> torch.Tensor:
        return F.linear(x, self.normed_weight(update_stats), self.bias)


class _SetAbstraction(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.mlp_convs = nn.ModuleList([
            SpectralNormLinear(channels[i], channels[i + 1], conv2d=True)
            for i in range(len(channels) - 1)])


@ADAPTMODELS.register_module()
class PointDiscriminator1(nn.Module):
    def __init__(self, num_classes: int = 40, normal_channel: bool = False):
        super().__init__()
        self.sa1 = _SetAbstraction([3, 64, 128, 1024])
        self.fc1 = SpectralNormLinear(1024, 512)
        self.fc2 = SpectralNormLinear(512, 256)
        self.fc3 = SpectralNormLinear(256, num_classes)
        self.prob_head = nn.Sequential(SpectralNormLinear(num_classes, 1))
        self.drop1, self.drop2 = Dropout(0.4), Dropout(0.4)

    def forward(self, xyz: torch.Tensor, dropout_mask=None,
                generator: Optional[torch.Generator] = None,
                update_stats: Optional[bool] = None) -> torch.Tensor:
        """xyz (B, N, 3) -> prob (B, 1). ``dropout_mask``: the two keep-masks
        (B, 512) and (B, 256), or ``None`` to draw them from ``generator``.
        ``update_stats`` (default: the training flag) stores the advanced
        power-iteration vectors."""
        if update_stats is None:
            update_stats = self.training
        masks = iter(dropout_mask or ())
        x = xyz
        for conv in self.sa1.mlp_convs:
            x = F.relu(conv(x, update_stats))
        x = x.amax(dim=1)  # group-all max pool -> (B, 1024)
        for fc, drop in ((self.fc1, self.drop1), (self.fc2, self.drop2)):
            x = drop(F.relu(fc(x, update_stats)), next(masks, None), generator)
        x = self.fc3(x, update_stats)
        return torch.sigmoid(self.prob_head[0](x, update_stats).float())
