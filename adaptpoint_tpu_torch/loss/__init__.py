"""Loss registry, the classification criteria and the GAN criterion.

Counterpart of ``adaptpoint_tpu/loss/__init__.py`` for what classifier
training, the adversarial step and scene segmentation use: the ``LOSS``
registry, ``SmoothCrossEntropy``, ``CrossEntropy``, ``MaskedCrossEntropy``
and ``BCELoss``. A criterion is a plain callable of ``(logits, labels)``
(``MaskedCrossEntropy``: and the points' mask; ``BCELoss``: of
probabilities and targets) that returns a scalar tensor; logits are
channels-last ``(..., C)``.
The other criteria of the JAX package (focal, poly-1, distillation) wait for
the slices that use them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.registry import Registry, build_from_cfg

LOSS = Registry("loss")

__all__ = ["LOSS", "build_criterion_from_cfg", "SmoothCrossEntropy",
           "CrossEntropy", "MaskedCrossEntropy", "BCELoss"]


@LOSS.register_module(name="SmoothCrossEntropy")
class SmoothCrossEntropy:
    """Label-smoothed cross entropy: the target holds ``1 - eps`` on the true
    class and ``eps / (n - 1)`` on every other one. ``weight`` scales each
    class's term; rows whose label is ``ignore_index`` leave the mean."""

    def __init__(self, label_smoothing: float = 0.2, ignore_index=None,
                 num_classes=None, weight=None, **kwargs):
        self.label_smoothing = label_smoothing
        self.ignore_index = ignore_index
        self.num_classes = num_classes
        self.weight = None if weight is None else torch.as_tensor(
            weight, dtype=torch.float32)

    def per_sample(self, logits: torch.Tensor,
                   labels: torch.Tensor) -> torch.Tensor:
        """Unreduced loss of each row."""
        n_class = logits.shape[-1]
        eps = self.label_smoothing
        one_hot = F.one_hot(labels.long(), n_class).to(logits.dtype)
        target = one_hot
        if eps > 0:
            target = one_hot * (1.0 - eps) + (1.0 - one_hot) * eps / (n_class - 1)
        per = -(target * F.log_softmax(logits, dim=-1))
        if self.weight is not None:
            per = per * self.weight.to(per)
        return per.sum(dim=-1)

    def __call__(self, logits: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
        logits = logits.reshape(-1, logits.shape[-1])
        labels = labels.reshape(-1)
        if self.ignore_index is None:
            return self.per_sample(logits, labels).mean()
        valid = (labels != self.ignore_index).to(logits.dtype)
        labels = torch.where(labels == self.ignore_index,
                             torch.zeros_like(labels), labels)
        per = self.per_sample(logits, labels)
        return (per * valid).sum() / torch.clamp(valid.sum(), min=1.0)


@LOSS.register_module(name="CrossEntropy")
@LOSS.register_module(name="CrossEntropyLoss")
class CrossEntropy(SmoothCrossEntropy):
    def __init__(self, label_smoothing: float = 0.0, **kwargs):
        super().__init__(label_smoothing=label_smoothing, **kwargs)


@LOSS.register_module(name="MaskedCrossEntropy")
class MaskedCrossEntropy:
    """Label-smoothed cross entropy over the points a mask keeps (parity:
    loss/build.py MaskedCrossEntropy): (sum of per-point losses times the
    mask) / max(sum of the mask, 1). The S3DIS spheres' mask marks their
    real points; the copies that pad a sphere leave the mean."""

    def __init__(self, label_smoothing: float = 0.2, **kwargs):
        self.ce = SmoothCrossEntropy(label_smoothing=label_smoothing)

    def __call__(self, logits: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
        per = self.ce.per_sample(logits.reshape(-1, logits.shape[-1]),
                                 labels.reshape(-1))
        m = mask.reshape(-1).to(per.dtype)
        return (per * m).sum() / torch.clamp(m.sum(), min=1.0)


@LOSS.register_module(name="BCELoss")
class BCELoss:
    """Binary cross entropy on probabilities, clipped to [1e-7, 1 - 1e-7]
    before the logarithms (the GAN criterion)."""

    def __call__(self, probs: torch.Tensor,
                 targets: torch.Tensor) -> torch.Tensor:
        p = torch.clamp(probs, 1e-7, 1.0 - 1e-7)
        t = targets.to(p.dtype)
        return -(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p)).mean()


def build_criterion_from_cfg(cfg, **default_args):
    return build_from_cfg(cfg, LOSS, default_args or None)
