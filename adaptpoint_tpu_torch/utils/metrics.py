"""Classification metrics on torch tensors.

Counterpart of ``adaptpoint_tpu/utils/metrics.py`` for the trainers:
``AverageMeter``, ``ConfusionMatrix`` (``update``, ``all_acc``, ``tp``,
``count``, ``union``; accuracies in percent) and ``get_mious``, scene
segmentation's IoUs from the matrix's counts. The matrix is an int64 tensor on the CPU; ``update``
takes predictions and labels from any device and brings them over, so the
caller decides when that copy (a device sync) happens.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["AverageMeter", "ConfusionMatrix", "get_mious"]


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class ConfusionMatrix:
    """Accumulated confusion matrix, rows = true class. ``ignore_index`` must
    be < 0 or >= num_classes."""

    def __init__(self, num_classes: int, ignore_index=None):
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.virtual_num_classes = num_classes + (ignore_index is not None)
        self.reset()

    def reset(self):
        self.value = torch.zeros((self.num_classes, self.num_classes),
                                 dtype=torch.int64)

    def update(self, pred, true):
        pred = torch.as_tensor(pred).reshape(-1).to("cpu", torch.int64)
        true = torch.as_tensor(true).reshape(-1).to("cpu", torch.int64)
        v = self.virtual_num_classes
        if self.ignore_index is not None:
            keep = true != self.ignore_index
            pred = torch.where(keep, pred, v - 1)
            true = torch.where(keep, true, v - 1)
        bins = torch.bincount(true * v + pred, minlength=v * v).reshape(v, v)
        self.value += bins[:self.num_classes, :self.num_classes]

    @property
    def tp(self):
        return torch.diag(self.value)

    @property
    def count(self):
        return self.value.sum(dim=1)

    @property
    def union(self):
        return (self.value.sum(dim=0) + self.value.sum(dim=1)
                - torch.diag(self.value))

    def all_acc(self):
        return self.cal_acc(self.tp, self.count)

    @staticmethod
    def cal_acc(tp, count):
        """``(mean class accuracy, overall accuracy, per-class accuracies)``
        in percent, in float64."""
        tp = torch.as_tensor(tp, dtype=torch.float64)
        count = torch.as_tensor(count, dtype=torch.float64)
        acc_per_cls = tp / torch.clamp(count, min=1) * 100.0
        over_all_acc = tp.sum() / max(float(count.sum()), 1) * 100.0
        return float(acc_per_cls.mean()), float(over_all_acc), acc_per_cls


def get_mious(tp, union, count):
    """``(mIoU, mAcc, OA, per-class IoUs, per-class accuracies)`` in percent
    (parity: metrics.py get_mious): a class with no points and no
    predictions counts 100 (``(0 + 1e-10) / (0 + 1e-10)``), as in the JAX
    package and the reference."""
    tp = np.asarray(tp, dtype=np.float64)
    union = np.asarray(union, dtype=np.float64)
    count = np.asarray(count, dtype=np.float64)
    iou_per_cls = (tp + 1e-10) / (union + 1e-10) * 100.0
    acc_per_cls = (tp + 1e-10) / (count + 1e-10) * 100.0
    over_all_acc = tp.sum() / count.sum() * 100.0
    return (float(iou_per_cls.mean()), float(acc_per_cls.mean()),
            float(over_all_acc), iou_per_cls, acc_per_cls)
