"""Part-segmentation metrics and kNN label refinement, host-side numpy.

Counterpart of ``adaptpoint_tpu/utils/partseg.py`` (reference
examples/shapenetpart/main.py:40-98). Both run on one batch's predictions
after they came back from the device, as the reference's do.
"""
from __future__ import annotations

from collections import Counter
from typing import List, Sequence

import numpy as np

__all__ = ["get_ins_mious", "part_seg_refinement"]


def get_ins_mious(pred: np.ndarray, target: np.ndarray, cls: np.ndarray,
                  cls2parts: Sequence[Sequence[int]],
                  multihead: bool = False) -> List[float]:
    """Each shape's mean IoU (in %) over its own category's parts; a part
    absent from both the prediction and the target counts 100."""
    ins_mious = []
    for i in range(pred.shape[0]):
        parts = cls2parts[int(cls[i])]
        if multihead:
            parts = np.arange(len(parts))
        part_ious = []
        for part in parts:
            pred_part = pred[i] == part
            target_part = target[i] == part
            u = np.logical_or(pred_part, target_part).sum()
            if u == 0:
                iou = 100.0
            else:
                iou = np.logical_and(pred_part, target_part).sum() * 100.0 / u
            part_ious.append(iou)
        ins_mious.append(float(np.mean(part_ious)))
    return ins_mious


def part_seg_refinement(pred: np.ndarray, pos: np.ndarray, cls: np.ndarray,
                        cls2parts: Sequence[Sequence[int]], n: int = 10
                        ) -> np.ndarray:
    """A copy of ``pred`` (B, N) in which every label predicted on fewer than
    ``n`` points of a shape, or outside the shape's category, is replaced
    point by point by the majority label of the point's ``n + 1`` nearest
    neighbours (the label itself excluded)."""
    pred = pred.copy()
    num_labels = cls2parts[-1][-1] + 1
    for s in range(pred.shape[0]):
        parts = set(int(p) for p in cls2parts[int(cls[s])])
        counter = Counter(pred[s].tolist())
        if len(counter) <= 1:
            continue
        for lbl, cnt in list(counter.items()):
            if cnt < n or int(lbl) not in parts:
                less_idx = np.nonzero(pred[s] == lbl)[0]
                if len(less_idx) == 0:
                    continue
                d2 = (((pos[s][less_idx][:, None, :] - pos[s][None, :, :])
                       ** 2).sum(-1))
                knn_idx = np.argsort(d2, axis=1)[:, : n + 1]
                neighbor_lbl = pred[s][knn_idx]  # (m, n + 1)
                counts = np.apply_along_axis(
                    lambda r: np.bincount(r, minlength=num_labels), 1,
                    neighbor_lbl)
                counts[:, lbl] = 0
                pred[s][less_idx] = counts.argmax(axis=1)
    return pred
