"""Scalar summaries of a run: ``scalars.jsonl`` in the run directory, and
TensorBoard events as well where ``torch.utils.tensorboard`` imports.
``train_iter_num`` counts the steps of phase A over the whole run, the step
its per-iteration scalars are written at.

Counterpart of ``adaptpoint_tpu/metricslog.py`` ``Summary`` (reference
openpoints/utils/utils_summary.py:8-43).
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional

__all__ = ["Summary"]


class Summary:
    def __init__(self, log_dir: Optional[str]):
        self.log_dir = log_dir
        self.train_iter_num = 0
        self._jsonl = None
        self._tb = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(log_dir=log_dir)
            except Exception:  # tensorboard is optional
                self._tb = None

    def summary_train_iter_num_update(self) -> None:
        self.train_iter_num += 1

    def add_scalar(self, tag: str, value, step: int) -> None:
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(
                {"t": time.time(), "tag": tag, "value": float(value),
                 "step": int(step)}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def flush(self) -> None:
        if self._jsonl is not None:
            self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
