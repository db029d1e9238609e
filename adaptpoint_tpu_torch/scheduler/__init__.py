"""Epoch learning-rate schedules as plain functions ``epoch -> lr``.

The port's own copy of ``adaptpoint_tpu/scheduler/__init__.py`` (pure
Python there too): cosine (``t_max``, ``min_lr``, warm-up), step, multistep,
poly, tanh, a constant fallback, and the stateful reduce-on-plateau
scheduler. The engine evaluates ``lr_fn(epoch - 1)`` at the start of each
epoch, which is timm's ``scheduler.step(epoch)`` at the end of the one
before.
"""
from __future__ import annotations

import math
from typing import Callable

__all__ = ["build_scheduler_from_cfg", "PlateauScheduler"]


class PlateauScheduler:
    """Reduce the lr by ``decay_rate`` when the recorded metric has not
    improved (relative ``threshold``) for more than ``patience_t`` epochs,
    with a cool-down and a linear warm-up. The engine calls
    ``record(metric)`` after each eval, then ``lr_fn(epoch)`` at the next
    epoch's start. ``mode='max'`` for accuracies, ``'min'`` for losses."""

    def __init__(self, lr, decay_rate=0.1, patience_t=10, threshold=1e-4,
                 cooldown_t=0, warmup_t=0, warmup_lr=1e-6, min_lr=0.0,
                 mode="max"):
        self.lr = lr
        self.decay_rate = decay_rate
        self.patience_t = patience_t
        self.threshold = threshold
        self.cooldown_t = cooldown_t
        self.warmup_t = warmup_t
        self.warmup_lr = warmup_lr
        self.min_lr = min_lr
        self.mode = mode
        self.best = -math.inf if mode == "max" else math.inf
        self.num_bad = 0
        self.cooldown = 0
        self.cur_lr = lr

    def _is_better(self, metric):
        if self.mode == "max":
            return metric > self.best * (1.0 + self.threshold) if self.best > 0 \
                else metric > self.best + self.threshold
        return metric < self.best * (1.0 - self.threshold) if self.best > 0 \
            else metric < self.best - self.threshold

    def record(self, metric):
        metric = float(metric)
        if self._is_better(metric):
            self.best = metric
            self.num_bad = 0
        elif self.cooldown > 0:
            self.cooldown -= 1
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience_t:
                self.cur_lr = max(self.cur_lr * self.decay_rate, self.min_lr)
                self.cooldown = self.cooldown_t
                self.num_bad = 0

    def state_dict(self):
        return {"best": self.best, "num_bad": self.num_bad,
                "cooldown": self.cooldown, "cur_lr": self.cur_lr}

    def load_state_dict(self, d):
        self.__dict__.update({k: d[k] for k in
                              ("best", "num_bad", "cooldown", "cur_lr")
                              if k in d})

    def __call__(self, t: int) -> float:
        if self.warmup_t and t <= self.warmup_t:
            return self.warmup_lr + (self.lr - self.warmup_lr) * t / self.warmup_t
        return self.cur_lr


def build_scheduler_from_cfg(cfg) -> Callable[[int], float]:
    sched = cfg.get("sched", "cosine")
    lr = cfg.lr
    epochs = cfg.epochs
    warmup_t = cfg.get("warmup_epochs", 0)
    warmup_lr = cfg.get("warmup_lr", 1e-6)
    min_lr = cfg.get("min_lr", None) or lr / 1000.0
    t_max = cfg.get("t_max", epochs)
    decay_rate = cfg.get("decay_rate", None) or cfg.get(
        "final_decay_rate", 0.01) ** (1.0 / epochs)
    decay_epochs = cfg.get("decay_epochs", 1)

    def warmup(t: int) -> float:
        # linear from warmup_lr to lr over warmup_t epochs
        return warmup_lr + (lr - warmup_lr) * t / max(warmup_t, 1)

    def cosine(t: int) -> float:
        if warmup_t and t < warmup_t:
            return warmup(t)
        if t >= t_max:
            return min_lr  # past the single cycle
        return min_lr + 0.5 * (lr - min_lr) * (1 + math.cos(math.pi * t / t_max))

    def tanh(t: int) -> float:
        if warmup_t and t < warmup_t:
            return warmup(t)
        if t >= epochs:
            return min_lr
        lb, ub = -6.0, 4.0
        tr = t / epochs
        return min_lr + 0.5 * (lr - min_lr) * (1 - math.tanh(lb + (ub - lb) * tr))

    def step(t: int) -> float:
        if warmup_t and t < warmup_t:
            return warmup(t)
        return lr * (decay_rate ** (t // decay_epochs))

    def multistep(t: int) -> float:
        if warmup_t and t < warmup_t:
            return warmup(t)
        milestones = decay_epochs if isinstance(decay_epochs, (list, tuple)) \
            else [decay_epochs]
        k = sum(1 for m in milestones if t >= m)
        return lr * (decay_rate ** k)

    def poly(t: int) -> float:
        if warmup_t and t < warmup_t:
            return warmup(t)
        if t >= epochs:
            return min_lr
        power = cfg.get("decay_rate", None) or 1.0
        return min_lr + (lr - min_lr) * (1 - t / epochs) ** power

    def constant(t: int) -> float:
        return lr

    if sched == "plateau":
        mode = "min" if "loss" in str(cfg.get("eval_metric", "")) else "max"
        return PlateauScheduler(
            lr, decay_rate=cfg.get("decay_rate", 0.1),
            patience_t=cfg.get("patience_epochs", 10),
            warmup_t=warmup_t, warmup_lr=warmup_lr, min_lr=min_lr, mode=mode)

    table = {"cosine": cosine, "tanh": tanh, "step": step,
             "multistep": multistep, "poly": poly, "constant": constant,
             None: constant}
    if sched not in table:
        raise ValueError(f"unsupported sched {sched}")
    return table[sched]
