"""Logging and run directories.

Counterpart of ``adaptpoint_tpu/utils/logger.py`` (reference
openpoints/utils/logger.py:38-137): console logging plus a ``log.txt`` per
run, and the run directory ``<root_dir>/<task_name>/<run_name>/`` with its
``checkpoint/`` subdirectory; ``resume_exp_directory`` reuses the directory
that holds a checkpoint.
"""
from __future__ import annotations

import logging
import os
import sys
import time
import uuid

__all__ = ["setup_logger", "generate_exp_directory", "resume_exp_directory"]


def setup_logger(log_path=None) -> logging.Logger:
    fmt = logging.Formatter("%(asctime)s [%(levelname)s] %(message)s")
    handlers = [logging.StreamHandler(sys.stdout)]
    if log_path is not None:
        handlers.append(logging.FileHandler(str(log_path)))
    root = logging.getLogger()
    root.setLevel(logging.INFO)
    for h in list(root.handlers):
        root.removeHandler(h)
    for h in handlers:
        h.setFormatter(fmt)
        root.addHandler(h)
    return root


def _set_paths(cfg, run_dir: str) -> str:
    cfg.run_dir = run_dir
    cfg.run_name = os.path.basename(run_dir)
    cfg.ckpt_dir = os.path.join(run_dir, "checkpoint")
    cfg.log_path = os.path.join(run_dir, "log.txt")
    cfg.csv_path = os.path.join(run_dir, f"{cfg.run_name}.csv")
    os.makedirs(cfg.ckpt_dir, exist_ok=True)
    return run_dir


def generate_exp_directory(cfg, exp_name=None, expid=None) -> str:
    """Create ``<root_dir>/<task_name>/<exp_name>-<time>-<id>/checkpoint``
    and set ``cfg.run_dir``, ``run_name``, ``ckpt_dir``, ``log_path`` and
    ``csv_path``."""
    expid = expid or (time.strftime("%Y%m%d-%H%M%S") + "-"
                      + uuid.uuid4().hex[:8])
    run_name = "-".join(x for x in (exp_name, expid) if x)
    return _set_paths(cfg, os.path.join(cfg.get("root_dir", "log"),
                                        cfg.get("task_name", ""), run_name))


def resume_exp_directory(cfg, pretrained_path: str) -> str:
    """The run directory that holds ``pretrained_path`` (in its
    ``checkpoint/`` subdirectory or directly)."""
    parent = os.path.dirname(pretrained_path)
    if os.path.basename(parent) == "checkpoint":
        parent = os.path.dirname(parent)
    return _set_paths(cfg, parent)
