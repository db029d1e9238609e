"""The port's command line, with the interface of the JAX package's
``examples/classification/main.py``:

    python -m adaptpoint_tpu_torch.main --cfg cfgs/scanobjectnn/pointnext-s.yaml [k=v ...] [--device cpu]

The cfg loads recursively, ``k=v`` pairs override it, the experiment's name
comes from the cfg's path and the overrides, the run directory is made (or,
for ``mode=test``/``val``/``resume`` and for ``resume=True`` with
``pretrained_path``, the checkpoint's is reused) and the cfg is dumped into
it. Runs on the card unless ``--device cpu`` is given; without a card it
raises. As the JAX package's ``examples/classification/main.py`` dispatches
them: modes ``train``, ``test``, ``val``, ``resume`` and ``finetune`` run
``engine.cls_main``, ``adaptpoint`` and ``adaptpoint_modelnet``
``engine.adapt_main``, ``scanobjectnnc`` and ``modelnetc``
``engine.corrupt_main``; ``pretrain`` is not ported yet and raises. The
last line printed is the run's kernel launch counts as one JSON object.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import random
import sys

from .utils import EasyConfig
from .utils.logger import (generate_exp_directory, resume_exp_directory,
                           setup_logger)

__all__ = ["main", "parse_cfg", "prepare_run", "run_and_report"]

NOT_PORTED = ("pretrain",)
CLS_MODES = ("train", "test", "val", "resume", "finetune")
ADAPT_MODES = ("adaptpoint", "adaptpoint_modelnet")
CORRUPT_MODES = ("scanobjectnnc", "modelnetc")


def parse_cfg(argv, description: str):
    """``(args, opts, cfg)``: ``--cfg`` loaded recursively with the
    ``k=v`` overrides in ``opts`` applied; ``args.device`` is ``--device``."""
    parser = argparse.ArgumentParser(description)
    parser.add_argument("--cfg", type=str, required=True)
    parser.add_argument("--device", default=None,
                        help="'cpu' for the plain versions on the CPU "
                             "(default: the card)")
    args, opts = parser.parse_known_args(argv)
    cfg = EasyConfig()
    cfg.load(args.cfg, recursive=True)
    cfg.update_opts(opts)
    return args, opts, cfg


def prepare_run(cfg, cfg_path: str, opts, tag_overrides: bool = True
                ) -> None:
    """Draw a seed where the cfg has none, name the experiment from the
    cfg's path (and the overrides, with ``tag_overrides``), make the run
    directory (or reuse the
    checkpoint's for ``mode=test``/``val``/``resume`` and for
    ``resume=True`` with ``pretrained_path``), start the log and dump the
    cfg into the directory (``cfg_<mode>.yaml`` in a reused one, whose
    ``cfg.yaml`` stays the training run's)."""
    mode = cfg.get("mode", "train")
    if cfg.get("seed") is None:
        cfg.seed = random.randint(1, 10000)
    # the experiment's name from the cfg's path (reference main.py:30-51)
    cfg.task_name = os.path.basename(os.path.dirname(cfg_path))
    cfg.cfg_basename = os.path.splitext(os.path.basename(cfg_path))[0]
    tags = [cfg.task_name, cfg.cfg_basename]
    for opt in opts if tag_overrides else ():
        if "=" in opt and "path" not in opt and "dir" not in opt \
                and "/" not in opt:
            tags.append(opt.replace("=", "_"))
    cfg.exp_name = "-".join(tags)
    # evaluating or continuing a checkpoint reuses its run directory
    # (reference main.py:46-48)
    reused = (mode in ("test", "val", "resume") or cfg.get("resume")) \
        and cfg.get("pretrained_path")
    if reused:
        resume_exp_directory(cfg, cfg.pretrained_path)
    else:
        generate_exp_directory(cfg, exp_name=cfg.exp_name)
    setup_logger(cfg.log_path)
    cfg.dump(os.path.join(
        cfg.run_dir, (f"cfg_{'resume' if cfg.get('resume') else mode}.yaml"
                      if reused else "cfg.yaml")))
    logging.info("run dir: %s", cfg.run_dir)


def run_and_report(run, cfg, device):
    """``run(cfg, device=device)``, then the run's kernel launch counts as
    one JSON object on the last line of standard output."""
    from . import ops
    result = run(cfg, device=device)
    print(json.dumps({"launch_counts": ops.launch_counts()}), flush=True)
    return result


def main(argv=None):
    args, opts, cfg = parse_cfg(argv,
                                "point-cloud classification (PyTorch port)")
    mode = cfg.get("mode", "train")
    if mode in NOT_PORTED:
        raise NotImplementedError(f"mode {mode} is not ported yet")
    if mode not in CLS_MODES + ADAPT_MODES + CORRUPT_MODES:
        raise ValueError(f"unknown mode {mode}")
    prepare_run(cfg, args.cfg, opts)
    if mode in ADAPT_MODES:
        from .engine.adapt_main import main as run
    elif mode in CORRUPT_MODES:
        from .engine.corrupt_main import main as run
    else:
        from .engine.cls_main import main as run
    return run_and_report(run, cfg, args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
