"""The port's command line, with the interface of the JAX package's
``examples/classification/main.py``:

    python -m adaptpoint_tpu_torch.main --cfg cfgs/scanobjectnn/pointnext-s.yaml [k=v ...] [--device cpu]

The cfg loads recursively, ``k=v`` pairs override it, the experiment's name
comes from the cfg's path and the overrides, the run directory is made (or,
for ``mode=test``/``val`` with ``pretrained_path``, reused) and the cfg is
dumped into it. Runs on the card unless ``--device cpu`` is given; without a
card it raises. Modes ``train``, ``test`` and ``val`` run
``engine.cls_main``, ``adaptpoint`` runs ``engine.adapt_main`` (as the JAX
package's ``examples/classification/main.py`` dispatches them, with
``adaptpoint_modelnet``, which ``adapt_main`` refuses for now); the others
are not ported yet and raise. The last line printed is the run's kernel
launch counts as one JSON object.
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

__all__ = ["main"]

NOT_PORTED = ("resume", "finetune", "scanobjectnnc", "modelnetc", "pretrain")


def main(argv=None):
    parser = argparse.ArgumentParser(
        "point-cloud classification (PyTorch port)")
    parser.add_argument("--cfg", type=str, required=True)
    parser.add_argument("--device", default=None,
                        help="'cpu' for the plain versions on the CPU "
                             "(default: the card)")
    args, opts = parser.parse_known_args(argv)
    cfg = EasyConfig()
    cfg.load(args.cfg, recursive=True)
    cfg.update_opts(opts)
    mode = cfg.get("mode", "train")
    if mode in NOT_PORTED:
        raise NotImplementedError(f"mode {mode} is not ported yet")
    if mode not in ("train", "test", "val", "adaptpoint",
                    "adaptpoint_modelnet"):
        raise ValueError(f"unknown mode {mode}")
    if cfg.get("seed") is None:
        cfg.seed = random.randint(1, 10000)

    # the experiment's name from the cfg's path (reference main.py:30-51)
    cfg.task_name = os.path.basename(os.path.dirname(args.cfg))
    cfg.cfg_basename = os.path.splitext(os.path.basename(args.cfg))[0]
    tags = [cfg.task_name, cfg.cfg_basename]
    for opt in opts:
        if "=" in opt and "path" not in opt and "dir" not in opt \
                and "/" not in opt:
            tags.append(opt.replace("=", "_"))
    cfg.exp_name = "-".join(tags)
    reused = mode in ("test", "val") and cfg.get("pretrained_path")
    if reused:
        resume_exp_directory(cfg, cfg.pretrained_path)
    else:
        generate_exp_directory(cfg, exp_name=cfg.exp_name)
    setup_logger(cfg.log_path)
    # a reused run directory keeps the training run's cfg.yaml
    cfg.dump(os.path.join(cfg.run_dir,
                          f"cfg_{mode}.yaml" if reused else "cfg.yaml"))
    logging.info("run dir: %s", cfg.run_dir)

    from . import ops
    if mode in ("adaptpoint", "adaptpoint_modelnet"):
        from .engine.adapt_main import main as run
    else:
        from .engine.cls_main import main as run
    result = run(cfg, device=args.device)
    print(json.dumps({"launch_counts": ops.launch_counts()}), flush=True)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
