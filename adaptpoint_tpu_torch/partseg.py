"""The port's part-segmentation command line, with the interface of the JAX
package's ``examples/shapenetpart/main.py``:

    python -m adaptpoint_tpu_torch.partseg --cfg cfgs/shapenetpart/pointnext-s.yaml [k=v ...] [--device cpu]

The cfg and its overrides, the run directory (the checkpoint's is reused
for ``mode=test``/``val``/``resume`` and for ``resume=True`` with
``pretrained_path``) and the dumped cfg are those of
``adaptpoint_tpu_torch.main``; the experiment is named from the cfg's path
alone, as the JAX package's part-segmentation CLI names it. Modes
``train``, ``test``, ``val``, ``resume`` and ``adaptpoint`` run
``engine.partseg_main``. Runs on the card
unless ``--device cpu`` is given; without a card it raises. The last line
printed is the run's kernel launch counts as one JSON object.
"""
from __future__ import annotations

import sys

from .main import parse_cfg, prepare_run, run_and_report

__all__ = ["main"]


def main(argv=None):
    args, opts, cfg = parse_cfg(
        argv, "ShapeNetPart part segmentation (PyTorch port)")
    from .engine.partseg_main import MODES, main as run
    mode = cfg.get("mode", "train")
    if mode not in MODES:
        raise ValueError(f"unknown part-segmentation mode {mode}")
    prepare_run(cfg, args.cfg, opts, tag_overrides=False)
    return run_and_report(run, cfg, args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
