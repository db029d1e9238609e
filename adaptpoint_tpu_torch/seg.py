"""The port's scene-segmentation command line, with the interface of the JAX
package's ``examples/segmentation/main.py``:

    python -m adaptpoint_tpu_torch.seg --cfg cfgs/s3dis/pointnext-b.yaml [k=v ...] [--device cpu]

The cfg and its overrides, the run directory (the checkpoint's is reused
for ``mode=test``/``val``/``resume``) and the dumped cfg are those of
``adaptpoint_tpu_torch.main``; the experiment is named from the cfg's path
alone, as the JAX package's scene-segmentation CLI names it. Modes
``train``, ``val``, ``test``, ``resume`` and ``test_6fold`` (one checkpoint
an area: ``pretrained_path`` a format string with ``{area}``) run
``engine.seg_main``, on voxel crops (``S3DIS``) or on spheres
(``S3DISSphere``, ``cfgs/s3dis/pointnext-s_sphere.yaml``). Runs on the card
unless ``--device cpu`` is given; without a card it raises. The last line
printed is the run's kernel launch counts as one JSON object.
"""
from __future__ import annotations

import sys

from .main import parse_cfg, prepare_run, run_and_report

__all__ = ["main"]


def main(argv=None):
    args, opts, cfg = parse_cfg(
        argv, "S3DIS scene segmentation (PyTorch port)")
    from .engine.seg_main import MODES, main as run
    mode = cfg.get("mode", "train")
    if mode not in MODES:
        raise ValueError(f"unknown scene-segmentation mode {mode}")
    prepare_run(cfg, args.cfg, opts, tag_overrides=False)
    return run_and_report(run, cfg, args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
