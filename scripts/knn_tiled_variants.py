#!/usr/bin/env python3
"""Make variants of the tiled kNN kernel (``knn_tiled_kernel`` in
``adaptpoint_tpu_torch/ops/csrc/knn.cu``), one piece taken out or changed,
to be timed beside the tree's own by ``scripts/torch_fps_knn_timing.py``:

    python3 scripts/knn_tiled_variants.py build/knn_variants
    python3 scripts/torch_fps_knn_timing.py --parts knn_tiled --roots . \\
        --unchecked build/knn_variants/*

Each variant is a copy of this checkout's ``adaptpoint_tpu_torch`` under
``OUT/<name>/`` (so it builds into ``OUT/<name>/build/``) whose ``knn.cu``
differs by the edits in VARIANTS, each an exact replacement of a line that
must appear once. Variants that drop work give wrong indices, so they are
timed only (``--unchecked``), and their time is a split of the kernel's:

- ``no_selection``: the tile's distances are written to shared memory and
  no list is kept (the products, the ring and the norms alone);
- ``first_tile_merge``: the list is built from the first tile only, later
  tiles' distances are written and not read;
- ``filter_only``: every row of 32 is compared with the list's k-th entry,
  and nothing is inserted;
- ``stages3_chunk32``, ``stages4_chunk32``, ``chunk32``: the ring with 3 or
  4 stages of 32 channels, or 2 of 32, in place of 2 of 64;
- ``stages3``: 3 stages of 64 channels (one block an SM: 120.5 KB).
"""
import argparse
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KNN_CU = Path("adaptpoint_tpu_torch/ops/csrc/knn.cu")

_BASE = "    const int base = tile * kTP;\n    const int n = min(kTP, N - base);\n"
VARIANTS = {
    "no_selection": [(_BASE, "    if (tile >= 0) continue;  // variant\n"
                      + _BASE)],
    "first_tile_merge": [(_BASE, "    if (tile > 0) continue;  // variant\n"
                          + _BASE)],
    # the ballot stays (its mask is read), the insertions never run
    "filter_only": [("        while (mask) {\n",
                     "        while (mask == 0x5a5a5a5au) {  // variant\n")],
    "chunk32": [("constexpr int kCK = 64; ", "constexpr int kCK = 32; ")],
    "stages3_chunk32": [("constexpr int kCK = 64; ", "constexpr int kCK = 32; "),
                        ("constexpr int kStages = 2; ",
                         "constexpr int kStages = 3; ")],
    "stages4_chunk32": [("constexpr int kCK = 64; ", "constexpr int kCK = 32; "),
                        ("constexpr int kStages = 2; ",
                         "constexpr int kStages = 4; ")],
    "stages3": [("constexpr int kStages = 2; ", "constexpr int kStages = 3; ")],
}


def make(out: Path, name: str) -> Path:
    """Writes variant ``name`` under ``out`` and returns its root."""
    src = (ROOT / KNN_CU).read_text()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise ValueError(f"variant {name}: {old!r} appears "
                             f"{src.count(old)} times in {KNN_CU}")
        src = src.replace(old, new)
    root = out / name
    if root.exists():
        shutil.rmtree(root)
    shutil.copytree(ROOT / "adaptpoint_tpu_torch", root / "adaptpoint_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / KNN_CU).write_text(src)
    return root


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", help="directory the variants are written under")
    ap.add_argument("names", nargs="*", default=list(VARIANTS),
                    help=f"variants to make (all by default): "
                         f"{', '.join(VARIANTS)}")
    args = ap.parse_args(argv)
    for name in args.names:
        print(make(Path(args.out), name))
    return 0


if __name__ == "__main__":
    sys.exit(main())
