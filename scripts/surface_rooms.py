"""Seeded rooms of surfaces, the shape of S3DIS crops, for timing and
checking the S3DIS path without its data.

``datasets.s3dis.SyntheticScene`` fills its room's volume; a real crop is
surfaces, which is what FPS's pruning (kernel row 1) and the stage-1
features' mean see. ``chip_smoke.py``, ``scripts/torch_fps_knn_timing.py``
and the port's tests make such crops with :func:`surface_room`; nothing of
the package reads it. numpy only.
"""
from __future__ import annotations

import numpy as np


def surface_room(n: int, rng: np.random.Generator, tables: int = 3,
                 jitter: float = 0.003):
    """``n`` points on the surfaces of a 4 x 4 x 3 m room (floor, ceiling,
    four walls and ``tables`` table tops 0.75 m high), each surface's share
    of the points its share of the area, with ``jitter`` m of gaussian
    noise along its normal; each surface gets a base colour in 0-255 and
    every point a spread of +-40 around it. Returns (pos (n, 3), rgb (n, 3))
    float32."""
    # (axis of the normal, its coordinate, (lo, hi) of the two others)
    planes = [(2, 0.0, (0, 4), (0, 4)), (2, 3.0, (0, 4), (0, 4)),
              (0, 0.0, (0, 4), (0, 3)), (0, 4.0, (0, 4), (0, 3)),
              (1, 0.0, (0, 4), (0, 3)), (1, 4.0, (0, 4), (0, 3))]
    for _ in range(tables):
        x0, y0 = rng.uniform(0.2, 2.6, 2)
        planes.append((2, 0.75, (x0, x0 + 1.2), (y0, y0 + 0.8)))
    area = np.array([(a[1] - a[0]) * (b[1] - b[0]) for _, _, a, b in planes])
    which = rng.choice(len(planes), size=n, p=area / area.sum())
    base = rng.uniform(0, 255, (len(planes), 3))
    pos = np.empty((n, 3))
    for k, (axis, at, (a0, a1), (b0, b1)) in enumerate(planes):
        sel = which == k
        m = int(sel.sum())
        other = [ax for ax in range(3) if ax != axis]
        pos[sel, axis] = at + rng.normal(0.0, jitter, m)
        pos[sel, other[0]] = rng.uniform(a0, a1, m)
        pos[sel, other[1]] = rng.uniform(b0, b1, m)
    rgb = np.clip(base[which] + rng.uniform(-40, 40, (n, 3)), 0, 255)
    return pos.astype(np.float32), rgb.astype(np.float32)
