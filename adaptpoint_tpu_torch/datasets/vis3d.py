"""Point-cloud visualisation and OBJ export.

Counterpart of ``adaptpoint_tpu/datasets/vis3d.py`` (reference
openpoints/dataset/vis3d.py:27-160: vis_points, vis_multi_points, write_obj,
read_obj). ``write_obj`` / ``read_obj`` write and read the same text as the
JAX package's. The reference renders with pyvista; here ``vis_*`` render a
matplotlib 3D scatter to PNG where matplotlib is installed and do nothing
(with a warning) where it is not.
"""
from __future__ import annotations

import logging

import numpy as np

__all__ = ["vis_points", "vis_multi_points", "write_obj", "read_obj"]


def write_obj(points: np.ndarray, colors: np.ndarray, out_filename: str):
    """Vertex-colored OBJ (parity: vis3d.py:142-148)."""
    points = np.asarray(points)
    colors = np.asarray(colors)
    with open(out_filename, "w") as f:
        for p, c in zip(points, colors):
            f.write("v %f %f %f %f %f %f\n"
                    % (p[0], p[1], p[2], c[0], c[1], c[2]))


def read_obj(filename: str):
    """parity: vis3d.py:151-153."""
    values = np.loadtxt(filename, usecols=(1, 2, 3, 4, 5, 6))
    return values[:, :3], values[:, 3:6]


def _scatter(ax, points, colors, labels, color_map, point_size):
    points = np.asarray(points)
    kw = {"s": point_size}
    if colors is not None:
        kw["c"] = np.clip(np.asarray(colors, np.float64), 0, 1)
    elif labels is not None:
        kw["c"] = np.asarray(labels)
        kw["cmap"] = color_map
    ax.scatter(points[:, 0], points[:, 1], points[:, 2], **kw)
    ax.set_axis_off()


def vis_points(points, colors=None, labels=None, color_map="Paired",
               opacity=1.0, point_size=5.0, out_file="points.png"):
    """Render one cloud to PNG (headless stand-in for vis3d.py:27-59)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        logging.warning("matplotlib unavailable; vis_points skipped")
        return None
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(projection="3d")
    _scatter(ax, points, colors, labels, color_map, point_size)
    fig.savefig(out_file, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_file


def vis_multi_points(points_list, colors=None, labels=None,
                     color_map="Paired", point_size=5.0,
                     out_file="points_multi.png"):
    """Render several clouds side by side (stand-in for vis3d.py:62-139)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        logging.warning("matplotlib unavailable; vis_multi_points skipped")
        return None
    n = len(points_list)
    fig = plt.figure(figsize=(6 * n, 6))
    for i, pts in enumerate(points_list):
        ax = fig.add_subplot(1, n, i + 1, projection="3d")
        c = colors[i] if colors is not None else None
        lab = labels[i] if labels is not None else None
        _scatter(ax, pts, c, lab, color_map, point_size)
    fig.savefig(out_file, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_file
