"""Host (CPU) ops of the scene pipeline: the kd-tree and grid subsampling,
C++ compiled by ``g++`` at first use (``ops._build.load_host``).
Counterpart of ``adaptpoint_tpu/ops/cpu``."""
from .grid_subsample import grid_subsample, grid_subsample_plain
from .kdtree_knn import (KDTree, kdtree_knn, knn_plain, knn_search,
                         query_radius_plain)

__all__ = ["KDTree", "kdtree_knn", "knn_search", "knn_plain",
           "query_radius_plain", "grid_subsample", "grid_subsample_plain"]
