"""Furthest point sampling: the CUDA kernel ``csrc/fps.cu`` and its plain version.

Replaces ``adaptpoint_tpu/ops/pallas/fps.py`` ``furthest_point_sample_pallas``
(``_fps_kernel``). Bound on the H100: latency -- npoint-1 dependent
block-wide argmax reductions, one block per cloud, so only B of 132 SMs work.
The design gives each thread consecutive points, their coordinates and
running minima in registers, one barrier a step, and warp reductions by
``redux.sync`` with the winner's coordinates carried in the partials;
:func:`fps_tiling` picks the block size by N. Past 16384 points a cloud
takes a cluster of four blocks of 1024 threads, each holding a quarter of
the cloud, which exchange each step's partials through distributed shared
memory (4096 threads a cloud in :data:`FPS_INSTANCES`; clusters of two and
eight blocks timed slower). See the source's note.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from . import _build
from .geometry import furthest_point_sample as furthest_point_sample_plain

__all__ = ["furthest_point_sample_cuda", "furthest_point_sample_plain",
           "fps_tiling", "FpsTiling", "FPS_INSTANCES", "FPS_CLUSTER_DESIGNS",
           "FPS_MAX_POINTS", "LAUNCHES"]

LAUNCHES = 0  # kernel launches of furthest_point_sample_cuda

# the kernel's instances (csrc/fps.cu fps_launch): threads a cloud, points
# a thread; 4096 threads are a cluster of four blocks of 1024
FPS_INSTANCES = ((512, 1), (512, 2), (512, 4), (1024, 4), (1024, 8),
                 (1024, 16), (4096, 6), (4096, 8))
# every cluster instance the kernel compiles (clusters of 2, 4 and 8 blocks
# of 1024 threads), for timing them against each other (``tiling=``)
FPS_CLUSTER_DESIGNS = ((2048, 12), (2048, 16), (4096, 6), (4096, 8),
                       (8192, 3), (8192, 4))
FPS_MAX_POINTS = 32768  # csrc/fps.cu fps_max_points()
# one block of 1024 threads holds a cloud up to this N (its coordinates in
# shared memory, its minima in registers)
_FPS_ONE_BLOCK_UP_TO = 16384
# the block size: 512 threads up to this N, then 1024 (at 1024 and 2048
# points the block size moved a step by a few percent at most: PERF.md)
_FPS_512_UP_TO = 2048


class FpsTiling(NamedTuple):
    """Threads a cloud and points a thread (``threads * per_thread >= N``)."""
    threads: int
    per_thread: int


def fps_tiling(n: int) -> FpsTiling:
    """The launch shape for clouds of ``n`` points: 512 threads up to 2048
    points, 1024 up to 16384, else 4096 (four blocks of 1024); points a
    thread the fewest of the kernel's instances (:data:`FPS_INSTANCES`) that
    cover n. Raises ValueError outside 1 <= n <= FPS_MAX_POINTS."""
    if not 1 <= n <= FPS_MAX_POINTS:
        raise ValueError(f"the FPS kernel takes 1 <= N <= {FPS_MAX_POINTS}, "
                         f"got N={n}")
    threads = (512 if n <= _FPS_512_UP_TO
               else 1024 if n <= _FPS_ONE_BLOCK_UP_TO else 4096)
    return FpsTiling(threads, min(p for t, p in FPS_INSTANCES
                                  if t == threads and t * p >= n))


@functools.cache
def _lib():
    lib = _build.load("fps")
    i = ctypes.c_int
    lib.fps_launch.argtypes = [ctypes.c_void_p, i, i, i, i, i,
                               ctypes.c_void_p, ctypes.c_void_p]
    lib.fps_launch.restype = ctypes.c_int
    lib.fps_max_points.argtypes = []
    lib.fps_max_points.restype = ctypes.c_int
    return lib


def furthest_point_sample_cuda(xyz: torch.Tensor, npoint: int,
                               tiling: Optional[FpsTiling] = None
                               ) -> torch.Tensor:
    """xyz (B, N, 3) f32 contiguous CUDA -> idx (B, npoint) int32.
    ``tiling`` forces one of the kernel's instances (:data:`FPS_INSTANCES`,
    :data:`FPS_CLUSTER_DESIGNS`) in place of :func:`fps_tiling`'s."""
    global LAUNCHES
    if xyz.device.type != "cuda":
        raise ValueError(f"the FPS kernel needs a CUDA tensor, got {xyz.device}")
    if xyz.dtype != torch.float32 or xyz.dim() != 3 or xyz.shape[2] != 3:
        raise ValueError(f"xyz must be (B, N, 3) float32, got "
                         f"{tuple(xyz.shape)} {xyz.dtype}")
    if not xyz.is_contiguous():
        raise ValueError("xyz must be contiguous")
    B, N, _ = xyz.shape
    if npoint < 1 or B < 1 or N < 1:
        raise ValueError(f"empty FPS: B={B} N={N} npoint={npoint}")
    _build.check_int32("fps", xyz=B * N * 3, idx=B * npoint)
    tl = fps_tiling(N) if tiling is None else FpsTiling(*tiling)
    if tiling is not None and (
            tuple(tl) not in FPS_INSTANCES + FPS_CLUSTER_DESIGNS
            or tl.threads * tl.per_thread < N):
        raise ValueError(f"no FPS instance {tuple(tl)} for N={N}")
    lib = _lib()
    idx = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    stream = torch.cuda.current_stream(xyz.device).cuda_stream
    err = lib.fps_launch(xyz.data_ptr(), B, N, npoint, tl.threads,
                         tl.per_thread, idx.data_ptr(), stream)
    _build.check(lib, err, "fps")
    LAUNCHES += 1
    return idx
