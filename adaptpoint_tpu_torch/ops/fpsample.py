"""Furthest point sampling: the CUDA kernel ``csrc/fps.cu`` and its plain version.

Replaces ``adaptpoint_tpu/ops/pallas/fps.py`` ``furthest_point_sample_pallas``
(``_fps_kernel``). Bound on the H100: latency -- npoint-1 dependent
block-wide argmax reductions, one block per cloud, so only B of 132 SMs work.
The design gives each thread consecutive points, their coordinates and
running minima in registers, one barrier a step, and warp reductions by
``redux.sync`` with the winner's coordinates carried in the partials;
:func:`fps_tiling` picks the block size by N. See the source's note.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build
from .geometry import furthest_point_sample as furthest_point_sample_plain

__all__ = ["furthest_point_sample_cuda", "furthest_point_sample_plain",
           "fps_tiling", "FpsTiling", "FPS_INSTANCES", "FPS_MAX_POINTS",
           "LAUNCHES"]

LAUNCHES = 0  # kernel launches of furthest_point_sample_cuda

# the kernel's instances (csrc/fps.cu fps_launch): threads a cloud, points
# a thread
FPS_INSTANCES = ((512, 1), (512, 2), (512, 4), (1024, 4), (1024, 8),
                 (1024, 16))
FPS_MAX_POINTS = 16384  # csrc/fps.cu fps_max_points()
# the block size: 512 threads up to this N, then 1024 (at 1024 and 2048
# points the block size moved a step by a few percent at most: PERF.md)
_FPS_512_UP_TO = 2048


class FpsTiling(NamedTuple):
    """Threads a cloud and points a thread (``threads * per_thread >= N``)."""
    threads: int
    per_thread: int


def fps_tiling(n: int) -> FpsTiling:
    """The launch shape for clouds of ``n`` points: 512 threads up to 2048
    points, else 1024; points a thread the fewest of the kernel's instances
    (:data:`FPS_INSTANCES`) that cover n. Raises ValueError outside
    1 <= n <= FPS_MAX_POINTS."""
    if not 1 <= n <= FPS_MAX_POINTS:
        raise ValueError(f"the FPS kernel takes 1 <= N <= {FPS_MAX_POINTS}, "
                         f"got N={n}")
    threads = 512 if n <= _FPS_512_UP_TO else 1024
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


def furthest_point_sample_cuda(xyz: torch.Tensor,
                               npoint: int) -> torch.Tensor:
    """xyz (B, N, 3) f32 contiguous CUDA -> idx (B, npoint) int32."""
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
    tl = fps_tiling(N)
    lib = _lib()
    idx = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    stream = torch.cuda.current_stream(xyz.device).cuda_stream
    err = lib.fps_launch(xyz.data_ptr(), B, N, npoint, tl.threads,
                         tl.per_thread, idx.data_ptr(), stream)
    _build.check(lib, err, "fps")
    LAUNCHES += 1
    return idx
