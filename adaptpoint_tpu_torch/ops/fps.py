"""Furthest point sampling: the CUDA kernel ``csrc/fps.cu`` and its plain version.

Replaces ``adaptpoint_tpu/ops/pallas/fps.py`` ``furthest_point_sample_pallas``
(``_fps_kernel``). Bound on the H100: latency -- npoint-1 dependent
block-wide argmax reductions, one block per cloud, so only B of 132 SMs work.
The design keeps the cloud in shared memory and the running minima in
registers so each step touches no device memory; see the source's note.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .geometry import furthest_point_sample as furthest_point_sample_plain

__all__ = ["furthest_point_sample_cuda", "furthest_point_sample_plain",
           "LAUNCHES"]

LAUNCHES = 0  # kernel launches of furthest_point_sample_cuda


@functools.cache
def _lib():
    lib = _build.load("fps")
    lib.fps_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.fps_launch.restype = ctypes.c_int
    lib.fps_max_points.argtypes = []
    lib.fps_max_points.restype = ctypes.c_int
    return lib


def furthest_point_sample_cuda(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
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
    lib = _lib()
    if N > lib.fps_max_points():
        raise ValueError(f"N={N} exceeds the FPS kernel's "
                         f"{lib.fps_max_points()} points")
    idx = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    stream = torch.cuda.current_stream(xyz.device).cuda_stream
    err = lib.fps_launch(xyz.data_ptr(), B, N, npoint, idx.data_ptr(), stream)
    _build.check(lib, err, "fps")
    LAUNCHES += 1
    return idx
