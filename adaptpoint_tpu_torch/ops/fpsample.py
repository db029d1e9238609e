"""Furthest point sampling: the CUDA kernels ``csrc/fps.cu`` and their plain
version.

Replaces ``adaptpoint_tpu/ops/pallas/fps.py`` ``furthest_point_sample_pallas``
(``_fps_kernel``). Bound on the H100: latency -- npoint-1 dependent
block-wide argmax reductions, one block per cloud, so only B of 132 SMs work.
Two kernels, picked on the host by :func:`fps_tiling`:

- the chain kernel (``fps_kernel``, N up to 4096): each thread holds
  up to 4 consecutive points, their coordinates and running minima in
  registers, one barrier a step, warp
  reductions by ``redux.sync`` with the winner's coordinates carried in the
  partials; the block size by N;
- the pruned kernel (``fps_pruned_kernel``, past 4096 points, any N): the
  block sorts its cloud into buckets of 32 or more points by Morton cell
  into a scratch tensor the wrapper allocates, and a step updates only the
  buckets whose box comes nearer the last winner than their best minimum,
  a bound that holds in f32 (:func:`bucket_lower_bound`), then takes the
  largest (minimum, lowest index) key of the buckets. Its plan
  (:func:`pruned_plan`, from N alone) is the host copy of the kernel's
  ``pruned_plan``.

The four-block cluster instance that took clouds past 16384 points before
the pruned kernel stays compiled to be timed beside it
(:data:`FPS_CLUSTER_INSTANCE`). See the source's note.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from . import _build
from .geometry import furthest_point_sample as furthest_point_sample_plain

__all__ = ["furthest_point_sample_cuda", "furthest_point_sample_plain",
           "fps_tiling", "FpsTiling", "pruned_plan", "PrunedPlan",
           "bucket_lower_bound", "FPS_INSTANCES", "FPS_CLUSTER_INSTANCE",
           "LAUNCHES"]

LAUNCHES = 0  # kernel launches of furthest_point_sample_cuda


class FpsTiling(NamedTuple):
    """An instance of the kernels. ``kind`` "chain": the chain kernel,
    threads a cloud and points a thread (``threads * per_thread >= N``;
    past 1024 threads a cluster of blocks of 1024). "pruned": the pruned
    kernel on 1024 threads, ``per_thread`` 0, its plan from N
    (:func:`pruned_plan`)."""
    threads: int
    per_thread: int
    kind: str = "chain"


class PrunedPlan(NamedTuple):
    """The pruned kernel's plan for a cloud (csrc/fps.cu ``pruned_plan``)."""
    bucket: int  # points a bucket, a multiple of 32
    buckets: int  # ceil(N / bucket), at most two a thread of 1024
    n_pad: int  # buckets * bucket
    smem_minima: bool  # the running minima in shared memory (else scratch)
    smem_bytes: int  # dynamic shared memory a block
    scratch_floats: int  # scratch a cloud: sorted (x, y, z, index), minima


# the instances fps_tiling picks (csrc/fps.cu fps_launch, fps_pruned_launch)
FPS_INSTANCES = tuple(FpsTiling(*t) for t in (
    (512, 1), (512, 2), (512, 4), (1024, 4), (1024, 0, "pruned")))
# the earlier pick past 16384 points, a cluster of four blocks of 1024
# threads of 6 points (N <= 24576), compiled to be timed beside the pruned
# kernel (``tiling=``)
FPS_CLUSTER_INSTANCE = FpsTiling(4096, 6)
# the block size of the chain kernel: 512 threads up to this N, then 1024
# (at 1024 and 2048 points the block size moved a step by a few percent at
# most: PERF.md)
_FPS_512_UP_TO = 2048
# the chain kernel up to this N, the pruned kernel past it (at 4096 the
# chain kernel took 0.66 ms a call at B = 8, 1024 steps, the pruned one
# 0.99-1.09; at 8192 2.30 against 2.00-2.22: PERF.md)
_FPS_CHAIN_UP_TO = 4096
# the pruned kernel's grid (csrc/fps.cu kCells), the largest minima it
# keeps in shared memory (kMinimaSmemMax), its threads a cloud
# (kPrunedThreads) and buckets a thread (kMaxBucketsPerThread)
_CELLS = 4096
_MINIMA_SMEM_MAX = 200 * 1024
_PRUNED_THREADS = 1024
_BUCKETS_PER_THREAD = 2


def pruned_plan(n: int) -> PrunedPlan:
    """The pruned kernel's plan for clouds of ``n`` points: buckets of the
    smallest multiple of 32 points that makes at most two buckets a thread
    of 1024, the minima in shared memory while they fit in 200 KB. The host
    copy of ``pruned_plan`` in csrc/fps.cu, the same order of choices.
    ValueError where the kernel refuses."""
    if n <= 0:
        raise ValueError(f"the pruned FPS kernel refuses N={n}")
    s = -(-n // (32 * _PRUNED_THREADS * _BUCKETS_PER_THREAD)) * 32
    nb = -(-n // s)
    n_pad = nb * s
    if n_pad > (2 ** 31 - 1) // 4:
        raise ValueError(f"the pruned FPS kernel refuses N={n}: {n_pad} "
                         f"slots past its 32-bit indexing")
    smem_minima = n_pad * 4 <= _MINIMA_SMEM_MAX
    smem = max(n_pad * 4 if smem_minima else 0, _CELLS * 4)
    return PrunedPlan(s, nb, n_pad, smem_minima, smem,
                      4 * n_pad + (0 if smem_minima else n_pad))


def fps_tiling(n: int) -> FpsTiling:
    """The kernel instance for clouds of ``n`` points: the chain kernel on
    512 threads up to 2048 points and on 1024 up to 4096, points a thread
    the fewest of its instances (:data:`FPS_INSTANCES`) that cover n; past
    4096 the pruned kernel. Any n >= 1 (ValueError below)."""
    if n < 1:
        raise ValueError(f"the FPS kernel takes N >= 1, got N={n}")
    if n > _FPS_CHAIN_UP_TO:
        return FpsTiling(_PRUNED_THREADS, 0, "pruned")
    threads = 512 if n <= _FPS_512_UP_TO else 1024
    return FpsTiling(threads, min(t.per_thread for t in FPS_INSTANCES
                                  if t.kind == "chain" and t.threads == threads
                                  and t.threads * t.per_thread >= n))


def bucket_lower_bound(q: torch.Tensor, lo: torch.Tensor,
                       hi: torch.Tensor) -> torch.Tensor:
    """The pruned kernel's bound on the distance from ``q`` (..., 3) to any
    point of the box ``lo`` .. ``hi`` (..., 3): the distance, rounded as the
    FPS distance is (each difference, square and sum in f32), from q to q
    clamped to the box. Round to nearest is monotone, so each rounded
    difference is at least as far from 0 as the clamped one's, and so the
    squares and sums: the bound is <= the f32 distance of every point in
    the box, bit for bit (csrc/fps.cu ``fps_pruned_kernel`` step a)."""
    c = torch.minimum(torch.maximum(q, lo), hi)
    d = c - q
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


@functools.cache
def _lib():
    lib = _build.load("fps")
    i = ctypes.c_int
    lib.fps_launch.argtypes = [ctypes.c_void_p, i, i, i, i, i,
                               ctypes.c_void_p, ctypes.c_void_p]
    lib.fps_launch.restype = ctypes.c_int
    lib.fps_pruned_launch.argtypes = [ctypes.c_void_p, i, i, i,
                                      ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_void_p]
    lib.fps_pruned_launch.restype = ctypes.c_int
    lib.fps_pruned_plan.argtypes = [i, ctypes.c_void_p]
    lib.fps_pruned_plan.restype = ctypes.c_int
    return lib


def pruned_plan_kernel(n: int) -> Optional[PrunedPlan]:
    """The kernel's own ``pruned_plan`` (None where it refuses), to hold
    :func:`pruned_plan` to on the card."""
    lib = _lib()
    out = (ctypes.c_longlong * 6)()
    if lib.fps_pruned_plan(n, out) != 0:
        return None
    return PrunedPlan(int(out[0]), int(out[1]), int(out[2]), bool(out[3]),
                      int(out[4]), int(out[5]))


def furthest_point_sample_cuda(xyz: torch.Tensor, npoint: int,
                               tiling: Optional[tuple] = None
                               ) -> torch.Tensor:
    """xyz (B, N, 3) f32 contiguous CUDA -> idx (B, npoint) int32.
    ``tiling`` forces an instance (:data:`FPS_INSTANCES` or
    :data:`FPS_CLUSTER_INSTANCE`) in place of :func:`fps_tiling`'s."""
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
    if tl not in FPS_INSTANCES + (FPS_CLUSTER_INSTANCE,) or (
            tl.kind == "chain" and tl.threads * tl.per_thread < N):
        raise ValueError(f"no FPS instance {tuple(tl)} for N={N}")
    lib = _lib()
    idx = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    stream = torch.cuda.current_stream(xyz.device).cuda_stream
    if tl.kind == "chain":
        err = lib.fps_launch(xyz.data_ptr(), B, N, npoint, tl.threads,
                             tl.per_thread, idx.data_ptr(), stream)
    else:
        plan = pruned_plan(N)
        _build.check_int32("fps", scratch=B * plan.scratch_floats)
        scratch = torch.empty(B * plan.scratch_floats, dtype=torch.float32,
                              device=xyz.device)
        err = lib.fps_pruned_launch(xyz.data_ptr(), B, N, npoint,
                                    idx.data_ptr(), scratch.data_ptr(),
                                    stream)
    _build.check(lib, err, "fps")
    LAUNCHES += 1
    return idx
