"""Windowed max-pooled ball group, forward and backward: the CUDA kernels and their plain versions.

Forward (``csrc/window.cu``) replaces ``adaptpoint_tpu/ops/pallas/window.py``
``_wfwd_max_kernel`` (the ``pallas_call`` in ``_wbg_max_call``), backward
``_wbwd_max_kernel`` (the one in ``_wbg_max_bwd``): the two halves of
``ball_group_maxpool_windowed``, the windowed twin of the max-pooled ball
group (``ops.ballgroup_max``). Bound on the H100: bytes, as for that op.

The function, as the JAX package computes it:

- ``window_prep`` sorts the cloud along its widest axis (``order``) and the
  centers by the same key (``cperm``), cuts the sorted centers into tiles of
  ``tm`` and gives each tile a window: ``w`` sorted positions from
  ``win * 128``, the searchsorted span of the tile's keys widened by the
  radius, floor-128-aligned and clipped to the cloud. ``ok`` says whether
  every tile's span fits in ``w``.
- Each center of a tile scans its window only: the ball is the window's
  points with ``d2 < f32(r)^2`` and sorted position below N, ranked by
  original index; the first K by that rank are the slots, empty slots
  repeat the first. The center's coordinates and ``fi`` come from the
  window too: a center outside its window (possible only where ``ok`` is
  False) reads zeros, and its ball is the window's points near the origin.
  Where ``ok`` is True the result is the max-pooled ball group's.
- Values are the ``splits``-part bf16 rounding of the features (the parts'
  sum in f32, in part order: 1 part is bf16, 3 parts exact); ``fmax`` /
  ``fmin`` the max and min over the slots, with the first slot holding
  each; an empty ball gives the f32 row ``feats[:, 0]`` unrounded.
- The backward sends slot k the ``grad_splits`` rounding of ``g_fmax *
  [amax == k] + g_fmin * [amin == k]``, the center's row ``g_new || g_fi``
  exactly (nothing where the center lay outside its window), and an empty
  ball's ``g_fmax + g_fmin`` to row 0, unrounded and outside the kernels.

Both versions write their outputs in query order and keep what the
backward needs (winning slots, the slots' original indices, each ball's
count capped at K and the center's row) instead of rescanning the window.
:class:`BallGroupMaxWindowed` ties them into one differentiable op: the
kernels for CUDA tensors, the plain versions otherwise. ``ok`` stays with
the caller, as in the JAX package: the op neither reads it nor falls back.

Each kernel is one device op a call. :func:`fwd_tiling` picks the
forward's launch shape on the host (centers a block, the selection design,
the channel vector), ``ballgroup_max.bwd_tiling`` the backward's (row 8's
block layout); see the source's note.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import _build
from .ballgroup import _SMEM_LIMIT, _SMS, _a128, _check_inputs, _cotangent
from .ballgroup_max import BwdTiling, _ptr, bwd_tiling
from .geometry import index_points, radius_sq

__all__ = ["pick_window", "window_prep", "ball_group_max_windowed_plain",
           "ball_group_max_windowed_bwd_plain", "ball_group_max_windowed_cuda",
           "ball_group_max_windowed_bwd_cuda", "BallGroupMaxWindowed",
           "FwdTiling", "fwd_tiling", "fwd_smem_bytes", "bwd_tiling",
           "LAUNCHES", "LAUNCHES_BWD"]

LAUNCHES = 0      # kernel launches of ball_group_max_windowed_cuda
LAUNCHES_BWD = 0  # kernel launches of ball_group_max_windowed_bwd_cuda

_PAD_IDX = 2 ** 30  # original index of a padded window position


def _round_up(x, m: int):
    return (x + m - 1) // m * m


def pick_window(n_pad: int, radius: float, m: int, tm: int,
                extent: float = 2.0, width: Optional[int] = None) -> int:
    """Static window width: expected tile span + ball diameter, +25 %,
    128-aligned, at least 256 and at most ``n_pad``, for keys spread over
    ``extent`` (normalised clouds span about [-1, 1]). ``width`` overrides
    it (rounded up to 128), as ``ADAPTPOINT_TPU_WINDOW`` does in the JAX
    package."""
    if width:
        return min(n_pad, _round_up(int(width), 128))
    frac = (extent * tm / m + 2.0 * radius) / extent
    w = int(n_pad * frac * 1.25)
    return min(n_pad, _round_up(max(w, 256), 128))


def window_prep(xyz: torch.Tensor, query_idx: torch.Tensor, radius: float,
                tm: int, w: int, stats_only: bool = False) -> dict:
    """The sort, the permutations and the windows, on ``xyz``'s device.

    xyz (B, N, 3) f32, query_idx (B, M) int -> dict of
      order (B, N) i32   sorted position -> original index
      inv (B, N) i32     original index -> sorted position
      xyz_s (B, N, 3)    the cloud in sorted order (``None`` if stats_only)
      cperm (B, M) i32   key-sorted center order (query-space permutation)
      cinv (B, M) i32    its inverse
      qpos (B, M) i32    sorted position of each key-sorted center
      win (B, T) i32     each tile's window start in units of 128
      ok () bool         every tile's span fits in ``w`` (a device tensor)
      need () i32        the least width (128-aligned) at which ``ok`` holds

    Both sorts are stable, as ``jnp.argsort``; the window bounds are the
    JAX package's float32 sums, searched left and right."""
    from . import gather_rows
    B, N, _ = xyz.shape
    M = query_idx.shape[1]
    if M % tm:
        raise ValueError(f"M={M} is not a multiple of the tile tm={tm}")
    T = M // tm
    n_pad = _round_up(N, 128)
    dev = xyz.device
    qidx = query_idx.long()

    ext = xyz.amax(dim=1) - xyz.amin(dim=1)                       # (B, 3)
    axis = torch.argmax(ext, dim=1)                               # (B,)
    keys = torch.gather(xyz, 2, axis[:, None, None].expand(B, N, 1))[..., 0]
    order = torch.argsort(keys, dim=1, stable=True)
    keys_s = torch.gather(keys, 1, order)
    iota_n = torch.arange(N, device=dev).expand(B, N)
    inv = torch.empty_like(order).scatter_(1, order, iota_n)

    ck = torch.gather(keys, 1, qidx)                              # (B, M)
    cperm = torch.argsort(ck, dim=1, stable=True)
    cinv = torch.empty_like(cperm).scatter_(
        1, cperm, torch.arange(M, device=dev).expand(B, M))
    qpos = torch.gather(inv, 1, torch.gather(qidx, 1, cperm))

    ck_s = torch.gather(ck, 1, cperm).reshape(B, T, tm)
    # r + eps in float32, as the JAX package sums it; an f32 value, which
    # the f32 subtraction and addition below take exactly (no device copy)
    r32 = np.float32(radius)
    reach = float(r32 + (r32 * np.float32(1e-5) + np.float32(1e-7)))
    lo = torch.searchsorted(keys_s, (ck_s[:, :, 0] - reach).contiguous(),
                            side="left")
    hi = torch.searchsorted(keys_s, (ck_s[:, :, -1] + reach).contiguous(),
                            side="right")
    start = lo // 128
    win = start.clamp(0, max(n_pad - w, 0) // 128)
    ok = (hi - win * 128 <= w).all()
    need = _round_up(hi - start * 128, 128).amax().clamp(max=n_pad)

    xyz_s = None if stats_only else gather_rows(xyz, order)
    i32 = torch.int32
    return dict(order=order.to(i32), inv=inv.to(i32), xyz_s=xyz_s,
                cperm=cperm.to(i32), cinv=cinv.to(i32), qpos=qpos.to(i32),
                win=win.to(i32), ok=ok, need=need.to(i32))


def _split_round(x: torch.Tensor, splits: int) -> torch.Tensor:
    """The sum, in f32 and part order, of the first ``splits`` parts of the
    exact three-way bf16 split of ``x``."""
    p0 = x.to(torch.bfloat16).float()
    if splits == 1:
        return p0
    r1 = x - p0
    p1 = r1.to(torch.bfloat16).float()
    if splits == 2:
        return p0 + p1
    return (p0 + p1) + (r1 - p1).to(torch.bfloat16).float()


def _check_splits(splits: int, grad_splits: int) -> None:
    if splits not in (1, 2, 3) or grad_splits not in (1, 2, 3):
        raise ValueError(f"splits and grad_splits take 1-3, got {splits}, "
                         f"{grad_splits}")


def ball_group_max_windowed_plain(radius: float, nsample: int, xyz,
                                  query_idx, feats, prep: dict, w: int,
                                  tm: int, splits: int = 1):
    """The windowed function, tile by tile of key-sorted centers, on
    ``window_prep``'s ``prep`` (with ``xyz_s``). Returns, in query order,
    ``(new_xyz (B,M,3), fi, fmax, fmin (B,M,C) f32, amax, amin (B,M,C)
    uint8, cnt (B,M) i32 capped at K, idx (B,M,K) i32 original indices,
    qrow (B,M) i32 the center's original row or -1 outside its window)``."""
    B, N, _ = xyz.shape
    M = query_idx.shape[1]
    C = feats.shape[2]
    K = int(nsample)
    T = M // tm
    dev = xyz.device
    feats = feats.float()
    order = prep["order"].long()
    xyz_s = prep["xyz_s"]

    # the window of each tile: sorted positions ws + [0, w), valid below N
    pos = prep["win"].long()[:, :, None] * 128 + torch.arange(w, device=dev)
    valid = pos < N                                               # (B, T, w)
    pos_c = pos.clamp(max=N - 1).reshape(B, T * w)
    xyz_w = torch.gather(xyz_s, 1, pos_c[..., None].expand(-1, -1, 3)
                         ).reshape(B, T, 1, w, 3)
    idx_w = torch.where(valid, torch.gather(order, 1, pos_c).reshape(B, T, w),
                        _PAD_IDX)

    qpos = prep["qpos"].long().reshape(B, T, tm)
    in_win = (qpos >= pos[:, :, :1]) & (qpos < pos[:, :, :1] + w)
    q_s = torch.gather(xyz_s, 1, qpos.reshape(B, M, 1).expand(-1, -1, 3))
    q = torch.where(in_win.reshape(B, M, 1), q_s, 0.0).reshape(B, T, tm, 1, 3)
    d = q - xyz_w                                           # (B, T, tm, w, 3)
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    inball = (d2 < radius_sq(radius)) & valid[:, :, None, :]
    count = inball.sum(dim=-1)                                   # (B, T, tm)
    # the first K in original index order
    keyed = torch.where(inball, idx_w[:, :, None, :], _PAD_IDX)
    first = torch.sort(keyed, dim=-1).values[..., :K]
    if first.shape[-1] < K:
        first = torch.cat([first, first.new_full(
            first.shape[:-1] + (K - first.shape[-1],), _PAD_IDX)], dim=-1)
    slot = torch.arange(K, device=dev)
    found = count.clamp(max=K)
    idx = torch.where(slot < found[..., None], first, first[..., :1])
    idx = torch.where(found[..., None] > 0, idx, 0).reshape(B, M, K)

    vals = _split_round(torch.gather(
        feats, 1, idx.reshape(B, M * K, 1).expand(-1, -1, C)), splits
    ).reshape(B, M, K, C)
    empty = (found == 0).reshape(B, M, 1, 1)
    vals = torch.where(empty, feats[:, None, :1, :], vals)
    amax = torch.argmax(vals, dim=2)
    amin = torch.argmin(vals, dim=2)
    fmax = torch.gather(vals, 2, amax[:, :, None]).squeeze(2)
    fmin = torch.gather(vals, 2, amin[:, :, None]).squeeze(2)

    q_orig = torch.gather(order, 1, qpos.reshape(B, M))
    in_win = in_win.reshape(B, M)
    qrow = torch.where(in_win, q_orig, -1)
    fi = torch.where(in_win[..., None], _split_round(torch.gather(
        feats, 1, q_orig[..., None].expand(-1, -1, C)), splits), 0.0)

    def unsort(t):  # key-sorted center order -> query order
        return index_points(t.reshape(B, M, -1), prep["cinv"]).reshape(t.shape)

    return (unsort(q.reshape(B, M, 3)), unsort(fi), unsort(fmax),
            unsort(fmin), unsort(amax.to(torch.uint8)),
            unsort(amin.to(torch.uint8)),
            unsort(found.reshape(B, M).to(torch.int32)),
            unsort(idx.to(torch.int32)), unsort(qrow.to(torch.int32)))


def ball_group_max_windowed_bwd_plain(idx, cnt, qrow, amax, amin, g_new, g_fi,
                                      g_fmax, g_fmin, n: int,
                                      grad_splits: int = 1):
    """The backward kernel's function: slot cotangents rounded to
    ``grad_splits`` parts onto the winners' rows, ``g_new`` / ``g_fi`` onto
    the center's row; balls with ``cnt == 0`` add nothing here (see
    :func:`empty_ball_grad`). Any cotangent may be ``None`` (zero). Returns
    ``(g_xyz (B,n,3), g_feats (B,n,C))`` f32."""
    B, M, K = idx.shape
    C = amax.shape[-1]
    dev = idx.device
    slot = torch.arange(K, device=dev)[:, None]
    g_slot = torch.zeros((B, M, K, C), dtype=torch.float32, device=dev)
    for g, win in ((g_fmax, amax), (g_fmin, amin)):
        if g is not None:
            g_slot = g_slot + torch.where(win.long()[:, :, None, :] == slot,
                                          g.float()[:, :, None, :], 0.0)
    g_slot = torch.where((cnt > 0)[..., None, None],
                         _split_round(g_slot, grad_splits), 0.0)
    g_feats = torch.zeros((B, n, C), dtype=torch.float32, device=dev)
    g_feats.scatter_add_(1, idx.long().reshape(B, M * K, 1).expand(-1, -1, C),
                         g_slot.reshape(B, M * K, C))
    has_q = (qrow >= 0)[..., None]
    row = qrow.long().clamp(min=0)[..., None]
    if g_fi is not None:
        g_feats.scatter_add_(1, row.expand(-1, -1, C),
                             torch.where(has_q, g_fi.float(), 0.0))
    g_xyz = torch.zeros((B, n, 3), dtype=torch.float32, device=dev)
    if g_new is not None:
        g_xyz.scatter_add_(1, row.expand(-1, -1, 3),
                           torch.where(has_q, g_new.float(), 0.0))
    return g_xyz, g_feats


def empty_ball_grad(cnt, g_fmax, g_fmin):
    """``(B, C)``: an empty ball outputs ``feats[:, 0]`` for both max and
    min, so its ``g_fmax + g_fmin`` goes to row 0, unrounded (the JAX
    package adds it outside its kernel, ``window.py:483-485``)."""
    g = sum(x.float() for x in (g_fmax, g_fmin) if x is not None)
    return (g * (cnt == 0)[..., None]).sum(dim=1)


# the forward's selection designs, by the code the C entry point reads
DESIGNS = {"bitmap": 0, "sorted": 1}
_WARPS = 8           # warps of a forward block, each with its own bit map
_MAX_CENTERS = 32    # centers a forward block at most
_FWD_CENTERS = (32, 16, 8)  # centers a forward block, most first


class FwdTiling(NamedTuple):
    """The forward's launch shape: ``design`` the selection ("bitmap": a
    bit map of original indices a warp; "sorted": the window sorted in each
    block), ``centers`` key-sorted centers a block (dividing ``tm``), ``vec``
    channels a thread loads at once (4, or 1)."""
    design: str
    centers: int
    vec: int


def _next_pow2(x: int) -> int:
    return 1 << max(x - 1, 0).bit_length()


def fwd_smem_bytes(design: str, centers: int, N: int, K: int, w: int) -> int:
    """Shared memory of one forward block, as ``window_max_smem_bytes``
    computes it (csrc/window.cu ``fwd_layout``; ``chip_smoke.py`` holds the
    two equal). "bitmap": the window as float4, an N-bit map a warp, the
    slot table, a center table and a flag word; "sorted": the first
    draft's layout, unpadded (the window's original indices to a power of
    two, its coordinates, the slot table)."""
    if design == "bitmap":
        return (_a128(w * 16) + _a128(_WARPS * -(-N // 32) * 4)
                + _a128(centers * K * 4) + _a128(centers * 12 + 4))
    return _next_pow2(w) * 4 + w * 12 + centers * K * 4


@functools.lru_cache(maxsize=256)
def fwd_tiling(B: int, N: int, M: int, C: int, K: int, tm: int, w: int,
               aligned: bool = True, design: Optional[str] = None,
               centers: int = 0, vec: int = 0) -> FwdTiling:
    """The forward's tiling: the most centers a block (32, 16 or 8, dividing
    ``tm``) that still give four blocks an SM of work, else ``gcd(tm, 8)``;
    the bit-map selection where its shared memory fits a block, else the
    sorted one, at no more than 8 centers if need be (no more shared memory
    than the first draft took); 4 channels a thread where C and the pointer
    (``aligned``) allow. ``design``, ``centers`` and ``vec`` force those, so
    ``fwd_tiling(..., aligned, *FwdTiling)`` checks a forced tiling. Raises
    ValueError on a shape or a forced tiling the kernel does not take."""
    if not (1 <= K <= 255) or min(B, N, M, C, tm) < 1 or M % tm:
        raise ValueError(f"the windowed ball group takes 1 <= K <= 255, "
                         f"B, N, M, C >= 1 and M a multiple of tm; got K={K} "
                         f"B={B} N={N} M={M} C={C} tm={tm}")
    n_pad = _round_up(N, 128)
    if w % 128 or w < 128 or w > n_pad:
        raise ValueError(f"window width {w} must be a multiple of 128 in "
                         f"[128, {n_pad}]")
    if design is not None and design not in DESIGNS:
        raise ValueError(f"design must be one of {tuple(DESIGNS)}, got "
                         f"{design!r}")
    if centers and not (1 <= centers <= _MAX_CENTERS and tm % centers == 0):
        raise ValueError(f"centers a block must divide tm={tm} and be at "
                         f"most {_MAX_CENTERS}, got {centers}")
    if vec not in (0, 1, 4) or (vec == 4 and (C % 4 or not aligned)):
        raise ValueError(f"4 channels a thread need C % 4 == 0 and 16-byte "
                         f"aligned features; vec={vec} C={C} "
                         f"aligned={aligned}")
    vec = vec or (4 if aligned and C % 4 == 0 else 1)
    t = centers or next((t for t in _FWD_CENTERS
                         if tm % t == 0 and B * (M // t) >= 4 * _SMS),
                        math.gcd(tm, 8))
    tries = [(d, t) for d in ([design] if design else DESIGNS)]
    if not centers and tries[-1][0] == "sorted":
        tries.append(("sorted", math.gcd(tm, 8)))
    for d, t in tries:
        if fwd_smem_bytes(d, t, N, K, w) <= _SMEM_LIMIT:
            return FwdTiling(d, t, vec)
    raise ValueError(f"window width {w} at N={N}, K={K} needs "
                     f"{fwd_smem_bytes(d, t, N, K, w)} bytes of shared "
                     f"memory, more than a block has ({_SMEM_LIMIT})")


@functools.cache
def _lib():
    lib = _build.load("window")
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    lib.window_max_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i,
                                      i, f, i, i, i, p, p, p, p, p, p, p, p,
                                      p, p]
    lib.window_max_launch.restype = i
    lib.window_max_bwd_launch.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i,
                                          i, i, i, i, i, p, p, p]
    lib.window_max_bwd_launch.restype = i
    lib.window_max_smem_bytes.argtypes = [i, i, i, i, i]
    lib.window_max_smem_bytes.restype = ll
    lib.window_max_bwd_smem_bytes.argtypes = [i, i]
    lib.window_max_bwd_smem_bytes.restype = ll
    return lib


def ball_group_max_windowed_cuda(radius: float, nsample: int, xyz, query_idx,
                                 feats, prep: dict, w: int, tm: int,
                                 splits: int = 1,
                                 tiling: Optional[FwdTiling] = None):
    """The forward kernel on contiguous CUDA tensors (f32 xyz and feats, int32
    query_idx) and ``window_prep``'s ``prep`` (``xyz_s`` not needed: the
    kernel reads the cloud through ``order``); the outputs of
    :func:`ball_group_max_windowed_plain`. ``tiling`` forces a launch shape
    (``fwd_tiling(..., design=, centers=)``); every refusal comes before the
    launch."""
    global LAUNCHES
    _check_inputs(xyz, query_idx, feats)
    _check_splits(splits, 1)
    B, N, _ = xyz.shape
    M = query_idx.shape[1]
    C = feats.shape[2]
    K = int(nsample)
    tl = fwd_tiling(B, N, M, C, K, tm, w, feats.data_ptr() % 16 == 0,
                    *(tiling or ()))
    dev = xyz.device
    order, win, qpos, cperm = (prep[k].int().contiguous()
                               for k in ("order", "win", "qpos", "cperm"))
    new_xyz = torch.empty((B, M, 3), dtype=torch.float32, device=dev)
    fi, fmax, fmin = (torch.empty((B, M, C), dtype=torch.float32, device=dev)
                      for _ in range(3))
    amax, amin = (torch.empty((B, M, C), dtype=torch.uint8, device=dev)
                  for _ in range(2))
    cnt, qrow = (torch.empty((B, M), dtype=torch.int32, device=dev)
                 for _ in range(2))
    idx = torch.empty((B, M, K), dtype=torch.int32, device=dev)
    lib = _lib()
    err = lib.window_max_launch(
        xyz.data_ptr(), feats.data_ptr(), order.data_ptr(), win.data_ptr(),
        qpos.data_ptr(), cperm.data_ptr(), B, N, M, C, K, tm, w, splits,
        radius_sq(radius), DESIGNS[tl.design], tl.centers, tl.vec,
        new_xyz.data_ptr(), fi.data_ptr(), fmax.data_ptr(), fmin.data_ptr(),
        amax.data_ptr(), amin.data_ptr(), cnt.data_ptr(), idx.data_ptr(),
        qrow.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "ball_group_max_windowed")
    LAUNCHES += 1
    return new_xyz, fi, fmax, fmin, amax, amin, cnt, idx, qrow


def ball_group_max_windowed_bwd_cuda(idx, cnt, qrow, amax, amin, g_new, g_fi,
                                     g_fmax, g_fmin, n: int,
                                     grad_splits: int = 1,
                                     need_xyz: bool = True,
                                     need_feats: bool = True,
                                     tiling: Optional[BwdTiling] = None):
    """The backward kernel, one launch that writes both gradients whole; the
    outputs of :func:`ball_group_max_windowed_bwd_plain` (``None`` for a
    gradient not asked for). Cotangents may be ``None`` or non-contiguous.
    ``tiling`` forces a launch shape (``bwd_tiling(n, C, s)``)."""
    global LAUNCHES_BWD
    B, M, K = idx.shape
    C = amax.shape[-1]
    dev = idx.device
    _check_splits(1, grad_splits)
    if not (1 <= K <= 255) or min(B, M, C, n) < 1:
        raise ValueError(f"the windowed ball group takes 1 <= K <= 255 and "
                         f"B, M, C, n >= 1; got K={K} B={B} M={M} C={C} "
                         f"n={n}")
    for name, t, dtype, shape in (("idx", idx, torch.int32, (B, M, K)),
                                  ("cnt", cnt, torch.int32, (B, M)),
                                  ("qrow", qrow, torch.int32, (B, M)),
                                  ("amax", amax, torch.uint8, (B, M, C)),
                                  ("amin", amin, torch.uint8, (B, M, C))):
        if t.device.type != "cuda" or t.dtype != dtype \
                or not t.is_contiguous() or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be a contiguous {dtype} CUDA "
                             f"tensor of shape {shape}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    g_new = _cotangent(g_new, (B, M, 3), "g_new", dev)
    g_fi, g_fmax, g_fmin = (_cotangent(g, (B, M, C), name, dev)
                            for g, name in ((g_fi, "g_fi"), (g_fmax, "g_fmax"),
                                            (g_fmin, "g_fmin")))
    tl = tiling or bwd_tiling(n, C)
    g_xyz = torch.empty((B, n, 3), dtype=torch.float32, device=dev) \
        if need_xyz else None
    g_feats = torch.empty((B, n, C), dtype=torch.float32, device=dev) \
        if need_feats else None
    if g_xyz is None and g_feats is None:
        return None, None
    lib = _lib()
    err = lib.window_max_bwd_launch(
        idx.data_ptr(), cnt.data_ptr(), qrow.data_ptr(), _ptr(g_new),
        _ptr(g_fi), _ptr(g_fmax), _ptr(g_fmin), amax.data_ptr(),
        amin.data_ptr(), B, n, M, C, K, grad_splits, tl.s, tl.r, _ptr(g_xyz),
        _ptr(g_feats), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "ball_group_max_windowed_bwd")
    LAUNCHES_BWD += 1
    return g_xyz, g_feats


class BallGroupMaxWindowed(torch.autograd.Function):
    """The windowed max-pooled ball group with its first-winner backward:
    the kernels when ``use_kernels``, the plain versions otherwise. Returns
    ``(new_xyz, fi, fmax, fmin)`` in query order; ``query_idx`` gets no
    gradient."""

    @staticmethod
    def forward(ctx, xyz, query_idx, feats, radius, nsample, splits,
                grad_splits, tm, w, use_kernels):
        prep = window_prep(xyz, query_idx, radius, tm, w,
                           stats_only=use_kernels)
        fwd = ball_group_max_windowed_cuda if use_kernels \
            else ball_group_max_windowed_plain
        (new_xyz, fi, fmax, fmin, amax, amin, cnt, idx, qrow) = fwd(
            radius, nsample, xyz, query_idx, feats, prep, w, tm, splits)
        ctx.save_for_backward(idx, cnt, qrow, amax, amin)
        ctx.n, ctx.grad_splits, ctx.use_kernels = (xyz.shape[1], grad_splits,
                                                   use_kernels)
        if not ctx.needs_input_grad[0]:
            ctx.mark_non_differentiable(new_xyz)
        ctx.set_materialize_grads(False)
        return new_xyz, fi, fmax, fmin

    @staticmethod
    def backward(ctx, g_new, g_fi, g_fmax, g_fmin):
        idx, cnt, qrow, amax, amin = ctx.saved_tensors
        need_xyz, _, need_feats = ctx.needs_input_grad[:3]
        if all(g is None for g in (g_new, g_fi, g_fmax, g_fmin)):
            return (None,) * 10
        if ctx.use_kernels:
            g_xyz, g_feats = ball_group_max_windowed_bwd_cuda(
                idx, cnt, qrow, amax, amin, g_new, g_fi, g_fmax, g_fmin,
                ctx.n, ctx.grad_splits, need_xyz, need_feats)
        else:
            g_xyz, g_feats = ball_group_max_windowed_bwd_plain(
                idx, cnt, qrow, amax, amin, g_new, g_fi, g_fmax, g_fmin,
                ctx.n, ctx.grad_splits)
        if need_feats and (g_fmax is not None or g_fmin is not None):
            g_feats[:, 0] += empty_ball_grad(cnt, g_fmax, g_fmin)
        return (g_xyz if need_xyz else None, None,
                g_feats if need_feats else None) + (None,) * 7
