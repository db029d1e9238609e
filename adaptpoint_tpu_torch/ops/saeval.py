"""Fused SetAbstraction, eval and differentiable: the CUDA kernels and their plain versions.

Forward (``csrc/saeval.cu``) replaces ``adaptpoint_tpu/ops/pallas/saeval.py``
``_sa_eval_kernel`` in both of its calls: ``sa_eval_pallas`` (forward only,
:func:`sa_eval_cuda`) and ``_sa_train_call`` (the forward of
``sa_train_pallas``, :func:`sa_train_cuda`): ball group + conv (BN folded) +
ReLU + conv (BN folded) + max over K. Backward (``csrc/sa_train_bwd.cu``)
replaces ``_sa_train_bwd`` (``_sa_bwd_kernel``): the gradients for xyz and
the features, and with ``param_grads`` for the folded weights, recomputed
without the grouped tensor. Bound on the H100: operations -- the convs over
B*M*K rows, about twice as many in the backward. The kernels stage the
grouped rows of a tile of centers in shared memory as bf16 and run the
convs on the tensor cores with f32 accumulation, mma.sync on weights
streamed through a cp.async double buffer (:func:`_fwd_tiling` and
:func:`_bwd_tiling` pick their tiles; the backward holds GH, the block's
rows by the hidden columns, whole or a group of columns at a time where it
does not fit); see the sources' notes.

The TPU kernel's rounding is part of the function (``splits=1``), and both
versions here reproduce it: ``fi = bf16(f)``; gathered xyz is the two-split
sum ``bf16(x) + bf16(x - bf16(x))``; ``new_xyz`` is exact;
``h = relu(bf16(gg) . bf16(w1) + b1)``; ``out = max_k bf16(h) . bf16(w2) + b2``.
The backward sends each output's cotangent to the first slot holding its
maximum (``torch.argmax``'s rule), which the forward records:
``g_h = bf16(g_o) . bf16(w2)^T`` where ``h_pre > 0``; ``g_v = bf16(g_h) .
bf16(w1)^T``, times ``1/r`` on the dp columns when dp is normalised;
``bf16(g_v)`` goes to each slot's neighbour row, ``g_new - sum_k g_dp``
(when relative) and ``g_fi`` unrounded to the center's row.
:class:`SaTrain` is the differentiable op on either device.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from . import _build
from .ballgroup import _check_inputs, _cotangent
from .geometry import ball_query, index_points, inv_radius, radius_sq

__all__ = ["sa_eval_cuda", "sa_eval_plain", "sa_train_cuda", "sa_train_plain",
           "sa_train_bwd_cuda", "sa_train_bwd_plain", "SaTrain",
           "pack_weights", "PackedWeights", "LAUNCHES", "LAUNCHES_TRAIN",
           "LAUNCHES_TRAIN_BWD"]

LAUNCHES = 0            # kernel launches of sa_eval_cuda
LAUNCHES_TRAIN = 0      # kernel launches of sa_train_cuda
LAUNCHES_TRAIN_BWD = 0  # kernel launches of sa_train_bwd_cuda

_SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """Rounded to bf16, held in ``t``'s own type."""
    return t.to(torch.bfloat16).to(t.dtype)


def _dp_scale(radius: float, relative: bool, normalize_dp: bool) -> float:
    return inv_radius(radius) if (relative and normalize_dp) else 1.0


def _grouped_rows(radius, nsample, xyz, query_idx, feats, relative,
                  normalize_dp, idx=None):
    """``(new_xyz, idx, fb, gg)``: the centers, the ball query's neighbours
    (or the given ``idx``), ``bf16(feats)`` and the rounded gathered rows
    ``gg (B,M,K,3+C)``, all in the inputs' float type."""
    new_xyz = index_points(xyz, query_idx)
    if idx is None:
        idx = ball_query(radius, nsample, xyz, new_xyz)
    hi = _bf16(xyz)
    gx = index_points(hi + _bf16(xyz - hi), idx)  # (B, M, K, 3)
    if relative:
        gx = gx - new_xyz[:, :, None, :]
        if normalize_dp:
            gx = gx * torch.tensor(inv_radius(radius), dtype=gx.dtype,
                                   device=xyz.device)
    fb = _bf16(feats)
    gg = _bf16(torch.cat([gx, index_points(fb, idx)], dim=-1))
    return new_xyz, idx, fb, gg


def _slot_outputs(radius, nsample, xyz, query_idx, feats, w1, b1, w2, b2,
                  relative, normalize_dp):
    """``(new_xyz, fi, o (B,M,K,cout), idx)`` with o each slot's output."""
    new_xyz, idx, fb, gg = _grouped_rows(radius, nsample, xyz, query_idx,
                                         feats, relative, normalize_dp)
    h = torch.relu(torch.matmul(gg, _bf16(w1)) + b1)
    o = torch.matmul(_bf16(h), _bf16(w2)) + b2
    return new_xyz, index_points(fb, query_idx), o, idx


def sa_eval_plain(radius: float, nsample: int, xyz, query_idx, feats,
                  w1, b1, w2, b2, relative: bool = True,
                  normalize_dp: bool = False):
    """xyz (B,N,3), query_idx (B,M), feats (B,N,C); w1 (3+C, mid),
    b1 (mid,), w2 (mid, cout), b2 (cout,) with BN folded in, all of one float
    type. Returns (new_xyz (B,M,3), fi (B,M,C), out (B,M,cout))."""
    new_xyz, fi, o, _ = _slot_outputs(radius, nsample, xyz, query_idx, feats,
                                      w1, b1, w2, b2, relative, normalize_dp)
    return new_xyz, fi, o.amax(dim=2)


def sa_train_plain(radius: float, nsample: int, xyz, query_idx, feats,
                   w1, b1, w2, b2, relative: bool = True,
                   normalize_dp: bool = False):
    """:func:`sa_eval_plain` and what its backward keeps: ``(new_xyz, fi,
    out, arg (B,M,cout) uint8, idx (B,M,K) int32)``, ``arg`` the first slot
    holding each output's maximum."""
    new_xyz, fi, o, idx = _slot_outputs(radius, nsample, xyz, query_idx,
                                        feats, w1, b1, w2, b2, relative,
                                        normalize_dp)
    arg = torch.argmax(o, dim=2)
    out = torch.gather(o, 2, arg[:, :, None]).squeeze(2)
    return new_xyz, fi, out, arg.to(torch.uint8), idx


def sa_train_bwd_plain(radius: float, xyz, query_idx, feats, w1, b1, w2, b2,
                       idx, arg, g_new, g_fi, g_out, relative: bool = True,
                       normalize_dp: bool = False, param_grads: bool = False,
                       relu=None):
    """VJP of :func:`sa_train_plain` with the forward's ``idx`` and ``arg``
    (see the module's note). ``g_new`` and ``g_fi`` may be ``None`` (zero).
    ``relu`` (B, M, K, >= mid), nonzero where h_pre > 0, replaces this
    version's own ReLU mask (a kernel run's, to hold the kernel to its own
    decisions at entries within rounding of zero). Returns ``(g_xyz
    (B,N,3), g_feats (B,N,C), weight_grads)``, ``weight_grads`` ``(gw1, gb1,
    gw2, gb2)`` with ``param_grads``, else ``None``."""
    B, N, _ = xyz.shape
    C = feats.shape[-1]
    K = idx.shape[-1]
    _, _, _, gg = _grouped_rows(radius, K, xyz, query_idx, feats, relative,
                                normalize_dp, idx)
    h_pre = torch.matmul(gg, _bf16(w1)) + b1
    win = arg.long()[:, :, None, :] == torch.arange(K, device=xyz.device
                                                    )[:, None]
    g_o = torch.where(win, g_out[:, :, None, :], 0.0)  # (B, M, K, cout)
    g_ob = _bf16(g_o)
    on = h_pre > 0 if relu is None else relu[..., :h_pre.shape[-1]] != 0
    g_h = torch.where(on, torch.matmul(g_ob, _bf16(w2).t()), 0.0)
    g_hb = _bf16(g_h)
    g_v = torch.matmul(g_hb, _bf16(w1).t())  # (B, M, K, 3+C)
    g_dp = g_v[..., :3] * _dp_scale(radius, relative, normalize_dp)
    rows = idx.long().reshape(B, -1, 1)
    g_xyz = torch.zeros_like(xyz).scatter_add_(
        1, rows.expand(-1, -1, 3), _bf16(g_dp).reshape(B, -1, 3))
    g_feats = torch.zeros_like(feats).scatter_add_(
        1, rows.expand(-1, -1, C), _bf16(g_v[..., 3:]).reshape(B, -1, C))
    q = query_idx.long()[..., None]
    g_c = torch.zeros_like(g_dp[:, :, 0]) if g_new is None else g_new
    if relative:
        g_c = g_c - g_dp.sum(dim=2)
    g_xyz.scatter_add_(1, q.expand(-1, -1, 3), g_c)
    if g_fi is not None:
        g_feats.scatter_add_(1, q.expand(-1, -1, C), g_fi)
    weight_grads = None
    if param_grads:
        hb = _bf16(torch.relu(h_pre))
        weight_grads = (torch.einsum("bmkw,bmkh->wh", gg, g_hb),
                        g_h.sum(dim=(0, 1, 2)),
                        torch.einsum("bmkh,bmkc->hc", hb, g_ob),
                        g_o.sum(dim=(0, 1, 2)))
    return g_xyz, g_feats, weight_grads


@functools.cache
def _lib():
    lib = _build.load("saeval")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sa_eval_launch.argtypes = [p, p, p, p, p, p, p,
                                   i, i, i, i, i, i, i, i, i, i, i, i, i, i,
                                   f, f, i, p, p, p, p, p, p]
    lib.sa_eval_launch.restype = ctypes.c_int
    lib.sa_eval_smem_bytes.argtypes = [i, i, i, i, i, i, i, i, i]
    lib.sa_eval_smem_bytes.restype = ctypes.c_longlong
    return lib


@functools.cache
def _lib_bwd():
    lib = _build.load("sa_train_bwd")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sa_train_bwd_launch.argtypes = [p, p, p, p, p, p, p, p, p, p, p,
                                        i, i, i, i, i, i, i, i, i, i, i,
                                        f, i, p, p, p, p, p, p, p, p]
    lib.sa_train_bwd_launch.restype = ctypes.c_int
    lib.sa_train_bwd_smem_bytes.argtypes = [i, i, i, i, i, i, i, i]
    lib.sa_train_bwd_smem_bytes.restype = ctypes.c_longlong
    return lib


def _round16(x: int) -> int:
    return (x + 15) // 16 * 16


def _padded(t: torch.Tensor, shape, dtype) -> torch.Tensor:
    out = torch.zeros(shape, dtype=dtype, device=t.device)
    out[tuple(slice(0, s) for s in t.shape)] = t.to(dtype)
    return out


class PackedWeights(NamedTuple):
    """Folded weights in the kernel's layout: bf16 ``w1 (Wp, midp)`` and
    ``w2 (midp, coutp)``, f32 ``b1 (midp,)`` and ``b2 (coutp,)``, zero padded
    to multiples of 16; ``cin = 3 + C``, ``mid`` and ``cout`` unpadded."""
    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    cin: int
    mid: int
    cout: int


def pack_weights(w1, b1, w2, b2) -> PackedWeights:
    """Pack folded f32 weights ``w1 (3+C, mid)``, ``b1 (mid,)``,
    ``w2 (mid, cout)``, ``b2 (cout,)`` for the fused kernels
    (:func:`sa_eval_cuda`, :func:`sa_train_cuda`, :func:`sa_train_bwd_cuda`)."""
    if w1.dim() != 2 or w2.dim() != 2 or w2.shape[0] != w1.shape[1] \
            or b1.shape != (w1.shape[1],) or b2.shape != (w2.shape[1],):
        raise ValueError(f"weights do not chain: w1 {tuple(w1.shape)} b1 "
                         f"{tuple(b1.shape)} w2 {tuple(w2.shape)} b2 "
                         f"{tuple(b2.shape)}")
    for name, t in (("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)):
        if t.dtype != torch.float32 or t.device != w1.device:
            raise ValueError(f"{name} must be float32 on {w1.device}")
    cin, mid, cout = w1.shape[0], w1.shape[1], w2.shape[1]
    Wp, midp, coutp = _round16(cin), _round16(mid), _round16(cout)
    return PackedWeights(_padded(w1, (Wp, midp), torch.bfloat16),
                         _padded(b1, (midp,), torch.float32),
                         _padded(w2, (midp, coutp), torch.bfloat16),
                         _padded(b2, (coutp,), torch.float32), cin, mid, cout)


# Both SA kernels' shared-memory layouts (csrc/saeval.cu and
# csrc/sa_train_bwd.cu ``layout``): a double buffer of _KC weight rows a
# stage, rows padded by _PAD bf16, passes of 16 warp tiles of 32 x 32 and at
# most 256 columns (csrc/sa_common.cuh kKc, kPad, pass_cols).
_KC, _PAD = 64, 8
# the most a block may use for two blocks to share an SM: (228 KB - 2 x 1 KB
# the hardware keeps per block) / 2
_SMEM_TWO_BLOCKS = 115712
_SMS = 132  # streaming multiprocessors of the H100 SXM


def _a128(x: int) -> int:
    return (x + 127) // 128 * 128


def _pass_cols(rows: int) -> int:
    """Columns a pass of 16 warp tiles of 32 x 32 covers over ``rows`` (a
    multiple of 32), at most 256 (csrc/sa_common.cuh ``pass_cols``)."""
    return min(256, 16 // (rows // 32) * 32)


def _strip_rows(K: int) -> int:
    """Rows of a strip whose max the forward keeps one partial of: 32 where
    a center's rows fill whole 32-row groups, else 16."""
    return 32 if _round16(K) % 32 == 0 else 16


def _fwd_smem_bytes(tm: int, K: int, Wp: int, midp: int, coutp: int,
                    np_: int, kc: int, N: int, use_xs: bool) -> int:
    """Shared memory of one forward block, as ``sa_eval_smem_bytes``
    computes it (csrc/saeval.cu ``layout``; the launch checks it again and
    ``chip_smoke.py`` holds the two equal): the rows A, H over A where one
    pass covers the hidden columns, a pass's max partials (over A where H
    is apart and they fit), the weight ring, the row table, the centers
    and, with ``use_xs``, the cloud's N points."""
    rows = tm * _round16(K)
    alias = midp <= np_
    a = rows * (Wp + _PAD) * 2
    h = rows * (midp + _PAD) * 2
    parts = rows // _strip_rows(K) * min(np_, coutp)  # a pass's partials
    pv = _a128(parts * 4)
    part = pv + _a128(parts)
    total = _a128(max(a, h) if alias else a) + (0 if alias else _a128(h))
    if alias or part > _a128(a):
        total += part
    total += 2 * _a128(kc * (max(min(np_, midp), min(np_, coutp))
                             + _PAD) * 2)
    total += _a128(rows * 4) + _a128(tm * 16)
    return total + (_a128(N * 16) if use_xs else 0)


class FwdTiling(NamedTuple):
    """The forward's launch shape: ``tm`` centers a tile, ``np`` columns a
    pass, ``kc`` weight rows a ring stage, ``tiles`` tiles of one cloud a
    block walks, ``use_xs`` the cloud staged in shared memory, and the
    ``blocks_per_sm`` the shared memory allows."""
    tm: int
    np: int
    kc: int
    tiles: int
    use_xs: bool
    blocks_per_sm: int


@functools.lru_cache(maxsize=64)
def _fwd_tiling(K: int, Wp: int, midp: int, coutp: int, N: int, B: int,
                M: int) -> FwdTiling:
    """The forward's tiling: centers whose rows fill 256, 128, 64 or 32
    exactly first, then any count of at most 256 rows; the most rows with
    which two blocks fit on an SM, else one; at widths where neither fits,
    narrower passes and shorter weight stages. The cloud is staged where it
    still fits the same limit. A block walks several tiles of its cloud
    where the grid would otherwise exceed four waves of resident blocks.
    Raises ValueError where nothing fits."""
    kp = _round16(K)
    counts = [r // kp for r in (256, 128, 64, 32) if r % kp == 0]
    counts += [t for t in range(256 // kp, 0, -1) if t not in counts]

    def rows32(tm):
        return (tm * kp + 31) // 32 * 32

    def pick():
        for limit in (_SMEM_TWO_BLOCKS, _SMEM_LIMIT):
            for tm in counts:
                np_ = _pass_cols(rows32(tm))
                if _fwd_smem_bytes(tm, K, Wp, midp, coutp, np_, _KC, N,
                                   False) <= limit:
                    return tm, np_, _KC, limit
        for tm in counts:
            for np_, kc in ((max(32, _pass_cols(rows32(tm)) // 2), 64),
                            (64, 32), (32, 32)):
                if _fwd_smem_bytes(tm, K, Wp, midp, coutp, np_, kc, N,
                                   False) <= _SMEM_LIMIT:
                    return tm, np_, kc, _SMEM_LIMIT
        raise ValueError(f"SA stage too wide for one block: K={K} Wp={Wp} "
                         f"mid={midp} cout={coutp}")

    tm, np_, kc, limit = pick()
    use_xs = _fwd_smem_bytes(tm, K, Wp, midp, coutp, np_, kc, N,
                             True) <= limit
    bps = 2 if limit == _SMEM_TWO_BLOCKS else 1
    cloud_tiles = -(-M // tm)
    tiles = max(1, min(cloud_tiles, B * cloud_tiles // (4 * _SMS * bps)))
    return FwdTiling(tm, np_, kc, tiles, use_xs, bps)


def _bwd_rows(tm: int, K: int) -> int:
    """Rows of a backward block: ``tm`` centers' ``round16(K)`` each, padded
    to a multiple of 32."""
    return (tm * _round16(K) + 31) // 32 * 32


def _bwd_smem_bytes(tm: int, K: int, Wp: int, midp: int, coutp: int, C: int,
                    pg: bool, np_: int = 0) -> int:
    """Shared memory of one backward block, as ``sa_train_bwd_smem_bytes``
    computes it (the launch checks it again; ``chip_smoke.py`` holds the two
    equal at the GAN step's stages and the grouped shapes). ``np_ = 0``: GH
    whole; else the grouped layout, GH ``np_`` hidden columns at a time."""
    rows = _bwd_rows(tm, K)
    if np_:
        return _bwd_grouped_smem_bytes(tm, rows, Wp, midp, coutp, C, pg, np_)
    npass = min(256, 16 // (rows // 32) * 32)
    np1, np3 = min(npass, midp), min(npass, _round16(C))
    a = rows * (Wp + _PAD) * 2
    gh = rows * (midp + _PAD) * 2
    alias = not pg and midp <= npass
    total = _a128(max(a, gh) if alias else a) + (0 if alias else _a128(gh))
    # GO dense only with param_grads; the compact bf16(g_out) and slots
    if pg:
        total += _a128(rows * (coutp + _PAD) * 2)
    total += _a128(tm * coutp * 2) + _a128(tm * coutp)
    slot = _a128(2 * max(_KC * (np1 + _PAD),
                         np1 * (_KC + _PAD),
                         np3 * (_KC + _PAD)))
    # after the schedule the ring's space holds w1's dp rows and the rows'
    # dp values, then with param_grads hb and the wmma scratch
    ring = max(2 * slot, _a128(3 * midp * 4) + _a128(rows * 16))
    if pg:
        ring = max(ring, _a128(gh) + 8 * 256 * 4)
    return total + ring + _a128(rows * 4) + 2 * _a128(tm * 16)


def _bwd_grouped_smem_bytes(tm, rows, Wp, midp, coutp, C, pg, np_):
    """The grouped layout (csrc/sa_train_bwd.cu ``layout_grouped``): A, GH's
    group of ``np_`` columns, with param_grads the group's hb and a slice of
    GO as wide, the compact cotangents, the ring of passes ``np_`` wide, the
    wmma scratch with param_grads, the rows' dp values, the row table and
    the centers."""
    np1, np3 = min(np_, midp), min(np_, _round16(C))
    group = _a128(rows * (np_ + _PAD) * 2)
    slot = _a128(2 * max(_KC * (np1 + _PAD), np1 * (_KC + _PAD),
                         np3 * (_KC + _PAD)))
    return (_a128(rows * (Wp + _PAD) * 2) + (3 if pg else 1) * group
            + _a128(tm * coutp * 2) + _a128(tm * coutp) + 2 * slot
            + (8 * 256 * 4 if pg else 0) + _a128(rows * 16)
            + _a128(rows * 4) + 2 * _a128(tm * 16))


class BwdTiling(NamedTuple):
    """The backward's launch shape: ``tm`` centers a block; ``np`` 0 where
    GH (the block's rows by all hidden columns) fits whole in shared memory,
    else the hidden columns of a group in the grouped layout; the
    ``blocks_per_sm`` the shared memory allows."""
    tm: int
    np: int
    blocks_per_sm: int


@functools.lru_cache(maxsize=64)
def _bwd_tiling(K: int, Wp: int, midp: int, coutp: int, C: int,
                pg: bool) -> BwdTiling:
    """Centers a backward block owns, at most 256 rows: centers whose rows
    fill 256, 128, 64 or 32 exactly first (every warp gets the same share of
    tiles), then any count; the most with which two blocks fit on an SM,
    else the most with which one does, GH whole. Where GH does not fit
    whole with even one center, the grouped layout, one block an SM: of
    the centers and groups (the pass width, 128, 64 or 32 columns) that
    fit, the pair that keeps the most warp tiles busy, then the most rows,
    then the widest group. Raises ValueError where nothing fits."""
    kp = _round16(K)
    counts = [r // kp for r in (256, 128, 64, 32) if r % kp == 0]
    counts += [t for t in range(256 // kp, 0, -1) if t not in counts]
    for limit, bps in ((_SMEM_TWO_BLOCKS, 2), (_SMEM_LIMIT, 1)):
        for tm in counts:
            if _bwd_smem_bytes(tm, K, Wp, midp, coutp, C, pg) <= limit:
                return BwdTiling(tm, 0, bps)
    fits = []
    for tm in counts:
        rows = _bwd_rows(tm, K)
        widest = _pass_cols(rows)
        for np_ in [widest] + [w for w in (128, 64, 32) if w < widest]:
            if _bwd_smem_bytes(tm, K, Wp, midp, coutp, C, pg,
                               np_) <= _SMEM_LIMIT:
                tiles = min(16, rows // 32 * -(-min(np_, midp) // 32))
                fits.append(((tiles, rows, np_), tm, np_))
    if fits:
        _, tm, np_ = max(fits)
        return BwdTiling(tm, np_, 1)
    raise ValueError(f"SA stage too wide for one backward block: K={K} "
                     f"Wp={Wp} mid={midp} cout={coutp}")


def _bwd_centers_per_block(K: int, Wp: int, midp: int, coutp: int, C: int,
                           pg: bool) -> int:
    """Centers a backward block owns (:func:`_bwd_tiling`)."""
    return _bwd_tiling(K, Wp, midp, coutp, C, pg).tm


def _forward_cuda(radius, nsample, xyz, query_idx, feats, packed, relative,
                  normalize_dp, keep: bool):
    """One launch of the forward kernel; with ``keep`` also the winning
    slots and neighbour indices the backward needs."""
    _check_inputs(xyz, query_idx, feats)
    B, N, _ = xyz.shape
    M = query_idx.shape[1]
    C = feats.shape[2]
    K = int(nsample)
    if packed.cin != C + 3 or packed.w1.device != xyz.device:
        raise ValueError(f"weights for {packed.cin} input channels on "
                         f"{packed.w1.device}, features have C={C} on "
                         f"{xyz.device}")
    if K < 1 or M < 1 or K > 128:
        raise ValueError(f"the fused SA kernel takes 1 <= K <= 128 and "
                         f"M >= 1, got M={M} K={K}")
    Wp, midp = packed.w1.shape
    coutp = packed.w2.shape[1]
    _build.check_int32("sa_eval", feats=B * N * C,
                       slots=B * M * K * max(Wp, midp, coutp))
    tl = _fwd_tiling(K, Wp, midp, coutp, N, B, M)
    dev = xyz.device
    new_xyz = torch.empty((B, M, 3), dtype=torch.float32, device=dev)
    fi = torch.empty((B, M, C), dtype=torch.float32, device=dev)
    out = torch.empty((B, M, packed.cout), dtype=torch.float32, device=dev)
    arg = idx = None
    if keep:
        arg = torch.empty((B, M, packed.cout), dtype=torch.uint8, device=dev)
        idx = torch.empty((B, M, K), dtype=torch.int32, device=dev)
    lib = _lib()
    err = lib.sa_eval_launch(
        xyz.data_ptr(), query_idx.data_ptr(), feats.data_ptr(),
        packed.w1.data_ptr(), packed.b1.data_ptr(), packed.w2.data_ptr(),
        packed.b2.data_ptr(), B, N, M, C, K, tl.tm, tl.np, tl.kc, tl.tiles,
        int(tl.use_xs), Wp, midp, coutp, packed.cout,
        radius_sq(radius), _dp_scale(radius, relative, normalize_dp),
        int(bool(relative)), new_xyz.data_ptr(), fi.data_ptr(),
        out.data_ptr(), None if idx is None else idx.data_ptr(),
        None if arg is None else arg.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "sa_train" if keep else "sa_eval")
    return new_xyz, fi, out, arg, idx


def sa_eval_cuda(radius: float, nsample: int, xyz, query_idx, feats,
                 w1=None, b1=None, w2=None, b2=None, relative: bool = True,
                 normalize_dp: bool = False,
                 packed: Optional[PackedWeights] = None):
    """The kernel on CUDA tensors; same outputs as :func:`sa_eval_plain`.
    ``packed`` (from :func:`pack_weights`) replaces ``w1, b1, w2, b2``."""
    global LAUNCHES
    if torch.is_grad_enabled() and (xyz.requires_grad or feats.requires_grad):
        raise NotImplementedError(
            "the fused eval SA kernel has no backward: run it under "
            "torch.no_grad() or inference_mode(), or use ops.sa_train")
    if packed is None:
        packed = pack_weights(w1, b1, w2, b2)
    out = _forward_cuda(radius, nsample, xyz, query_idx, feats, packed,
                        relative, normalize_dp, keep=False)[:3]
    LAUNCHES += 1
    return out


def sa_train_cuda(radius: float, nsample: int, xyz, query_idx, feats,
                  packed: PackedWeights, relative: bool = True,
                  normalize_dp: bool = False):
    """The forward kernel for the differentiable stage; same outputs as
    :func:`sa_train_plain`, detached from the inputs."""
    global LAUNCHES_TRAIN
    new_xyz, fi, out, arg, idx = _forward_cuda(
        radius, nsample, xyz, query_idx, feats, packed, relative,
        normalize_dp, keep=True)
    LAUNCHES_TRAIN += 1
    return new_xyz, fi, out, arg, idx


def sa_train_bwd_cuda(radius: float, xyz, query_idx, feats,
                      packed: PackedWeights, idx, arg, g_new, g_fi, g_out,
                      relative: bool = True, normalize_dp: bool = False,
                      param_grads: bool = False, need_xyz: bool = True,
                      need_feats: bool = True,
                      tiling: Optional[BwdTiling] = None,
                      relu: Optional[torch.Tensor] = None):
    """The backward kernel; same outputs as :func:`sa_train_bwd_plain` (the
    weight gradients unpadded, ``None`` for a gradient not asked for).
    Cotangents may be ``None`` (zero) or non-contiguous. For checks:
    ``tiling`` forces a launch shape other than :func:`_bwd_tiling`'s (the
    grouped layout against GH whole), and ``relu``, a contiguous uint8
    ``(B, M, K, midp)`` tensor, gets the kernel's ReLU mask (the forward's
    bit for bit), which :func:`sa_train_bwd_plain` can take."""
    global LAUNCHES_TRAIN_BWD
    _check_inputs(xyz, query_idx, feats)
    B, N, _ = xyz.shape
    M, K = idx.shape[1], idx.shape[2]
    C = feats.shape[2]
    cout = packed.cout
    dev = xyz.device
    for name, t, shape, dtype in (
            ("idx", idx, (B, M, K), torch.int32),
            ("arg", arg, (B, M, cout), torch.uint8)):
        if tuple(t.shape) != shape or t.dtype != dtype \
                or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{name} must be a contiguous {dtype} {shape} "
                             f"tensor on {dev}")

    g_new = _cotangent(g_new, (B, M, 3), "g_new", dev)
    g_fi = _cotangent(g_fi, (B, M, C), "g_fi", dev)
    g_out = _cotangent(g_out, (B, M, cout), "g_out", dev)
    if g_out is None:
        g_out = torch.zeros((B, M, cout), dtype=torch.float32, device=dev)
    Wp, midp = packed.w1.shape
    coutp = packed.w2.shape[1]
    tl = tiling or _bwd_tiling(K, Wp, midp, coutp, C, bool(param_grads))

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    g_xyz = empty(B, N, 3) if need_xyz else None
    g_feats = empty(B, N, C) if need_feats else None
    wg = (empty(Wp, midp), empty(midp), empty(midp, coutp), empty(coutp)) \
        if param_grads else (None,) * 4

    def ptr(t):
        return None if t is None else t.data_ptr()

    if relu is not None and (relu.dtype != torch.uint8 or relu.device != dev
                             or not relu.is_contiguous()
                             or tuple(relu.shape) != (B, M, K, midp)):
        raise ValueError(f"relu must be a contiguous uint8 {(B, M, K, midp)} "
                         f"tensor on {dev}")
    lib = _lib_bwd()
    err = lib.sa_train_bwd_launch(
        xyz.data_ptr(), query_idx.data_ptr(), feats.data_ptr(),
        idx.data_ptr(), arg.data_ptr(), packed.w1.data_ptr(),
        packed.b1.data_ptr(), packed.w2.data_ptr(), g_out.data_ptr(),
        ptr(g_new), ptr(g_fi), B, N, M, C, K, tl.tm, tl.np, Wp, midp, coutp,
        cout,
        _dp_scale(radius, relative, normalize_dp), int(bool(relative)),
        ptr(g_xyz), ptr(g_feats), *(ptr(t) for t in wg), ptr(relu),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "sa_train_bwd")
    LAUNCHES_TRAIN_BWD += 1
    weight_grads = None
    if param_grads:
        cin, mid = packed.cin, packed.mid
        weight_grads = (wg[0][:cin, :mid], wg[1][:mid], wg[2][:mid, :cout],
                        wg[3][:cout])
    return g_xyz, g_feats, weight_grads


class SaTrain(torch.autograd.Function):
    """The differentiable fused SA stage: the kernels when ``use_kernels``
    (``packed`` spares the weight packing), the plain versions otherwise.
    Returns ``(new_xyz, fi, out)``. The weight gradients are computed only
    where a folded weight asks for one (``param_grads``: the JAX package's
    ``frozen_params`` read off the graph); ``query_idx`` gets none."""

    @staticmethod
    def forward(ctx, xyz, query_idx, feats, w1, b1, w2, b2, radius, nsample,
                relative, normalize_dp, packed, use_kernels):
        if use_kernels:
            if packed is None:
                packed = pack_weights(w1, b1, w2, b2)
            new_xyz, fi, out, arg, idx = sa_train_cuda(
                radius, nsample, xyz, query_idx, feats, packed, relative,
                normalize_dp)
        else:
            new_xyz, fi, out, arg, idx = sa_train_plain(
                radius, nsample, xyz, query_idx, feats, w1, b1, w2, b2,
                relative, normalize_dp)
        ctx.save_for_backward(xyz, query_idx, feats, w1, b1, w2, b2, idx, arg)
        ctx.args = (radius, relative, normalize_dp, packed, use_kernels)
        if not ctx.needs_input_grad[0]:
            # a constant of xyz alone: keep what is computed from it off the
            # graph
            ctx.mark_non_differentiable(new_xyz)
        ctx.set_materialize_grads(False)
        return new_xyz, fi, out

    @staticmethod
    def backward(ctx, g_new, g_fi, g_out):
        xyz, query_idx, feats, w1, b1, w2, b2, idx, arg = ctx.saved_tensors
        radius, relative, normalize_dp, packed, use_kernels = ctx.args
        need = ctx.needs_input_grad
        param_grads = any(need[3:7])
        if use_kernels:
            g_xyz, g_feats, wg = sa_train_bwd_cuda(
                radius, xyz, query_idx, feats, packed, idx, arg, g_new, g_fi,
                g_out, relative, normalize_dp, param_grads, need[0], need[2])
        else:
            if g_out is None:
                g_out = torch.zeros(arg.shape, dtype=feats.dtype,
                                    device=feats.device)
            g_xyz, g_feats, wg = sa_train_bwd_plain(
                radius, xyz, query_idx, feats, w1, b1, w2, b2, idx, arg,
                g_new, g_fi, g_out, relative, normalize_dp, param_grads)
        wg = (None,) * 4 if wg is None else wg
        return ((g_xyz if need[0] else None, None,
                 g_feats if need[2] else None)
                + tuple(g if n else None for g, n in zip(wg, need[3:7]))
                + (None,) * 6)
