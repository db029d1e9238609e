"""Fused train-mode SetAbstraction stage: the CUDA kernels and their plain versions.

The stage is ``out = max_k BN2(relu(BN1([dp || fj] W1)) W2)`` over each
ball, with BatchNorm on the current batch's statistics over all B*M*K slots
(pad slots included) in flax's form ``var = E[x^2] - E[x]^2``, unclipped as
the TPU kernel computes it. It returns ``(new_xyz, fi, out, mu1, var1, mu2,
var2)`` and is differentiable in ``xyz``, ``feats`` and the six parameters;
the statistics are for the running averages and take no gradient.

Four CUDA passes (``csrc/satrainbn.cu``) replace the four calls of
``adaptpoint_tpu/ops/pallas/satrainbn.py`` ``sa_trainbn_pallas``:

* :func:`stats_cuda` -- ``_f1_kernel`` (:507): the ball query and the sums
  ``Sv``, ``Svv`` of the gathered rows;
* :func:`fwd_cuda` -- ``_f2_kernel`` (:526): the forward with BN1's batch
  affine, per-(b, m, c) max and min of y2 with their first slots, the sums
  of y2 and y2^2, and the ReLU's mask (a bit a row and hidden channel);
* :func:`bwd_w2_cuda` -- ``_bwd_kernel`` phase 1 (:637): dW2 and BN1's
  cross-tile sums, and the two tensors it hands to pass 4, y1 and g_y1'
  (g_h where the forward's mask is set), n x mid f32 each;
* :func:`bwd_x_cuda` -- ``_bwd_kernel`` phase 2 (:657): from y1 and g_y1',
  dW1 and the gradient of ``(xyz, feats)``. The TPU kernel recomputes
  through y2 and g_h here, to keep HBM free; on the H100 the hand-over
  (67 MB written and read a PointNeXt-S stage at B=32) costs less than
  conv2 and g_h again.

The per-channel algebra between the passes (BN1's and BN2's moments, the
slopes, the pooled output, the dense BatchNorm backward's P and Q
constants, d_gamma and d_beta) is plain PyTorch on either device, as it is
plain JAX outside the TPU kernels (``_bn1``, ``_bn2``, ``_bwd_consts``).
Each pass has a plain version of the same function (``*_plain``), and
:class:`SaTrainBN` ties the passes into one differentiable op: the kernels
for CUDA tensors, the plain passes for CPU tensors. :func:`sa_trainbn_plain`
is the stage written out and differentiated by autograd, the reference the
passes are held to.

Bound on the H100: operations. The forward's and the backward's products
run on the tensor cores as 3xTF32 (each f32 operand split into a TF32 high
part and a TF32 remainder, three products into f32 accumulators: f32-grade,
as the TPU kernel's f32 MXU products); :func:`tf32x3_mm` is that numerics
in PyTorch, and the plain passes take their products through
``_mm_stats`` (pass 1), ``_mm_fwd`` (pass 2) and ``_mm`` (passes 3, 4) so
that a test can swap it in. The statistics' Svv takes f32 FMAs on the CUDA
cores: BN1's variance E[y^2] - E[y]^2 cancels, and 3xTF32 sums there fail
the stage's bounds at |mean| / std = 10 and 100
(``tests/test_torch_satrainbn_fwd.py``). At PointNeXt-S's
four B=32 stages pass 2 does 48.7 GFLOP, pass 3 113.1 and pass 4 33.0, so 3
x flops at the dense TF32 rate (495 TFLOP/s) bounds them at 0.295, 0.686
and 0.200 ms; pass 1's 8.6 GFLOP at the f32 rate (67 TFLOP/s) at 0.128.
Because the backward computes y1 in another order than the forward, it
takes the ReLU's mask from the forward's bits rather than from its own y1.
:func:`fwd_cuda` also returns the padded weight copies W1^T and W2^T
that :func:`bwd_w2_cuda` reads (``SaTrainBN`` saves them with the mask).
See the source's note for the tiling.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build
from .ballgroup import _check_inputs, _cotangent
from .geometry import ball_query, index_points, inv_radius, radius_sq

__all__ = ["sa_trainbn_plain", "stats_plain", "fwd_plain", "bwd_w2_plain",
           "bwd_x_plain", "tf32x3_mm", "pack_mask", "unpack_mask",
           "stats_cuda", "fwd_cuda", "bwd_w2_cuda",
           "bwd_x_cuda", "SaTrainBN", "TrainBNPlan", "plan_host",
           "smem_bytes", "LAUNCHES_STATS", "LAUNCHES_FWD",
           "LAUNCHES_BWD_W2", "LAUNCHES_BWD_X"]

LAUNCHES_STATS = 0   # kernel launches of stats_cuda
LAUNCHES_FWD = 0     # kernel launches of fwd_cuda
LAUNCHES_BWD_W2 = 0  # kernel launches of bwd_w2_cuda
LAUNCHES_BWD_X = 0   # kernel launches of bwd_x_cuda


def _dp_scale(radius: float, relative: bool, normalize_dp: bool) -> float:
    return inv_radius(radius) if (relative and normalize_dp) else 1.0


def _rows(radius, xyz, query_idx, feats, idx, relative, normalize_dp):
    """The gathered rows ``v = [dp || fj]`` (B, M, K, 3+C), as the ball
    group computes them."""
    dp = index_points(xyz, idx)
    if relative:
        dp = dp - index_points(xyz, query_idx)[:, :, None, :]
        if normalize_dp:
            dp = dp * torch.tensor(inv_radius(radius), dtype=dp.dtype,
                                   device=dp.device)
    return torch.cat([dp, index_points(feats, idx)], dim=-1)


def sa_trainbn_plain(radius: float, nsample: int, xyz, query_idx, feats,
                     w1, gamma1, beta1, w2, gamma2, beta2,
                     relative: bool = True, normalize_dp: bool = False,
                     eps: float = 1e-5):
    """The stage written out, differentiated by autograd: xyz (B,N,3),
    query_idx (B,M), feats (B,N,C); w1 (3+C, mid), gamma1/beta1 (mid,),
    w2 (mid, cout), gamma2/beta2 (cout,). Returns ``(new_xyz (B,M,3), fi
    (B,M,C), out (B,M,cout), mu1, var1, mu2, var2)``.

    The pooled value of a channel is ``a2 * y2 + c2`` at the first slot of
    the max of y2 where BN2's slope ``a2 = gamma2 / sqrt(var2 + eps)`` is
    positive and of the min otherwise (``a2 == 0`` included), the kernel's
    rule; its gradient goes to that slot."""
    new_xyz = index_points(xyz, query_idx)
    fi = index_points(feats, query_idx)
    idx = ball_query(radius, nsample, xyz, new_xyz)
    v = _rows(radius, xyz, query_idx, feats, idx, relative, normalize_dp)
    y1 = torch.matmul(v, w1)
    mu1 = y1.mean(dim=(0, 1, 2))
    var1 = (y1 * y1).mean(dim=(0, 1, 2)) - mu1 * mu1
    a1 = gamma1 * torch.rsqrt(var1 + eps)
    h = torch.relu(y1 * a1 + (beta1 - mu1 * a1))
    y2 = torch.matmul(h, w2)
    mu2 = y2.mean(dim=(0, 1, 2))
    var2 = (y2 * y2).mean(dim=(0, 1, 2)) - mu2 * mu2
    a2 = gamma2 * torch.rsqrt(var2 + eps)
    slot = torch.where(a2 > 0, torch.argmax(y2, dim=2),
                       torch.argmin(y2, dim=2))
    ystar = torch.gather(y2, 2, slot[:, :, None, :]).squeeze(2)
    out = a2 * ystar + (beta2 - mu2 * a2)
    return (new_xyz, fi, out, mu1.detach(), var1.detach(), mu2.detach(),
            var2.detach())


# ---- the passes, plain ---------------------------------------------------

def _mm(a, b):
    """The backward passes' products (``tf32x3_mm`` emulates the kernels')."""
    return torch.matmul(a, b)


def _mm_fwd(a, b):
    """The forward's products (``tf32x3_mm`` emulates the kernel's)."""
    return torch.matmul(a, b)


def _mm_stats(a, b):
    """The statistics' products: f32 FMAs in the kernel, as here; a test
    swaps in ``tf32x3_mm`` to show why they are not 3xTF32."""
    return torch.matmul(a, b)


def _tf32(x):
    """``x`` rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, in f32: the kernels' split ``tf32_bits``."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_trunc(x):
    """The TF32 part of ``x`` that a tensor-core product reads: its top 19
    bits."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def tf32x3_mm(a, b):
    """``a @ b`` (f32) with the operands split as the backward kernels split
    them, ``x = hi + lo`` with ``hi = tf32(x)`` and ``lo = x - hi`` of which
    the product reads the truncated TF32 part, and the product taken as
    ``lo.hi + hi.lo + hi.hi`` (the dropped lo.lo is 2^-22 of |a b|): the
    3xTF32 numerics of ``mma.sync`` on f32 sums."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32_trunc(a - ah), _tf32_trunc(b - bh)
    return (torch.matmul(al, bh) + torch.matmul(ah, bl)) \
        + torch.matmul(ah, bh)


def pack_mask(on):
    """A bool (B, M, K, mid) mask as the forward's words: int32
    (ceil(mid / 32), B, M, K), bit ``j % 32`` of word ``j // 32``."""
    *lead, mid = on.shape
    nw = (mid + 31) // 32
    bits = torch.zeros((*lead, nw * 32), dtype=torch.int64, device=on.device)
    bits[..., :mid] = on
    shift = torch.arange(32, dtype=torch.int64, device=on.device)
    words = (bits.view(*lead, nw, 32) << shift).sum(dim=-1)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32).movedim(-1, 0).contiguous()


def unpack_mask(words, mid):
    """The bool (B, M, K, mid) mask of :func:`pack_mask`'s words."""
    w = words.movedim(0, -1).to(torch.int64) & 0xFFFFFFFF
    shift = torch.arange(32, dtype=torch.int64, device=words.device)
    return (((w[..., None] >> shift) & 1) != 0).flatten(-2)[..., :mid]


def stats_plain(radius, nsample, xyz, query_idx, feats, relative=True,
                normalize_dp=False):
    """Pass 1: ``(idx (B,M,K) int32, sv (W,), svv (W, W))``."""
    idx = ball_query(radius, nsample, xyz, index_points(xyz, query_idx))
    v = _rows(radius, xyz, query_idx, feats, idx, relative, normalize_dp)
    v = v.reshape(-1, v.shape[-1])
    return idx, v.sum(dim=0), _mm_stats(v.t(), v)


def _through_y2(radius, xyz, query_idx, feats, idx, w1, a1, nb1, w2,
                relative, normalize_dp):
    v = _rows(radius, xyz, query_idx, feats, idx, relative, normalize_dp)
    y1 = _mm_fwd(v, w1)
    y1p = y1 * a1 + nb1
    h = torch.relu(y1p)
    return v, y1, y1p, h, _mm_fwd(h, w2)


def fwd_plain(radius, xyz, query_idx, feats, idx, w1, a1, nb1, w2,
              relative=True, normalize_dp=False):
    """Pass 2: ``(new_xyz, fi, ymax, ymin, amax, amin, s2, q2, mask)``: the
    max and the min of y2 over each ball with their first slots (uint8),
    ``sum y2``, ``sum y2^2`` over all slots, and the ReLU's mask ``a1 y1 +
    nb1 > 0`` as :func:`pack_mask` words."""
    _, _, y1p, _, y2 = _through_y2(radius, xyz, query_idx, feats, idx, w1,
                                   a1, nb1, w2, relative, normalize_dp)
    amax, amin = torch.argmax(y2, dim=2), torch.argmin(y2, dim=2)
    ymax = torch.gather(y2, 2, amax[:, :, None, :]).squeeze(2)
    ymin = torch.gather(y2, 2, amin[:, :, None, :]).squeeze(2)
    return (index_points(xyz, query_idx), index_points(feats, query_idx),
            ymax, ymin, amax.to(torch.uint8), amin.to(torch.uint8),
            y2.sum(dim=(0, 1, 2)), (y2 * y2).sum(dim=(0, 1, 2)),
            pack_mask(y1p > 0))


def _g_h(radius, xyz, query_idx, feats, idx, w1, a1, nb1, w2, a2, p2, q2c,
         slot, g_out, mask, relative, normalize_dp):
    """y1, h, g_y2 and g_y1' of pass 3, the ReLU taken from the forward's
    ``mask``."""
    v = _rows(radius, xyz, query_idx, feats, idx, relative, normalize_dp)
    y1 = _mm(v, w1)
    on = unpack_mask(mask, w1.shape[1])
    h = torch.where(on, y1 * a1 + nb1, 0.0)
    y2 = _mm(h, w2)
    K = idx.shape[-1]
    win = slot.long()[:, :, None, :] == torch.arange(
        K, device=xyz.device)[:, None]
    g_y2 = a2 * torch.where(win, g_out[:, :, None, :], 0.0) + p2 + q2c * y2
    g_y1p = torch.where(on, _mm(g_y2, w2.t()), 0.0)
    return y1, h, g_y2, g_y1p


def bwd_w2_plain(radius, xyz, query_idx, feats, idx, w1, a1, nb1, w2, mu1,
                 r1, a2, p2, q2c, slot, g_out, mask, relative=True,
                 normalize_dp=False):
    """Pass 3: ``(dw2 (mid, cout), sg1 (mid,), sgx1 (mid,), g_y1p (B,M,K,
    mid), y1 (B,M,K,mid))`` = ``h^T g_y2``, ``sum g_y1'``, ``sum g_y1'
    xhat1``, and the two tensors handed to pass 4: g_y1' (``g_h`` where the
    forward's ``mask`` is set) and y1."""
    y1, h, g_y2, g_y1p = _g_h(radius, xyz, query_idx, feats, idx, w1, a1,
                              nb1, w2, a2, p2, q2c, slot, g_out, mask,
                              relative, normalize_dp)
    mid, cout = w2.shape
    dw2 = _mm(h.reshape(-1, mid).t(), g_y2.reshape(-1, cout))
    xhat1 = (y1 - mu1) * r1
    return (dw2, g_y1p.sum(dim=(0, 1, 2)),
            (g_y1p * xhat1).sum(dim=(0, 1, 2)), g_y1p, y1)


def bwd_x_plain(radius, xyz, query_idx, feats, idx, w1, y1, g_y1p, a1, p1,
                q1c, g_fi=None, g_new=None, relative=True,
                normalize_dp=False):
    """Pass 4: ``(g_xyz (B,N,3), g_feats (B,N,C), dw1 (W, mid))`` from pass
    3's ``y1`` and ``g_y1p``: ``g_y1 = a1 g_y1' + p1 + q1c y1``. Each slot's
    ``g_v = g_y1 W1^T`` goes to its neighbour row (a pad slot's and an empty
    ball's to the row they repeat); ``g_new - sum_k g_dp`` (relative) and
    ``g_fi`` to the center's row. ``g_fi`` and ``g_new`` may be ``None``."""
    v = _rows(radius, xyz, query_idx, feats, idx, relative, normalize_dp)
    g_y1 = a1 * g_y1p + p1 + q1c * y1
    W, mid = w1.shape
    dw1 = _mm(v.reshape(-1, W).t(), g_y1.reshape(-1, mid))
    g_v = _mm(g_y1, w1.t())
    g_dp = g_v[..., :3] * _dp_scale(radius, relative, normalize_dp)
    B, M, K = idx.shape
    C = feats.shape[-1]
    rows = idx.long().reshape(B, -1, 1)
    g_xyz = torch.zeros_like(xyz).scatter_add_(
        1, rows.expand(-1, -1, 3), g_dp.reshape(B, M * K, 3))
    g_feats = torch.zeros_like(feats).scatter_add_(
        1, rows.expand(-1, -1, C), g_v[..., 3:].reshape(B, M * K, C))
    q = query_idx.long()[..., None]
    g_c = torch.zeros((B, M, 3), dtype=xyz.dtype, device=xyz.device) \
        if g_new is None else g_new
    if relative:
        g_c = g_c - g_dp.sum(dim=2)
    g_xyz.scatter_add_(1, q.expand(-1, -1, 3), g_c)
    if g_fi is not None:
        g_feats.scatter_add_(1, q.expand(-1, -1, C), g_fi)
    return g_xyz, g_feats, dw1


# ---- the per-channel algebra between the passes ---------------------------

def _bn1(sv, svv, w1, gamma1, beta1, n, eps):
    """BN1's moments from the row sums: ``(mu1, var1, r1, a1, nb1)``."""
    mu1 = (sv @ w1) / n
    ey1sq = torch.einsum("wm,wv,vm->m", w1, svv, w1) / n
    var1 = ey1sq - mu1 * mu1
    r1 = torch.rsqrt(var1 + eps)
    a1 = gamma1 * r1
    return mu1, var1, r1, a1, beta1 - mu1 * a1


def _bn2(s2, q2, gamma2, beta2, n, eps):
    """BN2's moments, slope and shift: ``(mu2, var2, r2, a2, c2)``."""
    mu2 = s2 / n
    var2 = q2 / n - mu2 * mu2
    r2 = torch.rsqrt(var2 + eps)
    a2 = gamma2 * r2
    return mu2, var2, r2, a2, beta2 - mu2 * a2


def _bwd_consts(s0, s1, a, mu, r):
    """The dense BatchNorm backward ``dL/dx = a g + P + Q x`` from
    ``s0 = mean(g)`` and ``s1 = mean(g xhat)``: ``(P, Q)``."""
    return -a * s0 + a * s1 * mu * r, -a * s1 * r


# ---- the kernels ---------------------------------------------------------

@functools.cache
def _lib():
    lib = _build.load("satrainbn")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sa_trainbn_plan.argtypes = [i, i, i, i, i, i, i, i, p, p, p]
    lib.sa_trainbn_plan.restype = ctypes.c_int
    lib.sa_trainbn_smem_bytes.argtypes = [i] * 7
    lib.sa_trainbn_smem_bytes.restype = ctypes.c_longlong
    lib.sa_trainbn_stats_launch.argtypes = [p, p, p, i, i, i, i, i, f, f, i,
                                            i, i, i, p, p, p, p]
    lib.sa_trainbn_stats_launch.restype = ctypes.c_int
    lib.sa_trainbn_fwd_launch.argtypes = ([p, p, p, p, i, i, i, i, i, f, i,
                                           p, p, p, p, i, i, i, i, i]
                                          + [p] * 11)
    lib.sa_trainbn_fwd_launch.restype = ctypes.c_int
    lib.sa_trainbn_bwd_w2_launch.argtypes = (
        [p, p, p, p, i, i, i, i, i, f, i] + [p] * 11 + [i] * 8 + [p] * 10)
    lib.sa_trainbn_bwd_w2_launch.restype = ctypes.c_int
    lib.sa_trainbn_bwd_x_launch.argtypes = (
        [p, p, p, p, i, i, i, i, i, f, i] + [p] * 6 + [i, p, p, i, i, i]
        + [p] * 6)
    lib.sa_trainbn_bwd_x_launch.restype = ctypes.c_int
    return lib


# copies of dW1 and dW2 the backward's blocks add to (``kCopies``): fewer
# L2 reductions on one address where the tiles outnumber the weights
COPIES = 8
# the launch kinds of ``sa_trainbn_plan``
STATS, FWD, BWD_Y2, BWD_GH, BWD_X = range(5)
# rows a block, forced where they fit (``scripts/torch_trainbn_timing.py
# --designs``): "stats" for pass 1, "fwd" for pass 2, "rows" for the
# backward's; 0: the plan's choice
DESIGN = {"rows": 0, "fwd": 0, "stats": 0}


@functools.lru_cache(maxsize=64)
def _plan(kind: int, B: int, M: int, K: int, C: int, mid: int, cout: int,
          force_rows: int = 0):
    """``(tile, G, ring)``: rows a block, blocks a grid and the weight ring's
    stages (for pass 1 the parts its rows are cut into; see
    ``sa_trainbn_plan``)."""
    lib = _lib()
    tile, grid, ring = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _build.check(lib, lib.sa_trainbn_plan(kind, B, M, K, C, mid, cout,
                                          force_rows, ctypes.byref(tile),
                                          ctypes.byref(grid),
                                          ctypes.byref(ring)),
                 "sa_trainbn_plan")
    return tile.value, grid.value, ring.value


# The host's copy of the passes' launch shapes (csrc/satrainbn.cu
# ``smem_bytes``, ``fwd_layout`` and the tile and ring choice of
# ``sa_trainbn_plan``; the grid, which asks the card for its occupancy, is
# left out). ``chip_smoke.py`` holds it equal to the kernels' plan at every
# stage it runs; on the CPU it says whether a stage fits.
_SMEM_LIMIT = 232448                  # kSmemLimit
_SMEM_TWO = (233472 - 2 * 1024) // 2  # kSmemTwo
_NC = 64                              # kNC, and kKR
_STAGE_FLOATS = _NC * (_NC + 8)       # kStageFloats
_MAX_RING = 6                         # kMaxRing
_IDX_INTS, _SLACK, _DEPTH = 4 * 128, 256, 3


class TrainBNPlan(NamedTuple):
    """A pass's launch shape: ``tile`` rows a block, ``ring`` weight ring
    stages (0 for the forward with both weights resident; 2 for pass 1,
    which has no ring) and the ``smem`` bytes a block takes."""
    tile: int
    ring: int
    smem: int


def _ld_rm(cols: int) -> int:
    x = _round8(cols)
    return x if x & 8 else x + 8


def _slice_of(C: int) -> int:
    return 32 if C <= 32 else 64


def _slices_of(C: int) -> int:
    S = _slice_of(C)
    return -(-C // S) if C > S else 1


def _fwd_floats(rt, K, W, mid, cout, nring, kr) -> int:
    """``fwd_layout(...).total``: v, h, the ring or both weights resident,
    BN2's cross-warp sums, the keys, the row warps' keys, the mask words
    and the rows."""
    tm = rt // K if K <= rt else 1
    nkeys = tm * _NC if K <= rt else _round8(cout)
    ldv, ldh = _ld_rm(_round8(W)), _ld_rm(_round8(mid))
    floats = rt * (ldv + ldh)
    if nring:
        floats += nring * _NC * (kr + 8)
    else:
        floats += (-(-mid // 64) * 64) * ldv + (-(-cout // 64) * 64) * ldh
    return (floats + (rt // 32) * _NC * 2 + nkeys * 4
            + (rt // 32) * _NC * 4 + 8 + (mid + 31) // 32 * rt + 4 * rt)


def smem_bytes(kind: int, tile: int, K: int, C: int, mid: int, cout: int,
               ring: int = 2) -> int:
    """Bytes of shared memory a block of pass ``kind`` takes
    (``sa_trainbn_smem_bytes``)."""
    W = C + 3
    if kind == STATS:
        S = _slice_of(C)
        f = _DEPTH * tile * (S + 4 + (S if _slices_of(C) > 1 else 0))
        group = (S // 8) ** 2
        stage = (256 // group - 1) * (64 + 4 * (S // group) + 1) * group
        return max(f, stage) * 4
    if kind == FWD:
        b = _fwd_floats(tile, K, W, mid, cout, ring, _NC) * 4
        if ring and b > _SMEM_TWO:
            return _fwd_floats(tile, K, W, mid, cout, ring, 128) * 4
        return b
    W8, mid8 = _round8(W), _round8(mid)
    if kind == BWD_Y2:
        spanned = min(tile, (tile + K - 1) // K + 1)
        f = tile * (_ld_rm(max(W8, mid8)) + _NC + 8) + spanned * _NC * 5 // 4
    elif kind == BWD_GH:
        f = tile * _ld_rm(_round8(cout)) + 4 * _NC * 2
    else:
        f = tile * (_ld_rm(_round8(W + 1)) + _ld_rm(mid8))
    return (f + ring * _STAGE_FLOATS + _IDX_INTS + _SLACK) * 4


def plan_host(kind: int, B: int, M: int, K: int, C: int, mid: int,
              cout: int, force_rows: int = 0) -> TrainBNPlan:
    """The tile and ring ``sa_trainbn_plan`` picks (the same order of
    choices) and the block's shared memory; ValueError where it refuses."""
    if B <= 0 or M <= 0 or K <= 0 or K > 255 or C < 0 or mid <= 0 \
            or cout <= 0 or kind not in (STATS, FWD, BWD_Y2, BWD_GH, BWD_X) \
            or force_rows not in (0, 32, 64, 128) or B * M * K > 0x7fffffff:
        raise ValueError(f"sa_trainbn_plan refuses kind={kind} B={B} M={M} "
                         f"K={K} C={C} mid={mid} cout={cout} "
                         f"force_rows={force_rows}")

    def size(rt, ring=2):
        return smem_bytes(kind, rt, K, C, mid, cout, ring)

    res = False
    if kind == STATS:
        t = force_rows or (128 if _slices_of(C) == 1 else 64)
    elif kind == FWD and force_rows and size(force_rows, 0) <= _SMEM_LIMIT:
        t, res = force_rows, True
    elif kind == FWD and not force_rows and size(128, 0) <= _SMEM_TWO:
        t, res = 128, True
    elif kind == FWD and not force_rows and size(64, 0) <= _SMEM_TWO:
        t, res = 64, True
    elif force_rows and size(force_rows) <= _SMEM_LIMIT:
        t = force_rows
    elif size(128) <= _SMEM_TWO:
        t = 128
    elif size(64) <= _SMEM_TWO:
        t = 64
    else:
        t = 128
        while t > 32 and size(t) > _SMEM_LIMIT:
            t //= 2
    nr = 0 if res else 2
    if kind != STATS and not res:
        cap = _SMEM_TWO if size(t, 2) <= _SMEM_TWO else _SMEM_LIMIT
        while nr < _MAX_RING and size(t, nr + 1) <= cap:
            nr += 1
    smem = size(t, nr)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"train-BN pass {kind} too wide for one block: "
                         f"{smem} bytes at {t} rows (K={K} C={C} mid={mid} "
                         f"cout={cout})")
    return TrainBNPlan(t, nr, smem)


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _f32_rows(dev, *named):
    """Per-channel vectors and weights as contiguous f32 on ``dev``."""
    out = []
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the points on {dev}")
        out.append(t.detach().float().contiguous())
    return out


def _round8(x: int) -> int:
    return (x + 7) // 8 * 8


def _wt_floats(W: int, mid: int, cout: int) -> int:
    """Floats of the forward's weight copies W1^T (mid rows of round8(W))
    and W2^T (cout rows of round8(mid))."""
    return mid * _round8(W) + cout * _round8(mid)


def _padded(t, cols):
    """``t`` (rows, c) as a contiguous f32 (rows, cols) with zeros past c."""
    out = torch.zeros((t.shape[0], cols), dtype=torch.float32,
                      device=t.device)
    out[:, :t.shape[1]] = t
    return out


def _rows_of(t, shape, ld, name, dev):
    """``t`` (``shape`` = (B, M, K, mid)) as the (B*M*K, ld) f32 rows the
    backward kernels read: ``t``'s own storage where its rows are ``ld``
    floats apart (pass 3's outputs), else a padded copy."""
    if tuple(t.shape) != shape or t.device != dev:
        raise ValueError(f"{name} must be {shape} on {dev}, got "
                         f"{tuple(t.shape)} on {t.device}")
    t = t.detach().float()
    B, M, K, mid = shape
    if (t.stride() == (M * K * ld, K * ld, ld, 1) and t.storage_offset() == 0
            and t.untyped_storage().nbytes() >= B * M * K * ld * 4):
        return t.as_strided((B * M * K, ld), (ld, 1))
    return _padded(t.reshape(-1, mid), ld)


def _check_idx(idx, B, M, dev):
    if (idx.device != dev or idx.dtype != torch.int32 or idx.dim() != 3
            or tuple(idx.shape[:2]) != (B, M) or not idx.is_contiguous()):
        raise ValueError(f"idx must be a contiguous (B, M, K) int32 tensor "
                         f"on {dev}, got {tuple(idx.shape)} {idx.dtype}")
    return idx.shape[2]


def _check_mask(mask, B, M, K, mid, dev):
    shape = ((mid + 31) // 32, B, M, K)
    if (mask.device != dev or mask.dtype != torch.int32
            or tuple(mask.shape) != shape or not mask.is_contiguous()):
        raise ValueError(f"mask must be a contiguous {shape} int32 tensor on "
                         f"{dev}, got {tuple(mask.shape)} {mask.dtype}")


def stats_cuda(radius, nsample, xyz, query_idx, feats, relative=True,
               normalize_dp=False):
    """Pass 1 on CUDA tensors; same outputs as :func:`stats_plain`."""
    global LAUNCHES_STATS
    _check_inputs(xyz, query_idx, feats)
    B, N, _ = xyz.shape
    M, C, K = query_idx.shape[1], feats.shape[2], int(nsample)
    W = C + 3
    _build.check_int32("sa_trainbn_stats", feats=B * N * C, rows=B * M * K * W)
    dev = xyz.device
    rt, grid, parts = _plan(STATS, B, M, K, C, 1, 1, DESIGN["stats"])
    idx = torch.empty((B, M, K), dtype=torch.int32, device=dev)
    part = torch.empty((grid, 68, 68), dtype=torch.float32, device=dev)
    out = torch.empty((W + W * W,), dtype=torch.float32, device=dev)
    lib = _lib()
    err = lib.sa_trainbn_stats_launch(
        xyz.data_ptr(), query_idx.data_ptr(), feats.data_ptr(), B, N, M, C,
        K, radius_sq(radius), _dp_scale(radius, relative, normalize_dp),
        int(bool(relative)), rt, grid, parts, idx.data_ptr(), part.data_ptr(),
        out.data_ptr(), _stream(dev))
    _build.check(lib, err, "sa_trainbn_stats")
    LAUNCHES_STATS += 1
    return idx, out[:W], out[W:].view(W, W)


def fwd_cuda(radius, xyz, query_idx, feats, idx, w1, a1, nb1, w2,
             relative=True, normalize_dp=False):
    """Pass 2 on CUDA tensors: :func:`fwd_plain`'s outputs, then ``wt``, the
    padded weight copies W1^T (mid rows of round8(W) floats) and W2^T (cout
    rows of round8(mid)) in one f32 tensor, which :func:`bwd_w2_cuda`
    reads."""
    global LAUNCHES_FWD
    _check_inputs(xyz, query_idx, feats)
    B, N, _ = xyz.shape
    M, C = query_idx.shape[1], feats.shape[2]
    dev = xyz.device
    K = _check_idx(idx, B, M, dev)
    w1, a1, nb1, w2 = _f32_rows(dev, ("w1", w1), ("a1", a1), ("nb1", nb1),
                                ("w2", w2))
    mid, cout = w2.shape
    if w1.shape != (C + 3, mid):
        raise ValueError(f"w1 {tuple(w1.shape)} does not chain with C={C} "
                         f"and w2 {tuple(w2.shape)}")
    _build.check_int32("sa_trainbn_fwd", feats=B * N * C,
                       rows=B * M * K * max(C + 3, mid, cout))
    rt, grid, ring = _plan(FWD, B, M, K, C, mid, cout, DESIGN["fwd"])

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    new_xyz, fi = empty(B, M, 3), empty(B, M, C)
    ymax, ymin = empty(B, M, cout), empty(B, M, cout)
    amax = empty(B, M, cout, dtype=torch.uint8)
    amin = empty(B, M, cout, dtype=torch.uint8)
    mask = empty((mid + 31) // 32, B, M, K, dtype=torch.int32)
    wt = empty(_wt_floats(C + 3, mid, cout))
    part, out = empty(grid, 2 * cout), empty(2 * cout)
    lib = _lib()
    err = lib.sa_trainbn_fwd_launch(
        xyz.data_ptr(), query_idx.data_ptr(), feats.data_ptr(),
        idx.data_ptr(), B, N, M, C, K,
        _dp_scale(radius, relative, normalize_dp), int(bool(relative)),
        w1.data_ptr(), a1.data_ptr(), nb1.data_ptr(), w2.data_ptr(), mid,
        cout, rt, grid, ring, wt.data_ptr(), new_xyz.data_ptr(),
        fi.data_ptr(), ymax.data_ptr(),
        ymin.data_ptr(), amax.data_ptr(), amin.data_ptr(), mask.data_ptr(),
        part.data_ptr(), out.data_ptr(), _stream(dev))
    _build.check(lib, err, "sa_trainbn_fwd")
    LAUNCHES_FWD += 1
    return (new_xyz, fi, ymax, ymin, amax, amin, out[:cout], out[cout:],
            mask, wt)


def _geometry(xyz, query_idx, feats, idx):
    _check_inputs(xyz, query_idx, feats)
    B, N, _ = xyz.shape
    M, C = query_idx.shape[1], feats.shape[2]
    dev = xyz.device
    return B, N, M, C, _check_idx(idx, B, M, dev), dev


def bwd_w2_cuda(radius, xyz, query_idx, feats, idx, w1, a1, nb1, w2, mu1,
                r1, a2, p2, q2c, slot, g_out, mask, wt, relative=True,
                normalize_dp=False):
    """Pass 3 on CUDA tensors; same outputs as :func:`bwd_w2_plain`
    (``g_y1p`` and ``y1`` views of (B*M*K, round8(mid)) buffers). ``wt`` is
    the weight copies that :func:`fwd_cuda` returned for the same w1 and w2,
    which it reads in their place."""
    global LAUNCHES_BWD_W2
    B, N, M, C, K, dev = _geometry(xyz, query_idx, feats, idx)
    W = C + 3
    w1, a1, nb1, w2, mu1, r1, a2, p2, q2c = _f32_rows(
        dev, ("w1", w1), ("a1", a1), ("nb1", nb1), ("w2", w2), ("mu1", mu1),
        ("r1", r1), ("a2", a2), ("p2", p2), ("q2c", q2c))
    mid, cout = w2.shape
    if w1.shape != (W, mid):
        raise ValueError(f"w1 {tuple(w1.shape)} does not chain with C={C} "
                         f"and w2 {tuple(w2.shape)}")
    if (slot.dtype != torch.uint8 or tuple(slot.shape) != (B, M, cout)
            or slot.device != dev):
        raise ValueError(f"slot must be (B, M, cout) uint8 on {dev}")
    _check_mask(mask, B, M, K, mid, dev)
    if (wt.device != dev or wt.dtype != torch.float32
            or tuple(wt.shape) != (_wt_floats(W, mid, cout),)
            or not wt.is_contiguous()):
        raise ValueError(f"wt must be the forward's weight copies, a "
                         f"contiguous ({_wt_floats(W, mid, cout)},) f32 "
                         f"tensor on {dev}, got {tuple(wt.shape)} "
                         f"{wt.dtype} on {wt.device}")
    slot = slot.contiguous()
    g_out = _cotangent(g_out, (B, M, cout), "g_out", dev)
    mid8, cout8, n = _round8(mid), _round8(cout), B * M * K
    rt_a, grid_a, ring_a = _plan(BWD_Y2, B, M, K, C, mid, cout,
                                 DESIGN["rows"])
    rt_b, grid_b, ring_b = _plan(BWD_GH, B, M, K, C, mid, cout,
                                 DESIGN["rows"])

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    w2p = empty(mid * cout8)
    y1, gy1, gy2 = empty(n, mid8), empty(n, mid8), empty(n, cout8)
    dw2_part, dw2 = empty(COPIES, mid, cout), empty(mid, cout)
    part, sums = empty(grid_b, 2 * mid), empty(2 * mid)
    lib = _lib()
    err = lib.sa_trainbn_bwd_w2_launch(
        xyz.data_ptr(), query_idx.data_ptr(), feats.data_ptr(),
        idx.data_ptr(), B, N, M, C, K,
        _dp_scale(radius, relative, normalize_dp), int(bool(relative)),
        w2.data_ptr(), a1.data_ptr(), nb1.data_ptr(), mask.data_ptr(),
        a2.data_ptr(), p2.data_ptr(), q2c.data_ptr(), slot.data_ptr(),
        g_out.data_ptr(), mu1.data_ptr(), r1.data_ptr(), mid, cout, rt_a,
        grid_a, rt_b, grid_b, ring_a, ring_b, wt.data_ptr(), w2p.data_ptr(),
        y1.data_ptr(), gy2.data_ptr(), gy1.data_ptr(), dw2_part.data_ptr(),
        dw2.data_ptr(), part.data_ptr(), sums.data_ptr(), _stream(dev))
    _build.check(lib, err, "sa_trainbn_bwd_w2")
    LAUNCHES_BWD_W2 += 1
    return (dw2, sums[:mid], sums[mid:],
            gy1.view(B, M, K, mid8)[..., :mid],
            y1.view(B, M, K, mid8)[..., :mid])


def bwd_x_cuda(radius, xyz, query_idx, feats, idx, w1, y1, g_y1p, a1, p1,
               q1c, g_fi=None, g_new=None, relative=True,
               normalize_dp=False):
    """Pass 4 on CUDA tensors; same outputs as :func:`bwd_x_plain`."""
    global LAUNCHES_BWD_X
    B, N, M, C, K, dev = _geometry(xyz, query_idx, feats, idx)
    W = C + 3
    w1, a1, p1, q1c = _f32_rows(dev, ("w1", w1), ("a1", a1), ("p1", p1),
                                ("q1c", q1c))
    mid = w1.shape[1]
    if w1.shape[0] != W:
        raise ValueError(f"w1 {tuple(w1.shape)} does not take C={C}")
    mid8 = _round8(mid)
    y1 = _rows_of(y1, (B, M, K, mid), mid8, "y1", dev)
    g_y1p = _rows_of(g_y1p, (B, M, K, mid), mid8, "g_y1p", dev)
    g_fi = _cotangent(g_fi, (B, M, C), "g_fi", dev)
    g_new = _cotangent(g_new, (B, M, 3), "g_new", dev)
    rt, grid, ring = _plan(BWD_X, B, M, K, C, mid, 1, DESIGN["rows"])
    wsplit = torch.empty((W * mid8,), dtype=torch.float32, device=dev)
    g_xyz = torch.empty((B, N, 3), dtype=torch.float32, device=dev)
    g_feats = torch.empty((B, N, C), dtype=torch.float32, device=dev)
    part = torch.empty((COPIES, W, mid), dtype=torch.float32, device=dev)
    out = torch.empty((W, mid), dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _lib()
    err = lib.sa_trainbn_bwd_x_launch(
        xyz.data_ptr(), query_idx.data_ptr(), feats.data_ptr(),
        idx.data_ptr(), B, N, M, C, K,
        _dp_scale(radius, relative, normalize_dp), int(bool(relative)),
        y1.data_ptr(), g_y1p.data_ptr(), a1.data_ptr(), p1.data_ptr(),
        q1c.data_ptr(), w1.data_ptr(), mid, ptr(g_fi), ptr(g_new), rt, grid,
        ring, wsplit.data_ptr(), g_xyz.data_ptr(),
        g_feats.data_ptr(), part.data_ptr(), out.data_ptr(), _stream(dev))
    _build.check(lib, err, "sa_trainbn_bwd_x")
    LAUNCHES_BWD_X += 1
    return g_xyz, g_feats, out


class SaTrainBN(torch.autograd.Function):
    """The stage as four passes: the kernels when ``use_kernels`` (CUDA
    tensors), the plain passes otherwise (CPU tensors), with the same algebra
    between them. Returns ``(new_xyz,
    fi, out, mu1, var1, mu2, var2)``; the statistics take no gradient, nor
    does ``query_idx``."""

    @staticmethod
    def forward(ctx, xyz, query_idx, feats, w1, gamma1, beta1, w2, gamma2,
                beta2, radius, nsample, relative, normalize_dp, eps,
                use_kernels):
        B, M = query_idx.shape
        n = B * M * int(nsample)
        stats, fwd = ((stats_cuda, fwd_cuda) if use_kernels
                      else (stats_plain, fwd_plain))
        idx, sv, svv = stats(radius, nsample, xyz, query_idx, feats,
                             relative, normalize_dp)
        mu1, var1, r1, a1, nb1 = _bn1(sv, svv, w1, gamma1, beta1, n, eps)
        # the kernels' forward also returns its weight copies, which pass 3
        # reads
        new_xyz, fi, ymax, ymin, amax, amin, s2, q2, mask, *wt = fwd(
            radius, xyz, query_idx, feats, idx, w1, a1, nb1, w2, relative,
            normalize_dp)
        mu2, var2, r2, a2, c2 = _bn2(s2, q2, gamma2, beta2, n, eps)
        pos = a2 > 0
        ystar = torch.where(pos, ymax, ymin)
        slot = torch.where(pos, amax, amin)
        out = a2 * ystar + c2
        ctx.save_for_backward(xyz, query_idx, feats, w1, gamma1, w2, idx,
                              mu1, r1, a1, nb1, mu2, r2, a2, ystar, slot,
                              mask, *wt)
        ctx.args = (radius, relative, normalize_dp, use_kernels, n)
        ctx.mark_non_differentiable(mu1, var1, mu2, var2)
        if not ctx.needs_input_grad[0]:
            ctx.mark_non_differentiable(new_xyz)
        ctx.set_materialize_grads(False)
        return new_xyz, fi, out, mu1, var1, mu2, var2

    @staticmethod
    def backward(ctx, g_new, g_fi, g_out, *_g_stats):
        (xyz, query_idx, feats, w1, gamma1, w2, idx, mu1, r1, a1, nb1, mu2,
         r2, a2, ystar, slot, mask, *wt) = ctx.saved_tensors
        radius, relative, normalize_dp, use_kernels, n = ctx.args
        bwd_w2, bwd_x = ((bwd_w2_cuda, bwd_x_cuda) if use_kernels
                         else (bwd_w2_plain, bwd_x_plain))
        if g_out is None:
            g_out = torch.zeros_like(ystar)
        # BN2's sums need only the pooled tensors: the cotangent of the
        # slots is zero but at each output's winning slot
        xhat2 = (ystar - mu2) * r2
        d_beta2 = g_out.sum(dim=(0, 1))
        d_gamma2 = (g_out * xhat2).sum(dim=(0, 1))
        p2, q2c = _bwd_consts(d_beta2 / n, d_gamma2 / n, a2, mu2, r2)
        # pass 3 hands y1 and g_y1' to pass 4, which frees them on return
        dw2, sg1, sgx1, g_y1p, y1 = bwd_w2(
            radius, xyz, query_idx, feats, idx, w1, a1, nb1, w2, mu1, r1,
            a2, p2, q2c, slot, g_out, mask, *wt, relative, normalize_dp)
        p1, q1c = _bwd_consts(sg1 / n, sgx1 / n, a1, mu1, r1)
        need = ctx.needs_input_grad
        g_xyz = g_feats = dw1 = None
        if need[0] or need[2] or need[3]:
            g_xyz, g_feats, dw1 = bwd_x(
                radius, xyz, query_idx, feats, idx, w1, y1, g_y1p, a1, p1,
                q1c, g_fi, g_new, relative, normalize_dp)
        del g_y1p, y1
        grads = (g_xyz, None, g_feats, dw1, sgx1, sg1, dw2, d_gamma2,
                 d_beta2)
        return tuple(g if nd else None for g, nd in zip(grads, need[:9])) \
            + (None,) * 6
