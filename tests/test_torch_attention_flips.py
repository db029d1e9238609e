"""Row 10's f32 backward check (ROADMAP C.11) on the CPU.

The function rounds the f32 dS to bf16 before dq = bf16(dS) bf16(k) and
dk = bf16(dS)^T bf16(q) (``ops/attention.py`` ``mha_bwd_plain``). Two
correct computations of dS, the kernel's and the plain version's, differ in
their last bits: the kernel's row term ``rowsum(dP * P)`` is ``bf16(do) .
o32`` with P carried to 16 bits, and its softmax's row sum and its row term
sum N terms in other orders. Where dS lies that close to a bf16 rounding
midpoint, its rounding flips by one bf16 ulp. At C.11's shape, (3, 100, 32)
with f32 inputs and scale sqrt(32), on seeded numpy draws:

- a few f32 ulps of dS already flip roundings and move dq and dk; two f32
  values of one dS entry 2 ulps apart, astride a midpoint, give dq 3.25e-3
  apart or more (C.11's reading on the H100, ROADMAP C.11);
- the kernel, replayed here step by step in f32 (``_replay``: its forward's
  row_off, row_inv and o32, then its backward's dS), flips 9-17 roundings a
  draw against the plain version.

The check (``chip_smoke.py`` ``check_mha_shape``) holds out and dv to their
plain versions within ``TOL_MHA * (1 + |plain|)``; dq and dk to that of the
dS formed in f64 from the kernel's own saved statistics
(``mha_stats_reference``), plus what flips within the derived f32 gap
``delta`` between that dS and the kernel's can move them by; the saved
statistics to the function (``row_sum``, ``o32`` <= 1). Here the replay lies
inside ``delta`` everywhere and passes the rule on eight draws, and the rule
catches, at C.11's shape and at N = 2047 for head dims 16 and 64, a dq or dk
entry off by 1e-2 (f32: at the entry of largest allowance too), 3e-3 added
to every entry (at N = 2047 caught wherever ``TOL_MHA`` alone catches it;
at N = 100 at all but under 1 % of those entries), a wrong scale, and saved
statistics off by 1e-3 or o32 without P's low bits.
"""
import os
import sys

import numpy as np
import pytest
import torch

from adaptpoint_tpu_torch.ops import attention

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from chip_smoke import (TOL_MHA, _mha_ref_chunks, mha_kernel_scale,  # noqa
                        mha_scaled, mha_stats_reference)

SHAPE, SCALE = (3, 100, 32), 32 ** 0.5
C11_DQ = 3.25e-3  # dq's distance on C.11's draw on the H100 (ROADMAP C.11)
_b = attention._b


def _inputs(seed, shape=SHAPE, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(dtype) for _ in range(4)]


def _plain_ds(q, k, v, scale, do):
    p = attention._softmax_plain(q, k, scale)
    dp = torch.matmul(_b(do), _b(v).transpose(1, 2))
    return p * (dp - (dp * p).sum(dim=-1, keepdim=True)) / scale


def _replay(q, k, v, scale, do):
    """The kernels' steps in f32 (``csrc/attention.cu``): the forward's
    ``(o32, row_off, row_inv)`` (row_off = -max_j S_ij c, P = ex2(fma(S, c,
    row_off)) * row_inv, o32 = (bf16(P) + bf16(P - bf16(P))) bf16(v)) and
    the backward's dS = P (dP - bf16(do) . o32) / scale, the division folded
    into V and the row term where the scale is a power of two."""
    s32, c, pow2 = mha_kernel_scale(scale)
    bq, bk, bv, bdo = (_b(t) for t in (q, k, v, do))
    s = torch.matmul(bq, bk.transpose(1, 2))
    off = -(s.amax(dim=-1, keepdim=True) * c)
    e2 = torch.exp2((s.double() * c + off.double()).float())  # one fma
    inv = 1.0 / e2.sum(dim=-1, keepdim=True)
    p = e2 * inv
    p_hi = _b(p)
    o32 = torch.matmul(p_hi, bv) + torch.matmul(_b(p - p_hi), bv)
    vmul = 1.0 / s32 if pow2 else 1.0
    dp = torch.matmul(bdo, (bv * vmul).transpose(1, 2))
    ds = p * (dp - (bdo * o32).sum(dim=-1, keepdim=True) * vmul)
    if not pow2:
        ds = ds / s32
    return (o32, off[..., 0], inv[..., 0]), ds


def _grads(ds, q, k, dtype=torch.float32):
    dsb = _b(ds)
    return ((dsb @ _b(k)).to(dtype), (dsb.transpose(1, 2) @ _b(q)).to(dtype))


@pytest.mark.parametrize("ulps", [1, 2, 4, 8])
def test_a_few_ulps_of_ds_flip_its_roundings(ulps):
    """dS moved by up to ``ulps`` f32 ulps either way: some bf16 roundings
    flip (over eight draws), and each flip moves dq and dk by exactly its
    bf16 step times |bf16(k)| or |bf16(q)|."""
    flips, moved = 0, 0.0
    for seed in range(8):
        q, k, v, do = _inputs(seed)
        ds = _plain_ds(q, k, v, SCALE, do)
        up, dn = ds.clone(), ds.clone()
        for _ in range(ulps):
            up = torch.nextafter(up, torch.full_like(up, np.inf))
            dn = torch.nextafter(dn, torch.full_like(dn, -np.inf))
        base = _b(ds)
        pert = torch.where(_b(up) != base, up,
                           torch.where(_b(dn) != base, dn, ds))
        flipped = _b(pert) != base
        flips += int(flipped.sum())
        dq0, dk0 = _grads(ds, q, k)
        dq1, dk1 = _grads(pert, q, k)
        step = _b(pert) - base
        torch.testing.assert_close(dq1 - dq0, step @ _b(k), rtol=0,
                                   atol=1e-6)
        torch.testing.assert_close(dk1 - dk0, step.transpose(1, 2) @ _b(q),
                                   rtol=0, atol=1e-6)
        moved = max(moved, float((dq1 - dq0).abs().max()),
                    float((dk1 - dk0).abs().max()))
    print(f"{ulps} ulps: {flips} flips over 8 draws, dq/dk moved by up to "
          f"{moved:.3g}")
    assert flips > 0 and moved > 0.0
    if ulps == 8:
        assert flips >= 8 and moved > 1e-4


def test_two_ulps_at_a_midpoint_move_dq_as_far_as_c11():
    """Where a dS entry lies at a bf16 rounding midpoint, the two f32 values
    one ulp either side of it, both within an ulp of the exact dS, round
    one bf16 ulp apart: at the entry whose ulp times |bf16(k)| is largest
    (one a draw), dq moves by as much as C.11's 3.25e-3, past TOL_MHA."""
    reached = 0.0
    for seed in range(8):
        q, k, v, do = _inputs(seed)
        ds = _plain_ds(q, k, v, SCALE, do)
        bk = _b(k)
        ulp = (torch.nextafter(_b(ds).abs().to(torch.bfloat16),
                               torch.tensor(np.inf, dtype=torch.bfloat16))
               .float() - _b(ds).abs())  # a bf16 ulp of each entry
        h, i, j = np.unravel_index(int(ulp.argmax()), ulp.shape)
        mid = _b(ds)[h, i, j] + torch.sign(ds[h, i, j]) * ulp[h, i, j] / 2
        lo, hi = ds.clone(), ds.clone()
        lo[h, i, j] = torch.nextafter(mid, torch.tensor(-np.inf))
        hi[h, i, j] = torch.nextafter(mid, torch.tensor(np.inf))
        assert _b(lo)[h, i, j] != _b(hi)[h, i, j]
        dq_lo, _ = _grads(lo, q, k)
        dq_hi, _ = _grads(hi, q, k)
        moved = float((dq_hi - dq_lo).abs().max())
        torch.testing.assert_close(moved, float(ulp[h, i, j]
                                                * bk[h, j].abs().max()),
                                   rtol=0, atol=1e-7)
        reached = max(reached, moved)
    print(f"largest move from 2 ulps at a midpoint: {reached:.4g} "
          f"(C.11: {C11_DQ})")
    assert reached >= C11_DQ > TOL_MHA


@pytest.mark.parametrize("seed", range(8))
def test_the_kernels_replay_flips_against_plain_and_lies_inside_the_gap(
        seed):
    """The replayed kernel's dS flips roundings against the plain version's
    (C.11's mechanism) and moves dq; against the dS formed from its own
    saved statistics it lies inside ``delta`` everywhere, its flips are
    among the entries the bound counts (under 3 % of them), the saved
    statistics pass, and dq and dk pass the check's rule."""
    q, k, v, do = _inputs(seed)
    saved, dsk = _replay(q, k, v, SCALE, do)
    ds_plain = _plain_ds(q, k, v, SCALE, do)
    against_plain = int((_b(dsk) != _b(ds_plain)).sum())
    dq, dk, _ = attention.mha_bwd_plain(q, k, v, SCALE, do)
    dqk, dkk = _grads(dsk, q, k)
    moved = float((dqk - dq).abs().max())
    assert against_plain >= 5 and 0.0 < moved < 1e-3
    (_, ds, delta, row_sum, o32), = _mha_ref_chunks(q, k, v, SCALE, do,
                                                     saved)
    assert bool(((dsk.double() - ds).abs() <= delta).all())
    candidates = (_b(ds - delta) != _b(ds + delta))
    flipped = _b(dsk) != _b(ds)
    assert bool(candidates[flipped].all())
    held = mha_stats_reference(q, k, v, SCALE, do, saved)
    assert held["flips"] == int(candidates.sum()) < 0.03 * ds.numel()
    assert max(row_sum, o32, held["row_sum"], held["o32"]) <= 1.0
    assert mha_scaled(dqk, held["dq"], held["allow_dq"])[0] <= TOL_MHA
    assert mha_scaled(dkk, held["dk"], held["allow_dk"])[0] <= TOL_MHA


@pytest.mark.parametrize("shape,scale,dtype", [
    (SHAPE, SCALE, torch.float32), (SHAPE, SCALE, torch.bfloat16),
    ((2, 2047, 16), 4.0, torch.float32),
    ((2, 2047, 16), 4.0, torch.bfloat16),
    ((2, 2047, 64), 8.0, torch.float32)])
def test_the_rule_catches_defects_that_are_not_flips(shape, scale, dtype):
    """The replayed kernel passes the rule; an entry of dq or dk off by 1e-2
    (f32: at the entry of largest allowance too), 3e-3 added to every entry
    (f32, where TOL_MHA alone would catch it: at N = 2047 caught at every
    such entry, at N = 100 at all but 1 % of them; the bf16 gradients'
    stored ulp is wider than 3e-3), and the gradients at a wrong scale
    fail it; dv keeps TOL_MHA with no allowance. bf16 inputs take one more
    bf16 ulp for their stored gradients, as the check does."""
    tol = TOL_MHA if dtype == torch.float32 else TOL_MHA + 2.0 ** -8
    wrong = 4.0 if scale != 4.0 else 2.0
    for seed in range(1 if shape[1] > 1000 else 3):
        q, k, v, do = _inputs(seed, shape, dtype)
        do = do.float()
        saved, dsk = _replay(q, k, v, scale, do)
        held = mha_stats_reference(q, k, v, scale, do, saved)
        assert max(held["row_sum"], held["o32"]) <= 1.0
        dv = attention.mha_bwd_plain(q, k, v, scale, do)[2]
        for name, got in zip(("dq", "dk"), _grads(dsk, q, k, dtype)):
            ref, allow = held[name], held["allow_" + name]
            assert mha_scaled(got, ref, allow)[0] <= tol
            worst = [np.unravel_index(int(allow.argmax()), allow.shape)]
            for at in [(0, 0, 0), (1, shape[1] // 2, shape[2] - 1)] + (
                    worst if dtype == torch.float32 else []):
                bad = got.float().clone()
                bad[tuple(int(a) for a in at)] += 1e-2
                assert mha_scaled(bad, ref, allow)[0] > tol, (name, at)
            if dtype == torch.float32:
                den = 1.0 + ref.abs()
                d0 = (got.double() - ref).abs()
                d3 = (got.double() + 3e-3 - ref).abs()
                base = d3 / den > tol  # TOL_MHA alone catches these
                passed = ((d3 - allow).clamp(min=0.0) / den <= tol) & base
                share = float(passed.sum()) / float(base.sum())
                print(f"{shape} {name}: max allowance "
                      f"{float(allow.max()):.3g}, 3e-3 passes at {share:.3g}"
                      f" of {int(base.sum())}, now {float(d0.max()):.3g}")
                assert share == 0.0 if shape[1] > 1000 else share < 0.01
        wq, wk, wv = attention.mha_bwd_plain(q, k, v, wrong, do)
        assert mha_scaled(wq, held["dq"], held["allow_dq"])[0] > tol
        assert mha_scaled(wk, held["dk"], held["allow_dk"])[0] > tol
        assert mha_scaled(wv, dv)[0] > tol  # dv with no allowance


@pytest.mark.parametrize("defect", ["row_inv", "row_off", "o32_high_bits"])
def test_the_saved_statistics_are_held_to_the_function(defect):
    """Statistics the kernel could get wrong fail their check: row_inv off
    by a factor 1 + 1e-3, row_off by 1e-3 (P by 2^1e-3), or o32 from
    bf16(P) alone (P's low bits dropped)."""
    for seed in range(3):
        q, k, v, do = _inputs(seed)
        (o32, off, inv), _ = _replay(q, k, v, SCALE, do)
        if defect == "row_inv":
            inv = inv * (1 + 1e-3)
        elif defect == "row_off":
            off = off + 1e-3
        else:
            p = attention._softmax_plain(q, k, SCALE)
            o32 = _b(p) @ _b(v)
        held = mha_stats_reference(q, k, v, SCALE, do, (o32, off, inv))
        key = "o32" if defect == "o32_high_bits" else "row_sum"
        assert held[key] > 1.0, (seed, held[key])
