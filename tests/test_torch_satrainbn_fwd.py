"""The fused train-BN stage's statistics and forward passes (rows 16 and 17)
in the kernels' numerics, on the CPU.

On the card the forward takes its products (y1 = v W1, y2 = h W2) on the
tensor cores as 3xTF32 (``satrainbn.tf32x3_mm``), as the backward passes do,
and the statistics (Sv = v^T 1, Svv = v^T v) take f32 FMAs. Here the plain
passes take them through ``satrainbn._mm_fwd``, ``_mm`` and ``_mm_stats``,
which these tests swap, and hold:

- the stage's seven forward outputs and statistics, with the forward's
  products in 3xTF32, against the TPU kernel family ``sa_trainbn_pallas``
  run in interpret mode, at the rtol 2e-4 / atol 2e-5 of
  ``test_torch_satrainbn.py``'s forward test;
- all eight cotangents, with the forward's and the backward's products in
  3xTF32, against the JAX unfused oracle at that file's 5e-4;
- the stage at |mean| / std = 1, 10, 100 of its conv1 outputs in the card's
  numerics, to the bounds of ``test_torch_train_fused.py``'s
  ``test_the_train_routes_as_the_mean_outgrows_the_spread``; and, with the
  statistics in 3xTF32 as well, the same stage leaving those bounds at 10
  and 100 (BN1's variance is flax's E[y^2] - E[y]^2 from Svv, which cancels:
  why the statistics kernel keeps f32 products).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaptpoint_tpu_torch.ops import satrainbn

from test_torch_satrainbn import NAMES, _cotangents, _oracle, _port, _problem
from test_torch_train_fused import (C1_TOL, _c1_jax, _c1_port, _c1_problem,
                                    _c1_worst)


def _tf32x3(monkeypatch, backward=False, stats=False):
    """The forward's products (with ``backward`` the backward's too, with
    ``stats`` the statistics' too) in 3xTF32; returns the list the
    forward's swapped products append to."""
    calls = []

    def mm(a, b):
        calls.append(1)
        return satrainbn.tf32x3_mm(a, b)

    monkeypatch.setattr(satrainbn, "_mm_fwd", mm)
    if backward:
        monkeypatch.setattr(satrainbn, "_mm", satrainbn.tf32x3_mm)
    if stats:
        monkeypatch.setattr(satrainbn, "_mm_stats", satrainbn.tf32x3_mm)
    return calls


@pytest.mark.parametrize("radius,norm_dp", [(0.35, True), (0.6, False)])
def test_the_forward_in_tf32x3_matches_the_tpu_kernel(monkeypatch, radius,
                                                      norm_dp):
    monkeypatch.setenv("ADAPTPOINT_TPU_PALLAS_INTERPRET", "1")
    from adaptpoint_tpu.ops.pallas.satrainbn import sa_trainbn_pallas
    calls = _tf32x3(monkeypatch)
    xyz, feats, qidx, params = _problem()
    ref = sa_trainbn_pallas(radius, 8, jnp.asarray(xyz), jnp.asarray(qidx),
                            jnp.asarray(feats),
                            *[jnp.asarray(p) for p in params],
                            normalize_dp=norm_dp)
    got, _ = _port(radius, xyz, feats, qidx, params, norm_dp)
    assert len(calls) == 2  # y1, y2
    for r, g, name in zip(ref, got, ("new_xyz", "fi", "out", "mu1", "var1",
                                     "mu2", "var2")):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r),
                                   rtol=2e-4, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("radius,norm_dp", [(0.35, True), (0.0, False)],
                         ids=["short-balls", "empty-balls"])
def test_the_card_numerics_match_the_jax_oracle(monkeypatch, radius,
                                                norm_dp):
    """All eight cotangents with the forward's and the backward's products
    in 3xTF32 and the statistics in f32, as the kernels take them."""
    calls = _tf32x3(monkeypatch, backward=True)
    xyz, feats, qidx, params = _problem(seed=3)
    r_new, r_fi, r_out = _cotangents()

    def loss(xyz, feats, w1, g1, b1, w2, g2, b2):
        new_xyz, fi, out = _oracle(radius, 8, xyz, jnp.asarray(qidx), feats,
                                   w1, g1, b1, w2, g2, b2, norm_dp)[:3]
        return (jnp.sum(out * r_out) + jnp.sum(fi * r_fi)
                + jnp.sum(new_xyz * r_new))

    ref = jax.grad(loss, argnums=tuple(range(8)))(
        jnp.asarray(xyz), jnp.asarray(feats),
        *[jnp.asarray(p) for p in params])
    out, leaves = _port(radius, xyz, feats, qidx, params, norm_dp)
    total = ((out[2] * torch.from_numpy(r_out)).sum()
             + (out[1] * torch.from_numpy(r_fi)).sum()
             + (out[0] * torch.from_numpy(r_new)).sum())
    got = torch.autograd.grad(total, leaves)
    assert len(calls) == 2
    for r, g, name in zip(ref, got, NAMES):
        r, g = np.asarray(r), g.numpy()
        if name == "gamma2":
            r, g = r[1:], g[1:]  # the kink at gamma2 == 0 (see the oracle)
        scale = max(1e-3, float(np.abs(r).max()))
        np.testing.assert_allclose(g, r, rtol=5e-4, atol=5e-4 * scale,
                                   err_msg=name)


def _c1_routes(ratio, monkeypatch, stats):
    problem = _c1_problem(ratio)
    unfused = _c1_port(False, problem)
    unfused64 = _c1_port(False, problem, torch.float64)
    jax_fused = _c1_jax(problem, monkeypatch)
    calls = _tf32x3(monkeypatch, backward=True, stats=stats)
    fused = _c1_port(True, problem)
    assert len(calls) == 2
    return {"fused_jax": _c1_worst(fused, jax_fused),
            "unfused_fused": _c1_worst(unfused, fused),
            "unfused_f64": _c1_worst(unfused, unfused64)}


@pytest.mark.parametrize("ratio", sorted(C1_TOL))
def test_the_card_numerics_as_the_mean_outgrows_the_spread(monkeypatch,
                                                           ratio):
    """The port's fused route in the card's numerics (forward and backward
    products in 3xTF32, the statistics in f32) against the JAX fused
    oracle, the unfused route and its float64 twin, at the bounds the f32
    route is held to."""
    worst = _c1_routes(ratio, monkeypatch, stats=False)
    for pair, (d, name) in worst.items():
        assert d <= C1_TOL[ratio][pair], (pair, d, name)


@pytest.mark.parametrize("ratio", [10, 100])
def test_tf32x3_statistics_leave_the_bounds_as_the_mean_outgrows_the_spread(
        monkeypatch, ratio):
    """With the statistics' products in 3xTF32 too, the fused route moves
    from the JAX fused oracle past its bound (read 1.9e-2 at both ratios,
    in BN1's beta): 3xTF32 represents each entry of v to 2^-21, and
    E[y^2] - E[y]^2 loses ratio^2 of that."""
    worst = _c1_routes(ratio, monkeypatch, stats=True)
    assert worst["fused_jax"][0] > C1_TOL[ratio]["fused_jax"], worst
