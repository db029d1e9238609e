"""The port's plain ops (adaptpoint_tpu_torch.ops, CPU) against the JAX package.

The same numpy inputs go through both packages. The port's CPU branch is the
plain PyTorch version each CUDA kernel is held to on the card, so these pin
the kernels' function to the JAX reference:

- FPS against the Pallas kernel in interpret mode and the XLA version: exact.
- Ball group against ``adaptpoint_tpu.ops.ball_group`` on its XLA route (the
  JAX package keeps that route bit-identical to ``ball_group_pallas``):
  idx/new_xyz/fi/fj exact, dp within 1e-6 because the kernel multiplies by
  f32(1/r) where the composite divides.
- Fused eval SA against ``sa_eval_pallas`` in interpret mode.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adaptpoint_tpu.ops import ball_group as jax_ball_group
from adaptpoint_tpu.ops.geometry import (ball_query_xla,
                                         furthest_point_sample_xla)
from adaptpoint_tpu.ops.pallas.fps import furthest_point_sample_pallas
from adaptpoint_tpu_torch import ops


def _cloud(seed, B, N, C=0, scale=0.5):
    rng = np.random.default_rng(seed)
    xyz = (rng.standard_normal((B, N, 3)) * scale).astype(np.float32)
    feats = rng.standard_normal((B, N, C)).astype(np.float32)
    return rng, xyz, feats


@pytest.mark.parametrize("N,npoint", [(256, 64), (200, 50), (130, 1)])
def test_fps_matches_pallas_and_xla(N, npoint):
    _, xyz, _ = _cloud(N, 2, N)
    got = ops.furthest_point_sample(torch.from_numpy(xyz), npoint).numpy()
    assert got.dtype == np.int32 and got.shape == (2, npoint)
    pallas = np.asarray(furthest_point_sample_pallas(jnp.asarray(xyz),
                                                     npoint, True))
    xla = np.asarray(furthest_point_sample_xla(jnp.asarray(xyz), npoint))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, xla)


def test_ball_query_empty_and_partial_balls():
    """Centers far from the cloud get an all-zero row (empty ball); a small
    radius leaves partial balls padded with their first index."""
    rng, xyz, _ = _cloud(3, 2, 96)
    centers = xyz[:, :20].copy()
    centers[:, :5] += 50.0  # empty balls
    got = ops.ball_query(0.2, 8, torch.from_numpy(xyz),
                         torch.from_numpy(centers)).numpy()
    ref = np.asarray(ball_query_xla(0.2, 8, jnp.asarray(xyz),
                                    jnp.asarray(centers)))
    np.testing.assert_array_equal(got, ref)
    assert (got[:, :5] == 0).all()
    counts = [len(set(r)) for r in got[:, 5:].reshape(-1, 8)]
    assert min(counts) < 8  # some partial balls were padded


@pytest.mark.parametrize("radius,normalize_dp,relative,M", [
    (0.3, True, True, 30),     # partial balls, M not a multiple of 8
    (0.6, False, True, 32),    # mostly full balls, no dp scaling
    (0.0, False, True, 12),    # r=0: every ball is empty -> index 0
    (0.4, True, False, 17),    # absolute xyz
])
def test_ball_group_matches_jax(radius, normalize_dp, relative, M):
    rng, xyz, feats = _cloud(7, 2, 128, C=16)
    qidx = rng.integers(0, 128, (2, M)).astype(np.int32)
    got = ops.ball_group(radius, 8, torch.from_numpy(xyz),
                         torch.from_numpy(qidx), torch.from_numpy(feats),
                         relative=relative, normalize_dp=normalize_dp)
    ref = jax_ball_group(radius, 8, jnp.asarray(xyz), jnp.asarray(qidx),
                         jnp.asarray(feats), relative=relative,
                         normalize_dp=normalize_dp)
    new_xyz, fi, dpfj, idx = (t.numpy() for t in got)
    r_new, r_fi, r_dpfj, r_idx = (np.asarray(t) for t in ref)
    assert dpfj.shape == r_dpfj.shape == (2, 8, M, 19)
    np.testing.assert_array_equal(idx, r_idx)
    np.testing.assert_array_equal(new_xyz, r_new)
    np.testing.assert_array_equal(fi, r_fi)
    np.testing.assert_array_equal(dpfj[..., 3:], r_dpfj[..., 3:])
    # 1 ulp: f32(1/r) multiply (the kernel's) vs the composite's divide
    np.testing.assert_allclose(dpfj[..., :3], r_dpfj[..., :3], rtol=0,
                               atol=1e-6)
    if radius == 0.0:
        assert (idx == 0).all()


def test_fused_sa_matches_pallas_interpret(monkeypatch):
    monkeypatch.setenv("ADAPTPOINT_TPU_PALLAS_INTERPRET", "1")
    from adaptpoint_tpu.ops.pallas.saeval import sa_eval_pallas
    rng, xyz, feats = _cloud(11, 2, 128, C=16)
    qidx = rng.integers(0, 128, (2, 32)).astype(np.int32)
    w1 = (rng.standard_normal((19, 16)) * 0.3).astype(np.float32)
    b1 = (rng.standard_normal(16) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((16, 32)) * 0.3).astype(np.float32)
    b2 = (rng.standard_normal(32) * 0.1).astype(np.float32)
    args = (xyz, qidx, feats, w1, b1, w2, b2)
    got = ops.sa_eval(0.3, 8, *(torch.from_numpy(a) for a in args),
                      relative=True, normalize_dp=True)
    ref = sa_eval_pallas(0.3, 8, *(jnp.asarray(a) for a in args),
                         relative=True, normalize_dp=True)
    new_xyz, fi, out = (t.numpy() for t in got)
    r_new, r_fi, r_out = (np.asarray(t) for t in ref)
    np.testing.assert_array_equal(new_xyz, r_new)
    fb = torch.from_numpy(feats).bfloat16().float().numpy()
    np.testing.assert_array_equal(fi, np.take_along_axis(
        fb, qidx[..., None].astype(np.int64), axis=1))
    np.testing.assert_array_equal(fi, r_fi)
    # both sides feed bf16-rounded operands to f32-accumulated products; a
    # different accumulation order can flip one bf16 rounding of h
    np.testing.assert_allclose(out, r_out, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("relative,normalize_dp", [(True, True), (False, False)])
def test_query_and_group_matches_jax(relative, normalize_dp):
    from adaptpoint_tpu.models.layers.group_layers import \
        QueryAndGroup as JaxQueryAndGroup
    from adaptpoint_tpu_torch.models.layers import QueryAndGroup
    rng, xyz, feats = _cloud(13, 2, 96, C=6)
    centers = xyz[:, :24]
    got = QueryAndGroup(0.35, 8, relative, normalize_dp)(
        torch.from_numpy(centers), torch.from_numpy(xyz),
        torch.from_numpy(feats))
    ref = JaxQueryAndGroup(0.35, 8, relative, normalize_dp)(
        jnp.asarray(centers), jnp.asarray(xyz), jnp.asarray(feats))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
