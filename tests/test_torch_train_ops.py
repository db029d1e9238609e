"""The port's differentiable ops (CPU, plain versions) against the JAX package.

The same numpy inputs and cotangents go through both packages:

- Ball-group gradients: ``jax.vjp`` of ``adaptpoint_tpu.ops.ball_group`` on
  its XLA route against ``torch.autograd.grad`` of ``ops.ball_group`` and
  against ``ball_group_bwd_plain`` (the scatter-add the CUDA backward kernel
  is held to on the card), rtol 1e-5 / atol 1e-6 (1e-5 where a hundred
  addends meet on one row): the sums run in another order, and dp is
  multiplied by f32(1/r) where the XLA composite divides.
- ``gather_rows``: forward exact, backward within 1e-6 of the VJP of the
  XLA gather, with repeated indices, f32 and bf16.
- ``resample_points`` with the drawn columns injected: equal clouds, exact.
- ``knn_point``, ``three_nn``, ``three_interpolation`` against
  ``adaptpoint_tpu/ops/geometry.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaptpoint_tpu.engine import cls_trainer as jax_trainer
from adaptpoint_tpu.ops import _index_points_xla
from adaptpoint_tpu.ops import ball_group as jax_ball_group
from adaptpoint_tpu.ops import geometry as jax_geometry
from adaptpoint_tpu_torch import ops
from adaptpoint_tpu_torch.engine import resample_points
from adaptpoint_tpu_torch.ops.ballgroup import ball_group_bwd_plain
from adaptpoint_tpu_torch.ops.gather import (gather_rows_bwd_plain,
                                             gather_rows_plain)


def _cloud(seed, B, N, C=0, scale=0.5):
    rng = np.random.default_rng(seed)
    xyz = (rng.standard_normal((B, N, 3)) * scale).astype(np.float32)
    feats = rng.standard_normal((B, N, C)).astype(np.float32)
    return rng, xyz, feats


BALL_CASES = [
    (0.3, True, True, 30),     # partial balls, M not a multiple of 8
    (0.6, False, True, 32),    # mostly full balls, no dp scaling
    (0.0, False, True, 12),    # r=0: every ball is empty -> index 0
    (0.4, True, False, 17),    # absolute xyz
]


def _atol(radius):
    """1e-6 for sums of a few unit-scale addends; at r=0 all M*K + M
    cotangents of a cloud (108 and more) add onto support row 0, and a
    reordered f32 sum of that many moves by more."""
    return 1e-5 if radius == 0.0 else 1e-6


def _ball_case(radius, normalize_dp, relative, M):
    rng, xyz, feats = _cloud(7, 2, 128, C=16)
    qidx = rng.integers(0, 128, (2, M)).astype(np.int32)
    cot = (rng.standard_normal((2, M, 3)).astype(np.float32),
           rng.standard_normal((2, M, 16)).astype(np.float32),
           rng.standard_normal((2, 8, M, 19)).astype(np.float32))

    def jfn(x, f):
        return jax_ball_group(radius, 8, x, jnp.asarray(qidx), f,
                              relative=relative,
                              normalize_dp=normalize_dp)[:3]

    _, vjp = jax.vjp(jfn, jnp.asarray(xyz), jnp.asarray(feats))
    r_xyz, r_feats = (np.asarray(g) for g in vjp(tuple(
        jnp.asarray(c) for c in cot)))
    return xyz, feats, qidx, cot, r_xyz, r_feats


@pytest.mark.parametrize("radius,normalize_dp,relative,M", BALL_CASES)
def test_ball_group_grads_match_jax_vjp(radius, normalize_dp, relative, M):
    xyz, feats, qidx, cot, r_xyz, r_feats = _ball_case(
        radius, normalize_dp, relative, M)
    x = torch.from_numpy(xyz).requires_grad_()
    f = torch.from_numpy(feats).requires_grad_()
    out = ops.ball_group(radius, 8, x, torch.from_numpy(qidx), f,
                         relative=relative, normalize_dp=normalize_dp)
    assert not out[3].requires_grad
    g_xyz, g_feats = torch.autograd.grad(
        out[:3], (x, f), [torch.from_numpy(c) for c in cot])
    atol = _atol(radius)
    np.testing.assert_allclose(g_feats.numpy(), r_feats, rtol=1e-5, atol=atol)
    np.testing.assert_allclose(g_xyz.numpy(), r_xyz, rtol=1e-5, atol=atol)
    if radius == 0.0:  # every slot of every ball lands on support row 0
        assert np.abs(r_feats[:, 0]).sum() > 0


@pytest.mark.parametrize("radius,normalize_dp,relative,M", BALL_CASES)
def test_ball_group_bwd_plain_matches_jax_vjp(radius, normalize_dp, relative,
                                              M):
    xyz, feats, qidx, cot, r_xyz, r_feats = _ball_case(
        radius, normalize_dp, relative, M)
    with torch.no_grad():
        idx = ops.ball_group(radius, 8, torch.from_numpy(xyz),
                             torch.from_numpy(qidx), torch.from_numpy(feats),
                             relative=relative, normalize_dp=normalize_dp)[3]
    g_new, g_fi, g_dpfj = (torch.from_numpy(c) for c in cot)
    g_xyz, g_feats = ball_group_bwd_plain(
        radius, idx, torch.from_numpy(qidx), g_new, g_fi, g_dpfj, 128,
        relative, normalize_dp)
    atol = _atol(radius)
    np.testing.assert_allclose(g_feats.numpy(), r_feats, rtol=1e-5, atol=atol)
    np.testing.assert_allclose(g_xyz.numpy(), r_xyz, rtol=1e-5, atol=atol)
    # a missing cotangent is a zero cotangent; a view is as good as a copy
    only_dpfj = ball_group_bwd_plain(radius, idx, torch.from_numpy(qidx),
                                     None, None, g_dpfj, 128, relative,
                                     normalize_dp)
    zeros = ball_group_bwd_plain(
        radius, idx, torch.from_numpy(qidx), torch.zeros_like(g_new),
        torch.zeros_like(g_fi),
        g_dpfj.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3), 128,
        relative, normalize_dp)
    for a, b in zip(only_dpfj, zeros):  # a strided sum may reorder its terms
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_rows_forward_and_backward(dtype):
    rng = np.random.default_rng(3)
    B, N, M, C = 3, 40, 56, 7
    idx = rng.integers(0, N, (B, M)).astype(np.int32)  # M > N: repeats
    assert max(np.bincount(idx[0], minlength=N)) > 1
    if dtype == "bfloat16":
        # eighths in [-4, 4): every value and every sum of repeats is exact
        # in bf16, so the order and width of the accumulation do not show
        pts = rng.integers(-32, 32, (B, N, C)).astype(np.float32) / 8
        g = rng.integers(-32, 32, (B, M, C)).astype(np.float32) / 8
    else:
        pts = rng.standard_normal((B, N, C)).astype(np.float32)
        g = rng.standard_normal((B, M, C)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    ref, vjp = jax.vjp(lambda p: _index_points_xla(p, jnp.asarray(idx)),
                       jnp.asarray(pts).astype(jdt))
    (r_g,) = vjp(jnp.asarray(g).astype(jdt))
    p = torch.from_numpy(pts).to(tdt).requires_grad_()
    out = ops.gather_rows(p, torch.from_numpy(idx))
    assert out.dtype == tdt and out.shape == (B, M, C)
    np.testing.assert_array_equal(out.detach().float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))
    (got,) = torch.autograd.grad(out, p, torch.from_numpy(g).to(tdt))
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(r_g.astype(jnp.float32)),
                               rtol=0, atol=1e-6)
    # the scatter-add the CUDA backward kernel is held to
    plain = gather_rows_bwd_plain(torch.from_numpy(g).to(tdt),
                                  torch.from_numpy(idx), N)
    assert plain.dtype == tdt
    np.testing.assert_allclose(plain.float().numpy(), got.float().numpy(),
                               rtol=0, atol=1e-6)


def test_gather_rows_rejects_out_of_range_on_cpu():
    pts = torch.zeros(1, 8, 2)
    with pytest.raises(IndexError):
        gather_rows_plain(pts, torch.tensor([[0, 8]]))
    with pytest.raises(IndexError):
        gather_rows_plain(pts, torch.tensor([[-1, 2]]))


def test_fps_gathers_rows_and_passes_gradient_to_them():
    _, xyz, feats = _cloud(5, 2, 96, C=2)
    data = torch.from_numpy(np.concatenate([xyz, feats], -1)).requires_grad_()
    out = ops.fps(data, 24)
    ref_idx = np.asarray(jax_geometry.furthest_point_sample_xla(
        jnp.asarray(xyz), 24))
    np.testing.assert_array_equal(
        out.detach().numpy(),
        np.take_along_axis(data.detach().numpy(),
                           ref_idx[..., None].astype(np.int64), axis=1))
    out.sum().backward()
    hit = np.zeros((2, 96), bool)
    np.put_along_axis(hit, ref_idx.astype(np.int64), True, axis=1)
    np.testing.assert_array_equal(data.grad.numpy(),
                                  np.repeat(hit[..., None], 5, -1)
                                  .astype(np.float32))


@pytest.mark.parametrize("B,N,npoints,point_all", [
    (3, 128, 64, 64),        # budget not in the map: FPS to npoints itself
    (1, 1300, 1024, 1200),   # the protocol's 1024 <- 1200 budget
    (2, 48, 64, 48),         # already within the budget: returned as it is
])
def test_resample_points_matches_jax_with_injected_columns(B, N, npoints,
                                                           point_all):
    rng, xyz, feats = _cloud(N, B, N, C=1)
    pts = np.concatenate([xyz, feats], -1)
    key = jax.random.PRNGKey(4)
    ref = np.asarray(jax_trainer.resample_points(key, jnp.asarray(pts),
                                                 npoints))
    got_in = torch.from_numpy(pts)
    if N <= npoints:
        assert resample_points(None, got_in, npoints) is got_in
        np.testing.assert_array_equal(ref, pts)
        return
    cols = np.asarray(jax.random.choice(key, point_all, (npoints,),
                                        replace=False))
    got = resample_points(torch.from_numpy(cols.copy()), got_in,
                          npoints).numpy()
    assert got.shape == (B, npoints, 4)
    np.testing.assert_array_equal(got, ref)
    # drawn from a generator: the same multiset of FPS rows, unsorted draw
    gen = torch.Generator().manual_seed(0)
    drawn = resample_points(gen, got_in, npoints).numpy()
    assert drawn.shape == got.shape
    if point_all == npoints:
        np.testing.assert_array_equal(np.sort(drawn.reshape(B, -1), -1),
                                      np.sort(ref.reshape(B, -1), -1))


@pytest.mark.parametrize("k,N", [(3, 64), (8, 64), (5, 3)])
def test_knn_point_matches_jax(k, N):
    _, xyz, _ = _cloud(11, 2, N)
    _, new_xyz, _ = _cloud(12, 2, 20)
    d2, idx = ops.knn_point(k, torch.from_numpy(xyz),
                            torch.from_numpy(new_xyz))
    r_d2, r_idx = jax_geometry.knn_point(k, jnp.asarray(xyz),
                                         jnp.asarray(new_xyz))
    assert idx.dtype == torch.int32 and idx.shape == (2, 20, k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(r_idx))
    np.testing.assert_allclose(d2.numpy(), np.asarray(r_d2), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(
        ops.square_distance(torch.from_numpy(new_xyz),
                            torch.from_numpy(xyz)).numpy(),
        np.asarray(jax_geometry.square_distance(jnp.asarray(new_xyz),
                                                jnp.asarray(xyz))),
        rtol=1e-5, atol=1e-6)


def test_knn_point_ties_go_to_the_lowest_index():
    xyz = torch.zeros(1, 6, 3)
    xyz[0, 3:] = 1.0  # two groups of three identical points
    _, idx = ops.knn_point(4, xyz, torch.zeros(1, 1, 3))
    assert idx[0, 0].tolist() == [0, 1, 2, 3]


def test_three_nn_and_interpolation_match_jax():
    _, known, feats = _cloud(21, 2, 32, C=6)
    _, unknown, _ = _cloud(22, 2, 80)
    dist, idx = ops.three_nn(torch.from_numpy(unknown),
                             torch.from_numpy(known))
    r_dist, r_idx = jax_geometry.three_nn_xla(jnp.asarray(unknown),
                                              jnp.asarray(known))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(r_idx))
    np.testing.assert_allclose(dist.numpy(), np.asarray(r_dist), rtol=1e-4,
                               atol=1e-6)
    got = ops.three_interpolation(torch.from_numpy(unknown),
                                  torch.from_numpy(known),
                                  torch.from_numpy(feats))
    ref = jax_geometry.three_interpolation(jnp.asarray(unknown),
                                           jnp.asarray(known),
                                           jnp.asarray(feats))
    assert got.shape == (2, 80, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)
