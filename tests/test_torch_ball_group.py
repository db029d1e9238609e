"""The ball group (TPU kernel rows 2 and 4) at full width against the JAX package, and the host side of its Hopper kernels.

- The plain versions, through ``ops.ball_group`` and its autograd on the
  CPU, against ``adaptpoint_tpu.ops.ball_group`` on its XLA route at a
  full-width stage (PointNeXt-S's last: C = 256, M = 64, K = 32, a ball
  that holds only its center) and at the kernels' edge shapes: idx,
  new_xyz, fi and fj bit for bit, dp within 1e-6 (the port multiplies by f32(1/r) where the composite
  divides); the gradients within the f32 reordering bound, counted per
  element as ``chip_smoke.py`` counts it, plus one addend's worth for the
  divide.
- The forward's launch shape, which its CUDA wrapper picks on the host
  (``fwd_tiling``), and both kernels' shared memory (``fwd_smem_bytes``,
  ``bwd_smem_bytes``, the host copies of the kernels' layouts, which
  ``chip_smoke.py`` holds equal to the kernels' own) at the four train
  stages and at the edges: M off the tile, N not a multiple of 4, N too
  large to stage, K = 1, 33 and 128, C = 0 and 3, C wider than a span
  buffer.
- What the wrappers and the choosers refuse before any launch.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaptpoint_tpu.ops import ball_group as jax_ball_group
from adaptpoint_tpu_torch import ops
from adaptpoint_tpu_torch.ops import ballgroup as bg

# PointNeXt-S's SA stages at B = 32 from N = 1024: (N, M, C), K = 32
STAGES = [(1024, 512, 32), (512, 256, 64), (256, 128, 128), (128, 64, 256)]
# launch-shape edges: (B, N, M, C, K)
EDGES = {"m_off_the_tile": (3, 500, 77, 24, 32),
         "n_not_a_multiple_of_4": (2, 1001, 37, 35, 32),
         "n_too_large_to_stage": (2, 16384, 100, 16, 32),
         "k_1": (4, 300, 37, 36, 1), "k_33": (2, 300, 37, 32, 33),
         "k_128": (4, 257, 100, 36, 128), "c_0": (2, 300, 37, 0, 32),
         "c_3": (2, 300, 37, 3, 32),
         "c_wider_than_a_buffer": (2, 100, 30, 5000, 8)}
# the JAX comparison's cases: (B, N, M, C, K, radius)
JAX_CASES = {"full_width_stage_4": (2, 128, 64, 256, 32, 0.50625),
             "k_33_c_3_n_odd": (2, 101, 37, 3, 33, 0.4),
             "k_1_c_0": (2, 64, 16, 0, 1, 0.3),
             "k_128_m_off_the_tile": (1, 257, 77, 8, 128, 0.6)}
SMEM_OPT_IN = 232448  # bytes a block may use on the H100
TWO_BLOCKS = 115712   # a block's share when two share an SM
SMS = 132
EPS32 = 2.0 ** -23


def _case(b, n, m, c, seed=5):
    """A unit-ball cloud (the card's stage inputs' scale), distinct centers,
    features; center 0 of cloud 0 moved far out: a ball that holds only its
    center."""
    rng = np.random.default_rng(seed)
    xyz = rng.standard_normal((b, n, 3)).astype(np.float32)
    xyz /= np.linalg.norm(xyz, axis=-1).max(axis=1)[:, None, None]
    q = np.stack([rng.permutation(n)[:m] for _ in range(b)]).astype(np.int32)
    xyz[0, q[0, 0]] = 5.0
    feats = rng.standard_normal((b, n, c)).astype(np.float32)
    return rng, xyz, q, feats


@pytest.mark.parametrize("rel_norm", [(True, True), (True, False),
                                      (False, False)],
                         ids=["relative_normalised", "relative", "absolute"])
@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_forward_matches_jax(case, rel_norm):
    b, n, m, c, k, r = JAX_CASES[case]
    relative, normalize_dp = rel_norm
    _, xyz, q, feats = _case(b, n, m, c)
    got = ops.ball_group(r, k, torch.from_numpy(xyz), torch.from_numpy(q),
                         torch.from_numpy(feats), relative=relative,
                         normalize_dp=normalize_dp)
    ref = jax_ball_group(r, k, jnp.asarray(xyz), jnp.asarray(q),
                         jnp.asarray(feats), relative=relative,
                         normalize_dp=normalize_dp)
    new_xyz, fi, dpfj, idx = (t.numpy() for t in got)
    r_new, r_fi, r_dpfj, r_idx = (np.asarray(t) for t in ref)
    assert dpfj.shape == r_dpfj.shape == (b, k, m, 3 + c)
    np.testing.assert_array_equal(idx, r_idx)
    np.testing.assert_array_equal(new_xyz, r_new)
    np.testing.assert_array_equal(fi, r_fi)
    np.testing.assert_array_equal(dpfj[..., 3:], r_dpfj[..., 3:])
    np.testing.assert_allclose(dpfj[..., :3], r_dpfj[..., :3], rtol=0,
                               atol=1e-6)
    # the lone center's ball: every slot repeats it
    assert (idx[0, 0] == q[0, 0]).all()
    if case == "full_width_stage_4":  # both full and partial balls
        full = idx[..., -1] != idx[..., 0]
        assert full.any() and not full.all()


def _bound(r, idx, q, cot, n, relative, normalize_dp):
    """Per-element bound on |port - JAX| for the gradients: both add the
    same addends in other orders (n 2^-23 sum|addend|, n the addends that
    meet there plus K for a center's inner sum), plus one addend's worth
    for the dp scale (the port multiplies by f32(1/r), the composite's VJP
    divides)."""
    g_new, g_fi, g_dpfj = (torch.from_numpy(np.abs(a)) for a in cot)
    b, k, m, _ = g_dpfj.shape
    one = torch.ones((b, k, m, 4))
    counts = bg.ball_group_bwd_plain(r, idx, q, None, one[:, 0, :, :1], one,
                                     n, False, False)[1] + k + 1
    s = (1.0 / r) if relative and normalize_dp else 1.0
    a_dp = g_dpfj[..., :3] * s
    a_center = g_new + a_dp.sum(dim=1) if relative else g_new
    a_xyz, a_feats = bg.ball_group_bwd_plain(
        r, idx, q, a_center, g_fi, torch.cat([a_dp, g_dpfj[..., 3:]], -1), n,
        False, False)
    return ((counts * EPS32 * a_xyz + 1e-30).numpy(),
            (counts * EPS32 * a_feats + 1e-30).numpy())


@pytest.mark.parametrize("rel_norm", [(True, True), (False, False)],
                         ids=["relative_normalised", "absolute"])
@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_backward_matches_jax_vjp(case, rel_norm):
    """``ball_group_bwd_plain`` (what the backward kernel is held to on the
    card) and the op's autograd on the CPU against ``jax.vjp``, also with
    ``g_new`` and ``g_fi`` absent (zero) and a strided ``g_dpfj``."""
    b, n, m, c, k, r = JAX_CASES[case]
    relative, normalize_dp = rel_norm
    rng, xyz, q, feats = _case(b, n, m, c)
    cot = (rng.standard_normal((b, m, 3)).astype(np.float32),
           rng.standard_normal((b, m, c)).astype(np.float32),
           rng.standard_normal((b, k, m, 3 + c)).astype(np.float32))

    def jfn(x, f):
        return jax_ball_group(r, k, x, jnp.asarray(q), f, relative=relative,
                              normalize_dp=normalize_dp)[:3]

    _, vjp = jax.vjp(jfn, jnp.asarray(xyz), jnp.asarray(feats))
    r_xyz, r_feats = (np.asarray(g) for g in vjp(tuple(
        jnp.asarray(a) for a in cot)))
    x = torch.from_numpy(xyz).requires_grad_()
    f = torch.from_numpy(feats).requires_grad_()
    out = ops.ball_group(r, k, x, torch.from_numpy(q), f, relative=relative,
                         normalize_dp=normalize_dp)
    g_new, g_fi, g_dpfj = (torch.from_numpy(a) for a in cot)
    strided = g_dpfj.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
    auto = torch.autograd.grad(out[:3], (x, f), (g_new, g_fi, strided))
    idx, qt = out[3], torch.from_numpy(q)
    plain = bg.ball_group_bwd_plain(r, idx, qt, g_new, g_fi, g_dpfj, n,
                                    relative, normalize_dp)
    bound_xyz, bound_feats = _bound(r, idx, qt, cot, n, relative,
                                    normalize_dp)
    for got_xyz, got_feats in (auto, plain):
        assert np.all(np.abs(got_xyz.numpy() - r_xyz) <= bound_xyz)
        assert np.all(np.abs(got_feats.numpy() - r_feats) <= bound_feats)
    # g_new and g_fi absent: the JAX VJP with zeros there
    zeros = (np.zeros_like(cot[0]), np.zeros_like(cot[1]), cot[2])
    z_xyz, z_feats = (np.asarray(g) for g in vjp(tuple(
        jnp.asarray(a) for a in zeros)))
    only = bg.ball_group_bwd_plain(r, idx, qt, None, None, g_dpfj, n,
                                   relative, normalize_dp)
    assert np.all(np.abs(only[0].numpy() - z_xyz) <= bound_xyz)
    assert np.all(np.abs(only[1].numpy() - z_feats) <= bound_feats)


def _tilings_ok(b, n, m, c, k, aligned=True):
    """The forward's tiling and both kernels' shared memory at one shape,
    each within the card's opt-in."""
    tl = bg.fwd_tiling(b, n, m, c, k, aligned)
    smem = bg.fwd_smem_bytes(tl.tm, k, n, tl.use_xs, tl.cap)
    assert smem <= SMEM_OPT_IN and smem % 128 == 0
    # the cloud is staged exactly where two blocks still fit an SM with it
    assert tl.use_xs == (bg.fwd_smem_bytes(tl.tm, k, n, True, tl.cap)
                         <= TWO_BLOCKS)
    assert tl.cap % 4 == 0 and 4 <= tl.cap <= 3072
    # a slot's span and its alignment pad fit the buffer, or it is the most
    assert tl.cap >= tl.tm * (c + 3) + 3 or tl.cap == 3072
    assert tl.vec == (4 if aligned and c % 4 == 0 and c > 0 else 1)
    assert bg.bwd_smem_bytes(k) <= TWO_BLOCKS
    return tl


@pytest.mark.parametrize("shape", STAGES, ids=[f"stage_{i + 1}"
                                               for i in range(4)])
def test_launch_shapes_at_the_train_stages(shape):
    n, m, c = shape
    tl = _tilings_ok(32, n, m, c, 32)
    # every stage stages its cloud, takes each slot's span whole in one
    # buffer and reads 16 bytes of features a lane
    assert tl.use_xs and tl.cap >= tl.tm * (c + 3) + 3 and tl.vec == 4
    # spans of at most about 4 KB, two blocks an SM's worth of tiles
    assert tl.tm * (c + 3) <= bg._SPAN and 32 * -(-m // tl.tm) >= 2 * SMS


@pytest.mark.parametrize("edge", sorted(EDGES))
def test_launch_shapes_at_the_edges(edge):
    b, n, m, c, k = EDGES[edge]
    tl = _tilings_ok(b, n, m, c, k)
    if edge == "n_too_large_to_stage":
        assert not tl.use_xs
    if edge in ("c_0", "c_3"):
        assert tl.vec == 1
    if edge == "m_off_the_tile":
        assert m % tl.tm
    if edge == "c_wider_than_a_buffer":
        # the span goes through the buffer in windows
        assert tl.cap < tl.tm * (c + 3)
    # misaligned features take the one-channel loads
    assert bg.fwd_tiling(b, n, m, c, k, False).vec == 1


def test_host_layouts_grow_with_their_parts():
    """The host copies add the parts the kernels' layouts hold, each
    rounded up to 128 bytes."""
    base = bg.fwd_smem_bytes(16, 32, 1024, False, 564)
    assert base == 2048 + 256 + 8 * 2304
    assert bg.fwd_smem_bytes(16, 32, 1024, True, 564) == base + 16384
    # eight warps' K indices (16-byte aligned), then 128 floats a warp
    assert bg.bwd_smem_bytes(32) == 1024 + 4096
    assert bg.bwd_smem_bytes(33) == 1056 + 4096
    assert bg.bwd_smem_bytes(1) == 32 + 4096


def test_forward_chooser_refuses_what_the_kernel_does_not_take():
    for args in ((32, 1024, 512, 32, 0), (32, 1024, 0, 32, 32),
                 (0, 1024, 512, 32, 32), (32, 0, 512, 32, 32),
                 (32, 1024, 512, -1, 32)):
        with pytest.raises(ValueError):
            bg.fwd_tiling(*args)
    with pytest.raises(ValueError, match="shared memory"):
        bg.fwd_tiling(1, 64, 8, 4, 100000)  # the slot table alone



def test_cuda_wrappers_refuse_before_any_launch():
    xyz = torch.zeros(1, 16, 3)
    q = torch.zeros(1, 4, dtype=torch.int32)
    f = torch.zeros(1, 16, 5)
    idx = torch.zeros(1, 4, 4, dtype=torch.int32)
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        bg.ball_group_cuda(0.3, 4, xyz, q, f)
    with pytest.raises(ValueError, match="CUDA"):
        bg.ball_group_bwd_cuda(0.3, idx, q, None, None,
                               torch.zeros(1, 4, 4, 8), 16)
    with pytest.raises(ValueError, match="CUDA"):
        bg.BallGroup.apply(xyz, q, f, 0.3, 4, True, True)
    assert ops.launch_counts() == before
