"""The max-pooled ball group (TPU kernel rows 7, 8) on bf16 features, and the host side of its Hopper kernels.

- The port's plain versions with the bf16 policy's features, through
  ``ops.ball_group_max`` and autograd, against the JAX package's bf16
  contract on the interpreted TPU kernel: its ``ball_group_max`` casts the
  features up, runs ``ball_group_maxpool_pallas`` (here under
  ``pltpu.force_tpu_interpret_mode``, ``test_torch_gan_route
  .pallas_ball_group_max``) and casts the pooled values back. Outputs and
  winning slots bit for bit; the bf16 feature gradient within one bf16 ulp
  of the reference plus the f32 reordering bound (both sum the same
  rounded slot cotangents in f32, in other orders, then round once).
- The launch shapes the CUDA wrappers pick on the host (``fwd_tiling``,
  ``bwd_tiling``) and their shared memory (``fwd_smem_bytes``,
  ``bwd_smem_bytes``, the host copies of the kernel's layouts, which
  ``chip_smoke.py`` holds equal to the kernel's own) within the card's opt-in
  at the augmentor's four grouper shapes and at the edges, and what the
  wrappers refuse before any launch.
- The op's type contract on the CPU: bf16 in, bf16 ``fi``, ``fmax``,
  ``fmin`` and gradient, the values the f32 route gives cast down.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaptpoint_tpu_torch import ops
from adaptpoint_tpu_torch.ops import ballgroup_max as bgm
from test_torch_gan_route import (BG_CASES, _clouds, _interpreted_bg_max_fwd,
                                  pallas_ball_group_max)

# the JAX comparison's cases: BG_CASES and one like an augmentor grouper
# (N, M, C, K, radius, dropped share)
CASES = dict(BG_CASES, grouper_like=(256, 128, 64, 24, 0.2, 0.5))
# the augmentor's groupers at B = 32: (N, M, C), K = 24
GROUPERS = [(2048, 1024, 128), (1024, 512, 256), (512, 256, 512),
            (256, 128, 1024)]
# launch-shape edges: (B, N, M, C, K)
EDGES = {"k_1": (4, 300, 37, 35, 1), "k_255": (4, 300, 37, 36, 255),
         "c_off_the_vector": (32, 2048, 1000, 130, 24),
         "m_off_the_tile": (3, 500, 77, 24, 24),
         "n_too_large_to_stage": (2, 16384, 100, 16, 24),
         "one_channel": (1, 64, 8, 1, 40)}
SMEM_OPT_IN = 232448  # bytes a block may use on the H100
TWO_BLOCKS = 115712   # a block's share when two share an SM
EPS32 = 2.0 ** -23


def _bf16(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bf16, held in f32."""
    return torch.from_numpy(a).bfloat16().float().numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_features_match_the_jax_contract_on_the_interpreted_kernel(
        case):
    n, m, c, k, r, dropped = CASES[case]
    rng, xyz, feats = _clouds(3, 2, n, c, dropped)
    feats = _bf16(feats)
    q = np.stack([rng.permutation(n)[:m] for _ in range(2)]).astype(np.int32)
    q[1, 0] = 5  # the far point: an empty ball
    g_new = rng.standard_normal((2, m, 3)).astype(np.float32)
    gs = [_bf16(rng.standard_normal((2, m, c)).astype(np.float32))
          for _ in range(3)]

    # the JAX package under its bf16 policy, on the interpreted TPU kernel
    fj = jnp.asarray(feats, dtype=jnp.bfloat16)
    ref, vjp = jax.vjp(
        lambda x, f: pallas_ball_group_max(r, k, x, jnp.asarray(q), f),
        jnp.asarray(xyz), fj)
    ref_gx, ref_gf = vjp((jnp.asarray(g_new),)
                         + tuple(jnp.asarray(g, dtype=jnp.bfloat16)
                                 for g in gs))
    _, res = _interpreted_bg_max_fwd(r, k, jnp.asarray(xyz), jnp.asarray(q),
                                     fj.astype(jnp.float32))

    # the port: bf16 in, bf16 out, no cast
    xt = torch.from_numpy(xyz).requires_grad_()
    ft = torch.from_numpy(feats).bfloat16().requires_grad_()
    qt = torch.from_numpy(q)
    out = ops.ball_group_max(r, k, xt, qt, ft)
    assert [o.dtype for o in out] == [torch.float32] + [torch.bfloat16] * 3
    for name, a, b in zip(("new_xyz", "fi", "fmax", "fmin"), out, ref):
        np.testing.assert_array_equal(a.detach().float().numpy(),
                                      np.asarray(b, dtype=np.float32),
                                      err_msg=name)
    plain = bgm.ball_group_max_plain(r, k, xt.detach(), qt, ft.detach())
    np.testing.assert_array_equal(plain[4].numpy(), np.asarray(res[3]))
    np.testing.assert_array_equal(plain[5].numpy(), np.asarray(res[4]))
    cot = (torch.from_numpy(g_new),) + tuple(
        torch.from_numpy(g).bfloat16() for g in gs)
    gx, gf = torch.autograd.grad(out, (xt, ft), cot)
    assert gf.dtype == torch.bfloat16 and gx.dtype == torch.float32
    np.testing.assert_array_equal(gx.numpy(), np.asarray(ref_gx))

    # the bound: n * 2^-23 * sum|addend| (n addends meet at an element),
    # then one bf16 ulp (<= 2^-7 of the value) of the rounding after it
    idx, amax, amin = plain[6], plain[4], plain[5]
    ones = torch.ones((2, m, c))
    counts = bgm.ball_group_max_bwd_plain(idx, qt, amax, amin, None, ones,
                                          ones, ones, n)[1]
    abs_sum = bgm.ball_group_max_bwd_plain(
        idx, qt, amax, amin, None,
        *(torch.from_numpy(np.abs(g)) for g in gs), n)[1]
    want = np.asarray(ref_gf, dtype=np.float32)
    reorder = (counts * EPS32 * abs_sum).numpy()
    bound = reorder + 2.0 ** -7 * (np.abs(want) + reorder)
    err = np.abs(gf.float().numpy() - want)
    assert (err <= bound).all(), float((err - bound).max())
    assert np.abs(want).max() > 0


def _launch_shape_ok(B, N, M, C, K, dtype):
    tl = bgm.fwd_tiling(B, N, M, C, K, dtype)
    vec = 16 // dtype.itemsize
    assert tl.tm in (8, 16, 32)
    assert tl.vec == (vec if C % vec == 0 else 1)
    smem = bgm.fwd_smem_bytes(tl.tm, K, N, tl.use_xs)
    assert smem <= SMEM_OPT_IN
    # the cloud is staged exactly where two blocks still fit an SM with it
    assert tl.use_xs == (bgm.fwd_smem_bytes(tl.tm, K, N, True)
                         <= TWO_BLOCKS)
    bt = bgm.bwd_tiling(N, C)
    assert bt.s in (4, 8, 16, 32) and 1 <= bt.r <= N
    assert bgm.bwd_smem_bytes(bt.s, bt.r) <= TWO_BLOCKS
    return tl, bt


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", GROUPERS, ids=[f"grouper_{i + 1}"
                                                for i in range(4)])
def test_launch_shapes_at_the_grouper_shapes(shape, dtype):
    n, m, c = shape
    tl, bt = _launch_shape_ok(32, n, m, c, 24, dtype)
    # every grouper stages its cloud, and the backward keeps all N rows in
    # one block
    assert tl.use_xs and bt.r == n
    # four blocks an SM's worth of tiles on the H100's 132 SMs, or the
    # smallest tile
    assert 32 * -(-m // tl.tm) >= 4 * 132 or tl.tm == 8


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("edge", sorted(EDGES))
def test_launch_shapes_at_the_edges(edge, dtype):
    b, n, m, c, k = EDGES[edge]
    tl, bt = _launch_shape_ok(b, n, m, c, k, dtype)
    if edge == "n_too_large_to_stage":
        assert not tl.use_xs
        # four channels' rows do not fit: the rows split into ranges
        assert bt.s == 4 and bt.r < n
    if edge == "c_off_the_vector":
        assert tl.vec == 1
    if edge == "m_off_the_tile":
        assert m % tl.tm


def test_wrong_shapes_are_refused_before_any_launch():
    for args in ((32, 2048, 1024, 128, 0), (32, 2048, 1024, 128, 256),
                 (32, 2048, 1024, 0, 24), (0, 2048, 1024, 128, 24)):
        with pytest.raises(ValueError):
            bgm.fwd_tiling(*args, torch.float32)
    for dtype in (torch.float16, torch.float64, torch.int32):
        with pytest.raises(ValueError, match="f32 or bf16"):
            bgm.fwd_tiling(32, 2048, 1024, 128, 24, dtype)
    for s in (2, 3, 12, 512):
        with pytest.raises(ValueError, match="power of two"):
            bgm.bwd_tiling(2048, 128, s)
    with pytest.raises(ValueError):
        bgm.bwd_tiling(0, 128)


def _inputs(dtype=torch.float32, k=4):
    xyz = torch.zeros(1, 16, 3)
    q = torch.zeros(1, 4, dtype=torch.int32)
    return (0.3, k, xyz, q, torch.zeros(1, 16, 8, dtype=dtype))


@pytest.mark.parametrize("bad,match", [
    ({}, "CUDA"), ({"dtype": torch.float16}, "f32 or bf16"),
    ({"dtype": torch.float64}, "f32 or bf16"), ({"k": 256}, "K <= 255")],
    ids=["cpu_tensors", "f16", "f64", "k_256"])
def test_cuda_wrappers_refuse_before_any_launch(bad, match):
    before = ops.launch_counts()
    with pytest.raises(ValueError, match=match):
        bgm.ball_group_max_cuda(*_inputs(**bad))
    dtype = bad.get("dtype", torch.float32)
    u8 = torch.zeros(1, 4, 8, dtype=torch.uint8)
    idx = torch.zeros(1, 4, bad.get("k", 4), dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        bgm.ball_group_max_bwd_cuda(idx, torch.zeros(1, 4, dtype=torch.int32),
                                    u8, u8, None, None,
                                    torch.zeros(1, 4, 8, dtype=dtype), None,
                                    16, feat_dtype=dtype)
    assert ops.launch_counts() == before


def test_op_keeps_the_bf16_type_contract_on_the_cpu():
    """bf16 in gives bf16 pooled values and a bf16 gradient, equal to the f32
    route's (the values are bf16 either way; the gradient is the same f32
    sum rounded once)."""
    rng, xyz, feats = _clouds(4, 2, 128, 16, 0.25)
    q = torch.from_numpy(np.stack([rng.permutation(128)[:32]
                                   for _ in range(2)]).astype(np.int32))
    f16 = torch.from_numpy(feats).bfloat16()
    cot = [torch.from_numpy(rng.standard_normal((2, 32, 3))
                            .astype(np.float32))]
    cot += [torch.from_numpy(rng.standard_normal((2, 32, 16))
                             .astype(np.float32)).bfloat16()
            for _ in range(3)]
    runs = {}
    for dt in (torch.bfloat16, torch.float32):
        xt = torch.from_numpy(xyz).requires_grad_()
        ft = f16.to(dt).requires_grad_()
        out = ops.ball_group_max(0.3, 24, xt, q, ft)
        grads = torch.autograd.grad(out, (xt, ft),
                                    [cot[0]] + [g.to(dt) for g in cot[1:]])
        runs[dt] = (out, grads)
    (o16, g16), (o32, g32) = runs[torch.bfloat16], runs[torch.float32]
    assert [o.dtype for o in o16[1:]] == [torch.bfloat16] * 3
    assert g16[1].dtype == torch.bfloat16 and g16[0].dtype == torch.float32
    for a, b in zip(o16, o32):
        assert torch.equal(a.float(), b)
    assert torch.equal(g16[0], g32[0])
    assert torch.equal(g16[1], g32[1].bfloat16())
