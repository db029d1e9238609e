"""The port's fused train-BN SA stage (``ops.sa_trainbn``) against the JAX
package, on the CPU.

The port's CPU branch is ``SaTrainBN`` over the plain versions of the four
passes the CUDA kernels compute, with the algebra between them. It is held:

- in the forward and the four batch statistics against the TPU kernel
  family ``sa_trainbn_pallas`` run in interpret mode, at the shapes of
  ``tests/test_trainbn_kernel.py`` and both of its ``(radius,
  normalize_dp)`` cases, at that test's rtol 2e-4 / atol 2e-5 (f32 sums in
  other orders; the kernel's statistics come from the row sums Sv, Svv);
- in all eight cotangents against the JAX unfused oracle (the XLA ball
  group, conv, flax-formula BatchNorm, relu, conv, BatchNorm and max, under
  ``jax.grad``), rtol 5e-4 and atol 5e-4 of each gradient's largest entry,
  with mixed-sign ``gamma2`` and one exact zero; channel 0 of ``d_gamma2``
  is left out, for the JAX test's reason (there the slope is 0, every slot
  ties, ``jnp.max`` splits the gradient over the ties and the kernel takes
  the min side: two valid subgradients at a kink);
- with balls that hold fewer than K points and with empty balls
  (radius 0: every slot takes lane 0).

The pass decomposition is held to the stage written out too: on the CPU
``ops.sa_trainbn`` equals the autograd of ``sa_trainbn_plain`` in float64 to
1e-10.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaptpoint_tpu_torch import ops
from adaptpoint_tpu_torch.ops import satrainbn

EPS = 1e-5
NAMES = ("xyz", "feats", "w1", "gamma1", "beta1", "w2", "gamma2", "beta2")


def _problem(seed=0, B=2, N=96, M=16, C=16, mid=16, cout=24):
    """``tests/test_trainbn_kernel.py``'s problem, as numpy."""
    rng = np.random.default_rng(seed)
    xyz = (rng.standard_normal((B, N, 3)) * 0.5).astype(np.float32)
    feats = rng.standard_normal((B, N, C)).astype(np.float32)
    qidx = np.stack([rng.permutation(N)[:M] for _ in range(B)]).astype(
        np.int32)
    w = C + 3
    w1 = (rng.standard_normal((w, mid)) * 0.3).astype(np.float32)
    g1 = (rng.standard_normal(mid) * 0.5 + 1.0).astype(np.float32)
    b1 = (rng.standard_normal(mid) * 0.2).astype(np.float32)
    w2 = (rng.standard_normal((mid, cout)) * 0.3).astype(np.float32)
    g2 = rng.standard_normal(cout).astype(np.float32)
    g2[0] = 0.0
    b2 = (rng.standard_normal(cout) * 0.2).astype(np.float32)
    return xyz, feats, qidx, (w1, g1, b1, w2, g2, b2)


def _oracle(radius, nsample, xyz, qidx, feats, w1, g1, b1, w2, g2, b2,
            normalize_dp):
    """The JAX unfused stage (``test_trainbn_kernel.py``'s oracle)."""
    from adaptpoint_tpu.ops import ball_group
    new_xyz, fi, dpfj, _ = ball_group(float(radius), int(nsample), xyz, qidx,
                                      feats, relative=True,
                                      normalize_dp=normalize_dp)
    y1 = dpfj.astype(jnp.float32) @ w1
    mu1 = jnp.mean(y1, axis=(0, 1, 2))
    var1 = jnp.mean(y1 * y1, axis=(0, 1, 2)) - mu1 * mu1
    h = jax.nn.relu((y1 - mu1) * jax.lax.rsqrt(var1 + EPS) * g1 + b1)
    y2 = h @ w2
    mu2 = jnp.mean(y2, axis=(0, 1, 2))
    var2 = jnp.mean(y2 * y2, axis=(0, 1, 2)) - mu2 * mu2
    o = (y2 - mu2) * jax.lax.rsqrt(var2 + EPS) * g2 + b2
    return new_xyz, fi, jnp.max(o, axis=1), mu1, var1, mu2, var2


def _port(radius, xyz, feats, qidx, params, normalize_dp, K=8,
          dtype=torch.float32):
    leaves = [torch.tensor(a, dtype=dtype, requires_grad=True)
              for a in (xyz, feats) + tuple(params)]
    x, f, *p = leaves
    out = ops.sa_trainbn(radius, K, x, torch.from_numpy(qidx), f, *p,
                         relative=True, normalize_dp=normalize_dp)
    return out, leaves


@pytest.mark.parametrize("radius,norm_dp", [(0.35, True), (0.6, False)])
def test_forward_and_statistics_match_the_tpu_kernel(monkeypatch, radius,
                                                     norm_dp):
    monkeypatch.setenv("ADAPTPOINT_TPU_PALLAS_INTERPRET", "1")
    from adaptpoint_tpu.ops.pallas.satrainbn import sa_trainbn_pallas
    xyz, feats, qidx, params = _problem()
    ref = sa_trainbn_pallas(radius, 8, jnp.asarray(xyz), jnp.asarray(qidx),
                            jnp.asarray(feats),
                            *[jnp.asarray(p) for p in params],
                            normalize_dp=norm_dp)
    got, _ = _port(radius, xyz, feats, qidx, params, norm_dp)
    for r, g, name in zip(ref, got, ("new_xyz", "fi", "out", "mu1", "var1",
                                     "mu2", "var2")):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r),
                                   rtol=2e-4, atol=2e-5, err_msg=name)
    # the small radius leaves balls short of K points: pad slots counted
    from adaptpoint_tpu_torch.ops.geometry import ball_query, index_points
    t = torch.from_numpy(xyz)
    idx = ball_query(radius, 8, t, index_points(t, torch.from_numpy(qidx)))
    short = idx[..., -1] == idx[..., 0]  # fewer than K members: padded
    assert bool(short.any())


def _cotangents(seed=7, B=2, M=16, C=16, cout=24):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, M, 3)).astype(np.float32),
            rng.standard_normal((B, M, C)).astype(np.float32),
            rng.standard_normal((B, M, cout)).astype(np.float32))


@pytest.mark.parametrize("radius,norm_dp", [(0.35, True), (0.0, False)],
                         ids=["short-balls", "empty-balls"])
def test_all_eight_cotangents_match_the_jax_oracle(radius, norm_dp):
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
    for r, g, name in zip(ref, got, NAMES):
        r, g = np.asarray(r), g.numpy()
        if name == "gamma2":
            r, g = r[1:], g[1:]  # the kink at gamma2 == 0 (module note)
        scale = max(1e-3, float(np.abs(r).max()))
        np.testing.assert_allclose(g, r, rtol=5e-4, atol=5e-4 * scale,
                                   err_msg=name)
    if radius == 0.0:
        # an empty ball takes lane 0 in every slot: all the rows' gradient
        # lands on point 0 and the centers
        from adaptpoint_tpu_torch.ops.geometry import ball_query
        t = torch.from_numpy(xyz)
        assert int(ball_query(0.0, 8, t, t[:, :16]).abs().sum()) == 0


@pytest.mark.parametrize("radius,norm_dp,relative",
                         [(0.35, True, True), (0.6, False, True),
                          (0.5, True, False)])
def test_the_four_passes_are_the_stage(radius, norm_dp, relative):
    """``ops.sa_trainbn`` on CPU tensors (``SaTrainBN`` on the plain passes:
    the CUDA kernels' functions and the algebra between them) equals the
    autograd of ``sa_trainbn_plain``, outputs and all eight gradients, in
    float64."""
    xyz, feats, qidx, params = _problem(seed=5)
    q = torch.from_numpy(qidx)
    leaves = [torch.tensor(a, dtype=torch.float64, requires_grad=True)
              for a in (xyz, feats) + tuple(params)]
    twins = [t.detach().clone().requires_grad_() for t in leaves]
    x, f, *p = leaves
    ref = satrainbn.sa_trainbn_plain(radius, 8, x, q, f, *p, relative,
                                     norm_dp)
    x2, f2, *p2 = twins
    got = ops.sa_trainbn(radius, 8, x2, q, f2, *p2, relative, norm_dp, EPS)
    for a, b in zip(got, ref):
        assert float((a - b).detach().abs().max()) <= 1e-10
    rs = [torch.randn(t.shape, dtype=torch.float64,
                      generator=torch.Generator().manual_seed(i))
          for i, t in enumerate(ref[:3])]
    g_ref = torch.autograd.grad(sum((a * r).sum() for a, r in
                                    zip(ref[:3], rs)), leaves)
    g_got = torch.autograd.grad(sum((a * r).sum() for a, r in
                                    zip(got[:3], rs)), twins)
    for a, b, name in zip(g_got, g_ref, NAMES):
        assert float((a - b).abs().max()) <= 1e-10 * max(
            1.0, float(b.abs().max())), name


def test_the_stage_takes_no_gradient_through_its_statistics():
    xyz, feats, qidx, params = _problem()
    out, _ = _port(0.35, xyz, feats, qidx, params, True)
    assert all(not t.requires_grad for t in out[3:])
    assert out[2].requires_grad and out[1].requires_grad


# ---- the hand-over of g_y1' and the backward's 3xTF32 numerics -----------

def _stage_through_pass3(radius, norm_dp, relative, dtype=torch.float32,
                         seed=5):
    """Passes 1-3 on the plain versions at ``_problem``'s shapes: the inputs
    of pass 4 and pass 3's hand-over."""
    xyz, feats, qidx, params = _problem(seed=seed)
    t = [torch.tensor(a, dtype=dtype) for a in (xyz, feats) + tuple(params)]
    x, f, w1, g1, b1, w2, g2, b2 = t
    q = torch.from_numpy(qidx)
    B, M = q.shape
    n = B * M * 8
    idx, sv, svv = satrainbn.stats_plain(radius, 8, x, q, f, relative,
                                         norm_dp)
    mu1, _, r1, a1, nb1 = satrainbn._bn1(sv, svv, w1, g1, b1, n, EPS)
    fw = satrainbn.fwd_plain(radius, x, q, f, idx, w1, a1, nb1, w2, relative,
                             norm_dp)
    mu2, _, r2, a2, _ = satrainbn._bn2(fw[6], fw[7], g2, b2, n, EPS)
    pos = a2 > 0
    ystar, slot = torch.where(pos, fw[2], fw[3]), torch.where(pos, fw[4],
                                                              fw[5])
    rng = np.random.default_rng(seed + 1)
    g_out = torch.tensor(rng.standard_normal(ystar.shape), dtype=dtype)
    g_fi = torch.tensor(rng.standard_normal(f.shape[:1] + (M,) + f.shape[2:]),
                        dtype=dtype)
    g_new = torch.tensor(rng.standard_normal((B, M, 3)), dtype=dtype)
    p2, q2c = satrainbn._bwd_consts(
        g_out.sum((0, 1)) / n, (g_out * (ystar - mu2) * r2).sum((0, 1)) / n,
        a2, mu2, r2)
    w2_args = (radius, x, q, f, idx, w1, a1, nb1, w2, mu1, r1, a2, p2, q2c,
               slot, g_out, fw[8], relative, norm_dp)
    dw2, sg1, sgx1, g_y1p, y1 = satrainbn.bwd_w2_plain(*w2_args)
    p1, q1c = satrainbn._bwd_consts(sg1 / n, sgx1 / n, a1, mu1, r1)
    return dict(x=x, q=q, f=f, idx=idx, w1=w1, a1=a1, nb1=nb1, w2=w2, a2=a2,
                p2=p2, q2c=q2c, p1=p1, q1c=q1c, slot=slot, g_out=g_out,
                g_fi=g_fi, g_new=g_new, mask=fw[8], g_y1p=g_y1p, y1=y1)


def _bwd_x_recomputing(radius, s, relative, normalize_dp, g_fi, g_new):
    """Pass 4 as the TPU kernel computes it: through y2 and g_h again from
    the gathered rows (pass 4 without the hand-over), with the forward's
    mask."""
    y1, _, _, g_y1p = satrainbn._g_h(radius, s["x"], s["q"], s["f"], s["idx"],
                                     s["w1"], s["a1"], s["nb1"], s["w2"],
                                     s["a2"], s["p2"], s["q2c"], s["slot"],
                                     s["g_out"], s["mask"], relative,
                                     normalize_dp)
    return satrainbn.bwd_x_plain(radius, s["x"], s["q"], s["f"], s["idx"],
                                 s["w1"], y1, g_y1p, s["a1"], s["p1"],
                                 s["q1c"], g_fi, g_new, relative,
                                 normalize_dp)


@pytest.mark.parametrize("radius,norm_dp,relative,centers",
                         [(0.35, True, True, True), (0.6, False, True, False),
                          (0.5, True, False, True), (0.0, False, True, True)],
                         ids=["short-balls", "no-center-cotangents",
                              "absolute-dp", "empty-balls"])
def test_the_handed_over_g_y1p_gives_pass_4_the_recomputed_outputs(
        radius, norm_dp, relative, centers):
    """Pass 4 from pass 3's hand-over (y1, g_y1') equals, bit for bit, pass
    4 recomputing y1, y2 and g_h from the gathered rows as the TPU kernel
    does."""
    s = _stage_through_pass3(radius, norm_dp, relative)
    g_fi, g_new = (s["g_fi"], s["g_new"]) if centers else (None, None)
    got = satrainbn.bwd_x_plain(radius, s["x"], s["q"], s["f"], s["idx"],
                                s["w1"], s["y1"], s["g_y1p"], s["a1"],
                                s["p1"], s["q1c"], g_fi, g_new, relative,
                                norm_dp)
    ref = _bwd_x_recomputing(radius, s, relative, norm_dp, g_fi, g_new)
    for a, b, name in zip(got, ref, ("g_xyz", "g_feats", "dw1")):
        assert torch.equal(a, b), name


def test_pass_3_takes_the_relu_from_the_forward_mask():
    """g_y1' is zero wherever the forward's mask bit is clear, even where
    the backward's own a1 y1 + nb1 is positive: flipping one bit of the
    mask moves only that entry's g_y1' and h."""
    s = _stage_through_pass3(0.35, True, True)
    on = satrainbn.unpack_mask(s["mask"], s["w1"].shape[1])
    assert bool((s["g_y1p"][~on] == 0).all())
    flip = torch.nonzero(on)[0].tolist()
    on2 = on.clone()
    on2[tuple(flip)] = False
    args = (0.35, s["x"], s["q"], s["f"], s["idx"], s["w1"], s["a1"],
            s["nb1"], s["w2"], s["a2"], s["p2"], s["q2c"], s["slot"],
            s["g_out"])
    g1 = satrainbn._g_h(*args, s["mask"], True, True)[3]
    g2 = satrainbn._g_h(*args, satrainbn.pack_mask(on2), True, True)[3]
    assert float(g2[tuple(flip)]) == 0.0 and float(g1[tuple(flip)]) != 0.0


@pytest.mark.parametrize("mid", [1, 31, 32, 33, 64, 258])
def test_the_mask_words_round_trip(mid):
    rng = np.random.default_rng(mid)
    on = torch.from_numpy(rng.random((2, 3, 5, mid)) > 0.5)
    words = satrainbn.pack_mask(on)
    assert words.dtype == torch.int32
    assert tuple(words.shape) == ((mid + 31) // 32, 2, 3, 5)
    assert torch.equal(satrainbn.unpack_mask(words, mid), on)
    if mid == 32:  # bit j % 32 of word j // 32: bit 31 is the sign
        assert torch.equal(words[0] < 0, on[..., 31])


def test_the_hand_over_rows_are_read_in_place_or_copied():
    """``_rows_of`` hands the kernels pass 3's own (n, round8(mid)) buffer
    as it is, and any other (B, M, K, mid) tensor as a zero-padded copy."""
    B, M, K, mid, ld = 2, 3, 4, 5, 8
    buf = torch.arange(B * M * K * ld, dtype=torch.float32).reshape(-1, ld)
    view = buf.view(B, M, K, ld)[..., :mid]
    got = satrainbn._rows_of(view, (B, M, K, mid), ld, "y1",
                             torch.device("cpu"))
    assert got.data_ptr() == buf.data_ptr() and got.shape == (B * M * K, ld)
    dense = view.contiguous()
    copy = satrainbn._rows_of(dense, (B, M, K, mid), ld, "y1",
                              torch.device("cpu"))
    assert copy.data_ptr() != dense.data_ptr()
    assert torch.equal(copy[:, :mid], dense.reshape(-1, mid))
    assert bool((copy[:, mid:] == 0).all())
    with pytest.raises(ValueError):
        satrainbn._rows_of(dense[:, :, :, :4], (B, M, K, mid), ld, "y1",
                           torch.device("cpu"))


@pytest.mark.parametrize("k", [8, 259, 1024])
def test_tf32x3_products_are_f32_grade(k):
    """The backward kernels' split (hi = tf32 to nearest, lo = the rest,
    read truncated to tf32; lo.hi + hi.lo + hi.hi) keeps each product within
    a few 2^-21 of |a||b| of the float64 product, over a hundred times
    closer than one TF32 product."""
    rng = np.random.default_rng(k)
    a = torch.from_numpy(rng.standard_normal((64, k)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((k, 48)).astype(np.float32))
    exact = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()
    three = (satrainbn.tf32x3_mm(a, b).double() - exact).abs() / scale
    one = (satrainbn._tf32(a).double() @ satrainbn._tf32(b).double()
           - exact).abs() / scale
    assert float(three.max()) < 8 * 2.0 ** -21
    assert float(one.max()) > 100 * float(three.max())
    # the split is exact: hi + lo == x
    hi = satrainbn._tf32(a)
    assert torch.equal(hi + (a - hi), a)
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())


@pytest.mark.parametrize("radius,norm_dp", [(0.35, True), (0.0, False)],
                         ids=["short-balls", "empty-balls"])
def test_the_backward_in_tf32x3_matches_the_jax_oracle(monkeypatch, radius,
                                                       norm_dp):
    """All eight cotangents with the backward passes' products in the
    kernels' 3xTF32 numerics (``tf32x3_mm`` in place of ``_mm``) against
    the JAX unfused oracle, at the tolerances of
    test_all_eight_cotangents_match_the_jax_oracle: the f32-grade claim of
    rows 18 and 19, checked before the card."""
    calls = []
    monkeypatch.setattr(satrainbn, "_mm", lambda a, b: calls.append(1)
                        or satrainbn.tf32x3_mm(a, b))
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
    assert len(calls) == 6  # pass 3: conv1, conv2, dW2, g_h; pass 4: dW1, g_v
    for r, g, name in zip(ref, got, NAMES):
        r, g = np.asarray(r), g.numpy()
        if name == "gamma2":
            r, g = r[1:], g[1:]  # the kink at gamma2 == 0 (module note)
        scale = max(1e-3, float(np.abs(r).max()))
        np.testing.assert_allclose(g, r, rtol=5e-4, atol=5e-4 * scale,
                                   err_msg=name)
