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
