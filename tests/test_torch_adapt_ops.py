"""The op layer phase A adds to the port, against the JAX package, on the CPU.

The same numpy inputs go through the JAX function (XLA route,
``ADAPTPOINT_TPU_KERNELS=xla``; the attention also through ``mha_pallas`` in
interpret mode, as ``tests/test_ops.py`` runs it) and through the port, whose
CPU branch is each kernel's plain version. Tolerances:

- indices (kNN, 3-NN) exact: the seeded clouds hold no near-tie between the
  two packages' expanded-form distances; distances rtol 1e-5 / atol 2e-6
  (the expanded form cancels: |q|^2 + |x|^2 - 2qx carries the f32 rounding
  of terms of size 1 into distances near 0);
- ``three_interpolation`` values and gradients rtol 1e-4 / atol 1e-5 where
  the query is not itself a known point. Where it is (every FP-decode level
  holds its known points), the weight is 1 / (dist + 1e-8) with dist the
  square root of the expanded form's ~1e-7 noise, so either package returns
  that known point's feature only to ~1e-3: atol 5e-3 there, and 3-NN
  distances atol 1e-3;
- gathers exact, values and gradients;
- attention, outputs and gradients: 2e-3 * (1 + |ref|). Both sides round
  q, k, v, P, dS and do to bf16 before each product; two correct f32
  computations of P differ in the last bit, and the bf16 rounding turns that
  into 2^-9 relative on single elements.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaptpoint_tpu import ops as jops
from adaptpoint_tpu.ops import geometry as jgeo
from adaptpoint_tpu.ops.pallas.attention import mha_pallas
from adaptpoint_tpu_torch import ops
from adaptpoint_tpu_torch.ops import attention, knn
from adaptpoint_tpu_torch.ops import geometry as pgeo

TOL_MHA = 2e-3


def _cloud(seed, b, n, c=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, c)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1).max()


# ------------------------------------------------------------ index_points

@pytest.mark.parametrize("idx_shape", [(5,), (6, 3), (2, 3, 4)])
def test_index_points_values_and_gradient_match_jax(idx_shape):
    rng = np.random.default_rng(0)
    pts = rng.standard_normal((3, 17, 6)).astype(np.float32)
    idx = rng.integers(0, 17, (3,) + idx_shape).astype(np.int32)
    g = rng.standard_normal((3,) + idx_shape + (6,)).astype(np.float32)
    ref, vjp = jax.vjp(lambda p: jops.index_points(p, jnp.asarray(idx)),
                       jnp.asarray(pts))
    (ref_g,) = vjp(jnp.asarray(g))
    p = torch.from_numpy(pts).requires_grad_()
    out = ops.index_points(p, torch.from_numpy(idx))
    out.backward(torch.from_numpy(g))
    assert out.shape == (3,) + idx_shape + (6,)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref_g), rtol=1e-6,
                               atol=1e-6)


def test_index_points_sends_cuda_gathers_to_the_row_gather_kernel(monkeypatch):
    """On a CUDA tensor every (B, N, C) f32/bf16 gather of any index rank
    >= 2 goes through ``gather_rows`` on the flattened index (the kernel's
    ``autograd.Function``); other types and ranks keep the plain gather. The
    CPU has no card, so the device test is made to answer "CUDA" and the
    kernel entry is stubbed with its plain version, counting calls."""
    calls = []

    def fake_gather_rows(points, idx):
        calls.append((tuple(points.shape), tuple(idx.shape)))
        return ops.gather_rows_plain(points, idx)

    monkeypatch.setattr(ops, "_on_cuda", lambda t: True)
    monkeypatch.setattr(ops, "gather_rows", fake_gather_rows)
    rng = np.random.default_rng(1)
    pts = torch.from_numpy(rng.standard_normal((2, 9, 4)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 9, (2, 3, 5)).astype(np.int32))
    want = pgeo.index_points(pts, idx)
    assert torch.equal(ops.index_points(pts, idx), want)
    assert calls == [((2, 9, 4), (2, 15))]
    assert torch.equal(ops.index_points(pts.bfloat16(), idx[:, 0]),
                       pgeo.index_points(pts.bfloat16(), idx[:, 0]))
    assert len(calls) == 2
    # float64 points, and a rank-1 index, are not the kernel's
    ops.index_points(pts.double(), idx)
    assert len(calls) == 2


# --------------------------------------------------------------------- kNN

@pytest.mark.parametrize("k,n,m", [(3, 40, 17), (24, 40, 4), (24, 8, 16),
                                   (1, 5, 3)])
def test_knn_matches_jax_values_order_and_padding(k, n, m):
    x, q = _cloud(2, 3, n), _cloud(3, 3, m)
    ref_d, ref_i = jgeo.knn_point(k, jnp.asarray(x), jnp.asarray(q))
    d2, idx = ops.knn_point(k, torch.from_numpy(x), torch.from_numpy(q))
    assert idx.dtype == torch.int32 and idx.shape == (3, m, k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(d2.numpy(), np.asarray(ref_d), rtol=1e-5,
                               atol=2e-6)
    # nearest first; a cloud smaller than k repeats its nearest
    assert (np.diff(d2.numpy()[..., :min(k, n)], axis=-1) >= -2e-6).all()
    if k > n:
        assert (idx.numpy()[..., n:] == idx.numpy()[..., :1]).all()
    # the plain kNN and the port's geometry reference agree as well
    np.testing.assert_array_equal(
        knn.knn_idx_plain(k, torch.from_numpy(x), torch.from_numpy(q)).numpy(),
        pgeo.knn_point(k, torch.from_numpy(x), torch.from_numpy(q))[1].numpy())


def test_knn_ties_go_to_the_lowest_index():
    """Every support point appears twice (and the masked points of a fake
    cloud all sit at the origin): equal distances resolve to the lower index
    in both packages."""
    base = _cloud(4, 2, 12)
    x = np.concatenate([base, base], axis=1)
    x[:, 20:] = 0.0
    q = _cloud(5, 2, 7)
    ref_i = np.asarray(jgeo.knn_point(6, jnp.asarray(x), jnp.asarray(q))[1])
    idx = knn.knn_idx_plain(6, torch.from_numpy(x), torch.from_numpy(q))
    np.testing.assert_array_equal(idx.numpy(), ref_i)
    first = idx.numpy()[..., 0]
    assert ((first < 12) | (first == 20)).all()  # never the later twin


def test_knn_distances_are_differentiable_in_both_clouds():
    x, q = _cloud(6, 2, 20), _cloud(7, 2, 9)
    w = np.random.default_rng(8).standard_normal((2, 9, 4)).astype(np.float32)

    def f(x_, q_):
        d2, _ = jops.knn_point(4, x_, q_)
        return jnp.sum(d2 * jnp.asarray(w))

    gx, gq = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(q))
    tx = torch.from_numpy(x).requires_grad_()
    tq = torch.from_numpy(q).requires_grad_()
    d2, idx = ops.knn_point(4, tx, tq)
    assert not idx.requires_grad
    (d2 * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(gq), rtol=1e-4,
                               atol=1e-5)


def test_knn_kernel_wrapper_checks_its_arguments():
    x = torch.zeros(1, 8, 3)
    with pytest.raises(ValueError, match="CUDA"):
        knn.knn_idx_cuda(3, x, x)
    assert knn.LAUNCHES == 0


# ------------------------------------------------------ three_interpolation

def test_three_nn_and_interpolation_match_jax_with_gradient():
    """An FP-decode level: the known points are a subset of the unknown
    ones, so every known point is its own nearest at distance ~0."""
    unknown = _cloud(9, 2, 32)
    known = unknown[:, :16].copy()
    feat = np.random.default_rng(10).standard_normal(
        (2, 16, 12)).astype(np.float32)
    g = np.random.default_rng(11).standard_normal(
        (2, 32, 12)).astype(np.float32)
    ref_d, ref_i = jops.three_nn(jnp.asarray(unknown), jnp.asarray(known))
    dist, idx = ops.three_nn(torch.from_numpy(unknown),
                             torch.from_numpy(known))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_i))
    # sqrt turns the expanded form's 1e-7 noise at d2 ~ 0 into 3e-4
    np.testing.assert_allclose(dist.numpy(), np.asarray(ref_d), rtol=1e-4,
                               atol=1e-3)
    far = np.asarray(ref_d) > 1e-2
    np.testing.assert_allclose(dist.numpy()[far], np.asarray(ref_d)[far],
                               rtol=1e-4)
    ref, vjp = jax.vjp(
        lambda f: jops.three_interpolation(jnp.asarray(unknown),
                                           jnp.asarray(known), f),
        jnp.asarray(feat))
    (ref_g,) = vjp(jnp.asarray(g))
    tf = torch.from_numpy(feat).requires_grad_()
    out = ops.three_interpolation(torch.from_numpy(unknown),
                                  torch.from_numpy(known), tf)
    out.backward(torch.from_numpy(g))
    # a point that coincides with a known one takes a weight of
    # 1 / (dist + 1e-8) with dist ~ 1e-4 of noise on either side: its
    # interpolation is that known point's feature to ~1e-3 either way
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-4, atol=5e-3)
    np.testing.assert_allclose(out.detach().numpy()[:, 16:],
                               np.asarray(ref)[:, 16:], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(ref_g), rtol=1e-4,
                               atol=5e-3)


# --------------------------------------------------------------- attention

def _mha_inputs(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _bf16_ulp(x):
    """The spacing of bf16 values at each entry of ``x`` (0 at 0)."""
    mag = np.abs(np.asarray(x, np.float64))
    exp = np.floor(np.log2(np.where(mag > 0, mag, 1.0)))
    return np.where(mag > 0, 2.0 ** (exp - 7), 0.0)


def _close(got, ref, what):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    err = np.abs(got - ref) / (1.0 + np.abs(ref))
    assert err.max() <= TOL_MHA, (what, float(err.max()))


@pytest.mark.parametrize("shape,scale", [((2, 512, 16), 4.0),
                                         ((3, 40, 32), 32 ** 0.5)])
def test_attention_forward_and_gradient_match_mha_pallas(shape, scale,
                                                         monkeypatch):
    """Against the Pallas kernel itself, in interpret mode on the CPU:
    forward, and ``jax.grad`` of ``sum(sin(out))`` through its flash VJP."""
    monkeypatch.setenv("ADAPTPOINT_TPU_PALLAS_INTERPRET", "1")
    q, k, v = _mha_inputs(12, shape)

    def f(q_, k_, v_):
        return jnp.sum(jnp.sin(mha_pallas(q_, k_, v_, scale)))

    ref = mha_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale)
    ref_g = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v))
    tq, tk, tv = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = ops.fused_self_attention(tq, tk, tv, scale)
    assert out.dtype == torch.float32
    torch.sin(out).sum().backward()
    _close(out.detach().numpy(), ref, "out")
    for name, t, r in zip("qkv", (tq, tk, tv), ref_g):
        _close(t.grad.numpy(), r, "d" + name)
        assert np.abs(t.grad.numpy()).max() > 1e-2


def test_attention_bf16_inputs_match_mha_pallas_at_the_mask_head_length(
        monkeypatch):
    """The main path's type: bf16 q, k, v at N = 2048, as the bf16 policy's
    ``AnchorSelfAttention`` passes them, against the Pallas kernel in
    interpret mode: forward and ``jax.grad`` of ``sum(sin(out))``.

    Tolerance: ``TOL_MHA * (1 + |ref|)`` on the output and on dq. On dk and
    dv that plus one bf16 rounding of the TPU kernel's first partial sum,
    ``2^-8 * |partial|``, plus one bf16 ulp of ``ref``: at N = 2048 its
    backward takes query tiles of 1024 (``_pick_tile``) and accumulates dk,
    dv in their bf16 output blocks, so it rounds the sum over the first 1024
    queries to bf16 before adding the second tile's; the port, like the JAX
    package's XLA route, rounds once. The two f32 sums then differ by up to
    ``2^-8 * |partial|`` and can round to adjacent bf16 values. The partial
    is taken from the plain version's sum over those queries."""
    monkeypatch.setenv("ADAPTPOINT_TPU_PALLAS_INTERPRET", "1")
    shape, scale = (2, 2048, 16), 4.0
    q, k, v = [np.asarray(jnp.asarray(a).astype(jnp.bfloat16)
                          .astype(jnp.float32))
               for a in _mha_inputs(15, shape)]
    jq, jk, jv = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]

    def f(q_, k_, v_):
        return jnp.sum(jnp.sin(mha_pallas(q_, k_, v_, scale)))

    ref = mha_pallas(jq, jk, jv, scale)
    ref_g = jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)
    assert all(g.dtype == jnp.bfloat16 for g in ref_g)
    tq, tk, tv = [torch.tensor(a).bfloat16().requires_grad_()
                  for a in (q, k, v)]
    out = ops.fused_self_attention(tq, tk, tv, scale)
    assert out.dtype == torch.float32
    torch.sin(out).sum().backward()
    _close(out.detach().numpy(), ref, "out")
    assert tq.grad.dtype == tk.grad.dtype == tv.grad.dtype == torch.bfloat16
    _close(tq.grad.float().numpy(), np.asarray(ref_g[0], np.float32), "dq")

    # the plain version's partial sums over the first tile of 1024 queries
    half = shape[1] // 2
    xq, xk, xv = [torch.tensor(a) for a in (q, k, v)]
    do = torch.cos(out.detach())
    p = attention._softmax_plain(xq, xk, scale)
    dp = torch.matmul(attention._b(do), xv.transpose(1, 2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True)) / scale
    partial = {"k": torch.matmul(attention._b(ds)[:, :half].transpose(1, 2),
                                 xq[:, :half]),
               "v": torch.matmul(attention._b(p)[:, :half].transpose(1, 2),
                                 attention._b(do)[:, :half])}
    for name, t, r in (("k", tk, ref_g[1]), ("v", tv, ref_g[2])):
        got, want = t.grad.float().numpy(), np.asarray(r, np.float32)
        bound = (TOL_MHA * (1.0 + np.abs(want))
                 + 2.0 ** -8 * np.abs(partial[name].numpy())
                 + _bf16_ulp(want))
        excess = np.abs(got - want) - bound
        assert excess.max() <= 0.0, ("d" + name, float(excess.max()))
        assert np.abs(got).max() > 1e-2


def test_attention_forward_matches_the_xla_route():
    q, k, v = _mha_inputs(13, (2, 64, 16))
    ref = jops.fused_self_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), 4.0)
    out = attention.mha_plain(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), 4.0)
    _close(out.numpy(), ref, "out")


def test_attention_takes_bf16_inputs_and_returns_their_type_for_gradients():
    q, k, v = [torch.from_numpy(a).bfloat16().requires_grad_()
               for a in _mha_inputs(14, (2, 24, 16))]
    out = ops.fused_self_attention(q, k, v, 4.0)
    assert out.dtype == torch.float32
    out.sum().backward()
    assert q.grad.dtype == k.grad.dtype == v.grad.dtype == torch.bfloat16
    ref = attention.mha_plain(q.detach().float(), k.detach().float(),
                              v.detach().float(), 4.0)
    assert torch.equal(out.detach(), ref)  # bf16 inputs are already rounded


def test_attention_kernel_wrappers_raise_on_cpu_tensors():
    q = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        attention.mha_cuda(q, q, q, 4.0)
    with pytest.raises(ValueError, match="CUDA"):
        attention.mha_bwd_cuda(q, q, q, 4.0, q, (q, q, q))
    with pytest.raises(ValueError, match="CUDA"):
        attention.FusedSelfAttention.apply(q, q, q, 4.0)
    assert attention.LAUNCHES == 0 and attention.LAUNCHES_BWD == 0
