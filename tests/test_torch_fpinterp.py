"""The 3-NN weighted gather of the port (``ops.fpinterp``, rows 12 and 13 of the
kernel table) against the JAX package, on the CPU.

The port's plain versions, which its CUDA kernels equal bit for bit
(forward) and within the reordering bound (backward) on the card, against
the TPU kernel ``weighted_gather3`` run in interpret mode
(``ADAPTPOINT_TPU_PALLAS_INTERPRET=1``) at shapes it tiles (M and C
multiples of 128), with rows whose neighbours repeat, as
``tests/test_fpinterp.py`` builds them, and more:

- forward within the reordering bound of its three terms a sum:
  ``3 * 2^-23 * sum_j (|hi_j| + |lo_j|) |f_j|`` (both split the merged
  weight the same way; the TPU's matrix unit adds the three products in
  another order);
- ``d_feat`` (bf16) within one bf16 ulp of the larger value, beyond the f32
  reordering bound of its addends (both round their f32 sum once);
- ``d_w`` within ``1e-5 * (1 + |ref|)`` (a 128-term f32 dot product).

Then ``ops.three_interpolation`` against the JAX package's, both fed the
same 3-NN (the JAX package's ``three_nn``): f32 features take the composite
in both, bit for bit (the weights stay f32); bf16 features at a shape the
TPU kernel cannot tile take the port's weighted gather against the JAX
composite (gather, f32 multiply, sum): a different function, held to
``2^-15 * sum_j w_j |f_j|`` forward (the two-way split keeps 16 bits of each
weight) and to four bf16 ulps of the sum of its addends' sizes in
``d_feat`` (the composite rounds each term's cotangent to bf16 and sums them
in bf16, the kernel sums in f32 and rounds once: reading 2.69 on these
inputs).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import adaptpoint_tpu.ops as jops
from adaptpoint_tpu_torch import ops
from adaptpoint_tpu_torch.ops import fpinterp

EPS32 = 2.0 ** -23


def _problem(seed, b, m, c, n):
    """bf16 features, 3-NN-like indices with repeats (slots 0 and 1 of
    row 0, all three slots of row 1, slots 0 and 2 of row 2, slots 1 and 2 of
    row 3) and positive weights summing to 1."""
    rng = np.random.default_rng(seed)
    feat = rng.standard_normal((b, m, c)).astype(np.float32)
    feat = np.array(jnp.asarray(feat, jnp.bfloat16).astype(jnp.float32))
    idx = rng.integers(0, m, size=(b, n, 3)).astype(np.int32)
    idx[:, 0, 1] = idx[:, 0, 0]
    idx[:, 1, 1:] = idx[:, 1, :1]
    idx[:, 2, 2] = idx[:, 2, 0]
    idx[:, 3, 2] = idx[:, 3, 1]
    w = rng.random((b, n, 3)).astype(np.float32) + 1e-3
    w = (w / w.sum(-1, keepdims=True)).astype(np.float32)
    g = rng.standard_normal((b, n, c)).astype(np.float32)
    return feat, idx, w, g


def _bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits)."""
    x = np.maximum(np.abs(np.asarray(x, np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def _torch(feat, idx, w):
    return (torch.from_numpy(feat).to(torch.bfloat16),
            torch.from_numpy(idx), torch.from_numpy(w))


@pytest.mark.parametrize("shape", [(2, 128, 128, 512), (1, 256, 256, 192)],
                         ids=["B2_M128_C128_N512", "B1_M256_C256_N192"])
def test_weighted_gather3_matches_the_interpreted_kernel(shape, monkeypatch):
    monkeypatch.setenv("ADAPTPOINT_TPU_PALLAS_INTERPRET", "1")
    from adaptpoint_tpu.ops.pallas.fpinterp import (weighted_gather3,
                                                    weighted_gather3_fits)
    b, m, c, n = shape
    assert weighted_gather3_fits(n, m, c)
    feat, idx, w, g = _problem(1, b, m, c, n)
    jfeat = jnp.asarray(feat, jnp.bfloat16)
    ref, vjp = jax.vjp(lambda f, ww: weighted_gather3(f, jnp.asarray(idx), ww),
                       jfeat, jnp.asarray(w))
    ref_dfeat, ref_dw = vjp(jnp.asarray(g))
    assert ref.dtype == jnp.float32 and ref_dfeat.dtype == jnp.bfloat16
    ref = np.asarray(ref)
    ref_dfeat = np.asarray(ref_dfeat.astype(jnp.float32))
    ref_dw = np.asarray(ref_dw)

    tf, ti, tw = _torch(feat, idx, w)
    out = fpinterp.weighted_gather3_plain(tf, ti, tw)
    assert out.dtype == torch.float32 and out.shape == (b, n, c)
    hi, lo = fpinterp._split_weights(ti, tw)
    absf = torch.from_numpy(np.abs(feat))
    addends = sum(((hi[..., j:j + 1].abs() + lo[..., j:j + 1].abs())
                   * absf[torch.arange(b)[:, None], ti[..., j].long()])
                  for j in range(3))
    bound = 3 * EPS32 * addends.numpy()
    err = np.abs(out.numpy() - ref)
    assert (err <= bound).all(), float((err - bound).max())

    d_feat, d_w = fpinterp.weighted_gather3_bwd_plain(tf, ti, tw,
                                                      torch.from_numpy(g))
    assert d_feat.dtype == torch.bfloat16 and d_w.dtype == torch.float32
    d_feat = d_feat.float().numpy()
    # the f32 reordering bound of each d_feat entry's addends, then one ulp
    gb = np.asarray(jnp.asarray(g, jnp.bfloat16).astype(jnp.float32))
    terms = (hi + lo).numpy()[..., None] * np.abs(gb)[:, :, None, :]
    abs_sum = np.zeros((b, m, c))
    count = np.zeros((b, m, 1))
    for bb in range(b):
        np.add.at(abs_sum[bb], idx[bb].reshape(-1), terms[bb].reshape(-1, c))
        np.add.at(count[bb], idx[bb].reshape(-1), 1.0)
    tol = count * EPS32 * abs_sum + _bf16_ulp(np.maximum(np.abs(d_feat),
                                                         np.abs(ref_dfeat)))
    err_f = np.abs(d_feat - ref_dfeat)
    assert (err_f <= tol).all(), float((err_f - tol).max())
    np.testing.assert_allclose(d_w.numpy(), ref_dw, rtol=1e-5, atol=1e-5)


def test_weighted_gather3_merges_repeated_neighbours_before_the_split():
    """A row whose three slots share one index weighs it by the merged
    weight's split, not by the sum of each slot's split; the gradient of a
    repeated slot's weight is the whole dot product."""
    feat = torch.tensor([[[1.0, -2.0], [3.0, 0.5]]]).to(torch.bfloat16)
    idx = torch.tensor([[[1, 1, 1]]], dtype=torch.int32)
    w = torch.tensor([[[0.1, 0.3, 0.6]]])
    out = fpinterp.weighted_gather3_plain(feat, idx, w)
    merged = (torch.tensor(0.1) + torch.tensor(0.3)) + torch.tensor(0.6)
    hi = merged.to(torch.bfloat16).float()
    lo = (merged - hi).to(torch.bfloat16).float()
    want = hi * feat[0, 1].float() + lo * feat[0, 1].float()
    assert torch.equal(out[0, 0], want)
    g = torch.tensor([[[0.25, -1.0]]])
    d_feat, d_w = fpinterp.weighted_gather3_bwd_plain(feat, idx, w, g)
    assert torch.equal(d_feat[0, 0].float(), torch.zeros(2))
    assert torch.equal(d_feat[0, 1], (hi * g[0, 0] + lo * g[0, 0])
                       .to(torch.bfloat16))
    dot = float((g[0, 0] * feat[0, 1].float()).sum())
    assert d_w[0, 0].tolist() == [dot] * 3


def test_weighted_gather3_autograd_takes_the_plain_backward():
    """On CPU tensors ``WeightedGather3`` runs the plain versions, forward and
    backward, launches no kernel, and computes ``d_w`` only when asked."""
    feat, idx, w, g = _problem(3, 2, 16, 8, 24)
    tf, ti, tw = _torch(feat, idx, w)
    before = ops.launch_counts()
    f_req = tf.clone().requires_grad_()
    out = fpinterp.WeightedGather3.apply(f_req, ti, tw, False)
    (d_feat,) = torch.autograd.grad(out, (f_req,), torch.from_numpy(g))
    want_feat, _ = fpinterp.weighted_gather3_bwd_plain(tf, ti, tw,
                                                       torch.from_numpy(g))
    assert torch.equal(out, fpinterp.weighted_gather3_plain(tf, ti, tw))
    assert d_feat.dtype == torch.bfloat16 and torch.equal(d_feat, want_feat)
    w_req = tw.clone().requires_grad_()
    out = fpinterp.WeightedGather3.apply(tf, ti, w_req, False)
    (d_w,) = torch.autograd.grad(out, (w_req,), torch.from_numpy(g))
    assert torch.equal(d_w, fpinterp.weighted_gather3_bwd_plain(
        tf, ti, tw, torch.from_numpy(g), need_feat=False)[1])
    assert ops.launch_counts() == before


def _same_three_nn(monkeypatch):
    """The port's ``three_interpolation`` on the JAX package's 3-NN, so both
    packages weigh the same neighbours with the same weights."""
    def three_nn(unknown, known):
        d, i = jops.three_nn(jnp.asarray(unknown.detach().numpy()),
                             jnp.asarray(known.detach().numpy()))
        return torch.from_numpy(np.asarray(d)), torch.from_numpy(np.asarray(i))
    monkeypatch.setattr(ops, "three_nn", three_nn)


def _clouds(seed, b, n, m, c):
    rng = np.random.default_rng(seed)
    unknown = rng.standard_normal((b, n, 3)).astype(np.float32)
    known = rng.standard_normal((b, m, 3)).astype(np.float32)
    known[:, 1] = known[:, 0]  # a tie: two known points at one place
    feat = rng.standard_normal((b, m, c)).astype(np.float32)
    g = rng.standard_normal((b, n, c)).astype(np.float32)
    return unknown, known, feat, g


def test_three_interpolation_f32_is_the_jax_composite_bit_for_bit(
        monkeypatch):
    monkeypatch.setenv("ADAPTPOINT_TPU_KERNELS", "xla")
    _same_three_nn(monkeypatch)
    unknown, known, feat, _ = _clouds(5, 2, 96, 40, 24)
    ref = jops.three_interpolation(jnp.asarray(unknown), jnp.asarray(known),
                                   jnp.asarray(feat))
    before = ops.launch_counts()
    got = ops.three_interpolation(torch.from_numpy(unknown),
                                  torch.from_numpy(known),
                                  torch.from_numpy(feat))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert ops.launch_counts() == before


def test_three_interpolation_bf16_untileable_shape_against_jax_composite(
        monkeypatch):
    monkeypatch.setenv("ADAPTPOINT_TPU_KERNELS", "xla")
    _same_three_nn(monkeypatch)
    from adaptpoint_tpu.ops.pallas.fpinterp import weighted_gather3_fits
    b, n, m, c = 2, 96, 40, 24
    assert not weighted_gather3_fits(n, m, c)
    unknown, known, feat, g = _clouds(6, b, n, m, c)
    jfeat = jnp.asarray(feat, jnp.bfloat16)
    ref, vjp = jax.vjp(lambda f: jops.three_interpolation(
        jnp.asarray(unknown), jnp.asarray(known), f), jfeat)
    (ref_d,) = vjp(jnp.asarray(g))
    assert ref.dtype == jnp.float32 and ref_d.dtype == jnp.bfloat16
    tfeat = torch.from_numpy(feat).to(torch.bfloat16).requires_grad_()
    got = ops.three_interpolation(torch.from_numpy(unknown),
                                  torch.from_numpy(known), tfeat)
    (got_d,) = torch.autograd.grad(got, (tfeat,), torch.from_numpy(g))
    assert got.dtype == torch.float32 and got_d.dtype == torch.bfloat16
    # forward: |w| |f| summed over the three neighbours
    _, idx = jops.three_nn(jnp.asarray(unknown), jnp.asarray(known))
    idx = np.asarray(idx)
    fb = np.abs(np.asarray(jfeat.astype(jnp.float32)))
    scale = np.stack([fb[i][idx[i]].sum(1) for i in range(b)])  # w <= 1
    err = np.abs(got.detach().numpy() - np.asarray(ref))
    assert (err <= 2.0 ** -15 * scale).all(), float((err / scale).max())
    got_d = got_d.float().numpy()
    ref_d = np.asarray(ref_d.astype(jnp.float32))
    d = jops.three_nn(jnp.asarray(unknown), jnp.asarray(known))[0]
    w = 1.0 / (np.asarray(d) + 1e-8)
    w = w / w.sum(-1, keepdims=True)
    abs_sum = np.zeros((b, m, c))
    for i in range(b):
        np.add.at(abs_sum[i], idx[i].reshape(-1),
                  (w[i][..., None] * np.abs(g[i])[:, None, :]).reshape(-1, c))
    # the composite's bf16 scatter-add rounds at every addition: reading
    # 2.69 bf16 ulps of the sum of |addend|s at worst, held at 4
    rel = np.abs(got_d - ref_d) / (2.0 ** -8 * abs_sum + 1e-30)
    assert rel.max() <= 4.0, float(rel.max())
