"""The fused SA recompute backward (row 6) and the row gather (rows 14, 15) of
the port against the JAX package's TPU kernels interpreted on the CPU, and
the host-side tiling of the CUDA backward.

- ``sa_train_bwd_plain`` (which ``csrc/sa_train_bwd.cu`` equals on the card
  within ``chip_smoke.py``'s TOL_SA_BWD) on the forward's own neighbours and
  winning slots (``sa_train_plain``) against the VJP of ``sa_train_pallas``
  under ``ADAPTPOINT_TPU_PALLAS_INTERPRET=1``, at K = 32 on clouds with half
  their points at the origin, as the GAN step's fake pass gives them: many
  centers then name the same origin points, so the scatter adds many slots
  onto the same rows (the case the kernel's vector reductions must sum).
  Each gradient tensor within 1e-3 of its largest entry, the tolerance
  ``tests/test_torch_gan_route.py`` holds ``ops.sa_train`` to (bf16
  roundings of single addends fall the other way with the sum order).
- ``gather_rows_plain`` and ``gather_rows_bwd_plain`` against
  ``gather_rows_pallas`` and its VJP in TPU interpret mode at C = 3, 4 and
  1024 (scalar, one 16-byte access and a warp of 16-byte accesses a row in
  the kernel), f32 and bf16, with repeated indices: the forward bit for
  bit; the backward bit for bit in bf16 (values in eighths: every sum is
  exact) and within 1e-6 * (1 + |ref|) in f32 (another order of the sum).
- ``saeval._bwd_centers_per_block``: the centers a block owns at the four
  stages of the GAN step's classifier, with and without the weight
  gradients, and that every choice fits the shared memory it claims.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from adaptpoint_tpu.ops.pallas.gather import gather_rows_pallas
from adaptpoint_tpu.ops.pallas.saeval import sa_train_pallas
from adaptpoint_tpu_torch.ops import saeval
from adaptpoint_tpu_torch.ops.gather import (gather_rows_bwd_plain,
                                             gather_rows_plain)


def _fake_clouds(seed, b, n, c):
    """Clouds in the unit ball with half their points moved to the origin
    (identical rows and exact distance ties), and features."""
    rng = np.random.default_rng(seed)
    xyz = rng.standard_normal((b, n, 3)).astype(np.float32)
    xyz /= np.linalg.norm(xyz, axis=-1).max(1)[:, None, None]
    xyz *= (rng.random((b, n)) >= 0.5)[..., None]
    feats = rng.standard_normal((b, n, c)).astype(np.float32)
    return rng, xyz, feats


@pytest.mark.parametrize("param_grads", [False, True])
def test_sa_train_bwd_plain_matches_the_interpreted_kernel_on_fake_clouds(
        param_grads, monkeypatch):
    monkeypatch.setenv("ADAPTPOINT_TPU_PALLAS_INTERPRET", "1")
    b, n, m, c, k, mid, cout, r = 2, 256, 64, 16, 32, 32, 48, 0.3
    rng, xyz, feats = _fake_clouds(5, b, n, c)
    q = np.stack([rng.permutation(n)[:m] for _ in range(b)]).astype(np.int32)
    w1 = (rng.standard_normal((3 + c, mid)) / np.sqrt(3 + c)).astype(
        np.float32)
    b1 = (rng.standard_normal(mid) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((mid, cout)) / np.sqrt(mid)).astype(np.float32)
    b2 = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    gs = [rng.standard_normal(s).astype(np.float32)
          for s in [(b, m, 3), (b, m, c), (b, m, cout)]]
    arrays = (xyz, feats, w1, b1, w2, b2)

    def loss(*args):
        out = sa_train_pallas(r, k, args[0], jnp.asarray(q), *args[1:], True,
                              True, 1, param_grads)
        return sum(jnp.sum(o * g) for o, g in zip(out, gs))

    ref = jax.grad(loss, argnums=tuple(range(6)))(
        *[jnp.asarray(v) for v in arrays])

    t = [torch.from_numpy(v.copy()) for v in arrays]
    qt = torch.from_numpy(q)
    _, _, _, arg, idx = saeval.sa_train_plain(r, k, t[0], qt, t[1], *t[2:],
                                              True, True)
    # the case this test is for: slots of many centers on the same rows
    counts = np.bincount(idx[0].reshape(-1).numpy(), minlength=n)
    assert counts.max() >= 16, counts.max()
    g_xyz, g_feats, wg = saeval.sa_train_bwd_plain(
        r, t[0], qt, t[1], *t[2:], idx, arg, *[torch.from_numpy(g)
                                              for g in gs],
        True, True, param_grads)
    got = [g_xyz, g_feats] + (list(wg) if param_grads else [])
    assert (wg is None) == (not param_grads)
    for name, a, want in zip(("xyz", "feats", "w1", "b1", "w2", "b2"), got,
                             ref):
        want = np.asarray(want)
        scale = float(np.abs(want).max())
        assert scale > 0, name
        err = float(np.abs(a.numpy() - want).max())
        assert err <= 1e-3 * scale, (name, err, scale)


def _interpreted_gather(points, idx, g):
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(lambda p: gather_rows_pallas(p, idx), points)
        (g_pts,) = vjp(g)
    return out, g_pts


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [3, 4, 1024])
def test_gather_rows_plain_matches_the_interpreted_kernel(c, dtype):
    rng = np.random.default_rng(c)
    b, n, m = 2, 40, 96
    idx = rng.integers(0, n, (b, m)).astype(np.int32)  # m > n: repeats
    idx[:, :8] = 7  # one row named eight times
    if dtype == "bfloat16":
        # eighths in [-4, 4): every value and every sum of repeats is exact
        pts = rng.integers(-32, 32, (b, n, c)).astype(np.float32) / 8
        g = rng.integers(-32, 32, (b, m, c)).astype(np.float32) / 8
    else:
        pts = rng.standard_normal((b, n, c)).astype(np.float32)
        g = rng.standard_normal((b, m, c)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ref, ref_g = _interpreted_gather(jnp.asarray(pts).astype(jdt),
                                     jnp.asarray(idx),
                                     jnp.asarray(g).astype(jdt))
    out = gather_rows_plain(torch.from_numpy(pts).to(tdt),
                            torch.from_numpy(idx))
    back = gather_rows_bwd_plain(torch.from_numpy(g).to(tdt),
                                 torch.from_numpy(idx), n)
    assert out.dtype == tdt and back.dtype == tdt
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))
    want = np.asarray(ref_g.astype(jnp.float32))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(back.float().numpy(), want)
    else:
        assert (np.abs(back.numpy() - want)
                <= 1e-6 * (1 + np.abs(want))).all()


# (C in, mid, C out) of the GAN step's classifier stages, K = 32
GAN_CLS_WIDTHS = [(32, 32, 64), (64, 64, 128), (128, 128, 256),
                  (256, 256, 512)]


@pytest.mark.parametrize("param_grads", [False, True])
def test_bwd_tiling_at_the_gan_stages(param_grads):
    """The host's choice of centers a block: two blocks an SM (at most
    _SMEM_TWO_BLOCKS bytes each) at all four stages without the weight
    gradients, 256, 256, 128 and 64 rows; with them fewer rows, one block an
    SM at the widest stage."""
    want = {False: [8, 8, 4, 2], True: [4, 4, 2, 2]}[param_grads]
    got = []
    for c, mid, cout in GAN_CLS_WIDTHS:
        wp, midp, coutp = (saeval._round16(v) for v in (c + 3, mid, cout))
        tm = saeval._bwd_centers_per_block(32, wp, midp, coutp, c,
                                           param_grads)
        got.append(tm)
        rows = saeval._bwd_rows(tm, 32)
        assert rows % 32 == 0 and rows <= 256
        smem = saeval._bwd_smem_bytes(tm, 32, wp, midp, coutp, c,
                                      param_grads)
        assert smem <= saeval._SMEM_LIMIT
        if not param_grads:
            assert smem <= saeval._SMEM_TWO_BLOCKS
    assert got == want


@pytest.mark.parametrize("k", [1, 8, 24, 32, 48, 64, 100, 128])
def test_bwd_tiling_fits_or_raises(k):
    """Every K the forward takes either gets a tiling of at most 256 rows
    that fits, or raises ValueError (never a launch that cannot run)."""
    for c, mid, cout in GAN_CLS_WIDTHS + [(512, 512, 1024)]:
        wp, midp, coutp = (saeval._round16(v) for v in (c + 3, mid, cout))
        for pg in (False, True):
            try:
                tm = saeval._bwd_centers_per_block(k, wp, midp, coutp, c, pg)
            except ValueError:
                assert c >= 256 and k > 32, (k, c, pg)
                continue
            assert saeval._bwd_rows(tm, k) <= 256
            assert saeval._bwd_smem_bytes(tm, k, wp, midp, coutp, c,
                                          pg) <= saeval._SMEM_LIMIT
