"""The fused SA forward (TPU kernel rows 3 and 5, ``csrc/saeval.cu``) on the
CPU: the host's copy of the CUDA kernel's tiling, and the plain versions at
the kernel's edges against the JAX package's TPU kernels interpreted on the
CPU.

- ``saeval._fwd_tiling`` / ``_fwd_smem_bytes``: the rows a block owns and
  the blocks an SM holds at PointNeXt-S's four stages, at serving width
  (N = 1024) and in the GAN step (N = 2048); that at every K up to 128 and
  widths up to (C, mid, cout) = (512, 896, 2048) the picker returns a
  tiling that fits or raises ValueError; and that it takes every shape the
  kernel it replaced took (a copy of that kernel's shared-memory layout:
  128 rows of round16(K) a block, halved until they fit).
- ``sa_eval_plain`` / ``sa_train_plain`` (which the kernel equals on the
  card within ``chip_smoke.py``'s TOL_SA) against ``sa_eval_pallas`` /
  ``sa_train_pallas`` under ``ADAPTPOINT_TPU_PALLAS_INTERPRET=1`` at K = 24
  (not a multiple of 16), M = 36 (not a multiple of the kernel's 8 centers
  a block), C = 13, on clouds with half their points at the origin
  (duplicate rows, exact ties in the max) and with a zero radius (every
  ball empty): new_xyz and fi bit for bit, out within 2e-2 + 2e-2 |ref|
  (both sides feed bf16-rounded operands to f32-accumulated products; a
  different accumulation order can flip one bf16 rounding of h).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adaptpoint_tpu.ops.pallas.saeval import sa_eval_pallas, sa_train_pallas
from adaptpoint_tpu_torch.ops import saeval

# (N, M, C in, mid, C out) of PointNeXt-S's stages at K = 32: serving
# (N = 1024) and the GAN step's classifier (N = 2048)
SERVE_STAGES = [(1024, 512, 32, 32, 64), (512, 256, 64, 64, 128),
                (256, 128, 128, 128, 256), (128, 64, 256, 256, 512)]
GAN_STAGES = [(2 * n, 2 * m, c, mid, cout)
              for n, m, c, mid, cout in SERVE_STAGES]


def _padded(c, mid, cout):
    return tuple(saeval._round16(v) for v in (c + 3, mid, cout))


@pytest.mark.parametrize("stages", [SERVE_STAGES, GAN_STAGES],
                         ids=["serving", "gan"])
def test_fwd_tiling_at_the_model_stages(stages):
    """256, 256, 128 and 64 rows a block (8, 8, 4, 2 centers of 32 rows),
    two blocks an SM at every stage, the cloud staged in shared memory; at
    N = 2048, M = 1024 a block walks three tiles of its cloud."""
    got = []
    for n, m, c, mid, cout in stages:
        wp, midp, coutp = _padded(c, mid, cout)
        tl = saeval._fwd_tiling(32, wp, midp, coutp, n, 32, m)
        smem = saeval._fwd_smem_bytes(tl.tm, 32, wp, midp, coutp, tl.np,
                                      tl.kc, n, tl.use_xs)
        assert smem <= saeval._SMEM_TWO_BLOCKS, (n, smem)
        assert tl.np == saeval._pass_cols(tl.tm * 32)
        got.append((tl.tm * 32, tl.blocks_per_sm, tl.use_xs, tl.kc,
                    tl.tiles))
    tiles = [3, 1, 1, 1] if stages is GAN_STAGES else [1, 1, 1, 1]
    assert got == [(rows, 2, True, 64, t)
                   for rows, t in zip((256, 256, 128, 64), tiles)]


def _a128(x):
    return (x + 127) // 128 * 128


def _replaced_kernel_smem(tm, k, wp, midp, coutp):
    """Shared memory of the forward this kernel replaced: A and H unpadded,
    a 16 x 16 f32 scratch a warp, the max and slot of each output, the
    neighbours and the centers."""
    rows = tm * saeval._round16(k)
    return (_a128(rows * wp * 2) + _a128(rows * midp * 2) + _a128(8 * 1024)
            + _a128(tm * coutp * 4) + _a128(tm * coutp) + _a128(tm * k * 4)
            + _a128(tm * 16))


def _replaced_kernel_took(k, wp, midp, coutp):
    tm = 128 // saeval._round16(k)
    while tm > 1 and _replaced_kernel_smem(tm, k, wp, midp,
                                           coutp) > saeval._SMEM_LIMIT:
        tm //= 2
    return _replaced_kernel_smem(tm, k, wp, midp,
                                 coutp) <= saeval._SMEM_LIMIT


# up to (512, 512, 1024), and past it where the replaced kernel still fit
# one center a block
WIDTHS = [(c, mid, cout) for c in (3, 32, 35, 64, 128, 256, 384, 448, 512)
          for mid in (16, 40, 128, 256, 464, 512, 896)
          for cout in (mid, 2 * mid, 1024, 2048)]


@pytest.mark.parametrize("k", [1, 8, 24, 32, 48, 64, 100, 128])
def test_fwd_tiling_fits_or_raises(k):
    """A tiling of at most 256 rows that fits (two blocks an SM where it
    says so), or ValueError -- never a launch that cannot run -- and never
    ValueError where the replaced kernel took the shape."""
    for c, mid, cout in WIDTHS:
        wp, midp, coutp = _padded(c, mid, cout)
        try:
            tl = saeval._fwd_tiling(k, wp, midp, coutp, 2048, 32, 1024)
        except ValueError:
            assert not _replaced_kernel_took(k, wp, midp, coutp), (k, c, mid,
                                                                   cout)
            continue
        assert tl.tm * saeval._round16(k) <= 256
        assert tl.np % 16 == 0 and tl.kc % 16 == 0 and tl.tiles >= 1
        smem = saeval._fwd_smem_bytes(tl.tm, k, wp, midp, coutp, tl.np,
                                      tl.kc, 2048, tl.use_xs)
        limit = (saeval._SMEM_TWO_BLOCKS if tl.blocks_per_sm == 2
                 else saeval._SMEM_LIMIT)
        assert smem <= limit, (k, c, mid, cout, tl, smem)


def _case(seed, radius):
    """2 clouds of 128 points in the unit ball, half at the origin, C = 13,
    36 centers, K = 24, folded weights (16 -> 24 -> 40)."""
    b, n, m, c, mid, cout = 2, 128, 36, 13, 24, 40
    rng = np.random.default_rng(seed)
    xyz = rng.standard_normal((b, n, 3)).astype(np.float32)
    xyz /= np.linalg.norm(xyz, axis=-1).max(1)[:, None, None]
    xyz *= (rng.random((b, n)) >= 0.5)[..., None]
    feats = rng.standard_normal((b, n, c)).astype(np.float32)
    q = np.stack([rng.permutation(n)[:m] for _ in range(b)]).astype(np.int32)
    w1 = (rng.standard_normal((3 + c, mid)) / np.sqrt(3 + c)).astype(
        np.float32)
    b1 = (rng.standard_normal(mid) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((mid, cout)) / np.sqrt(mid)).astype(np.float32)
    b2 = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    return xyz, q, feats, w1, b1, w2, b2


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("radius,relative,normalize_dp",
                         [(0.3, True, True), (0.0, True, False),
                          (0.25, False, False)],
                         ids=["ties", "empty-balls", "absolute"])
def test_plain_matches_the_interpreted_kernel_at_the_edges(
        radius, relative, normalize_dp, train, monkeypatch):
    monkeypatch.setenv("ADAPTPOINT_TPU_PALLAS_INTERPRET", "1")
    k = 24
    arrays = _case(3, radius)
    t = [torch.from_numpy(a.copy()) for a in arrays]
    if train:
        new_xyz, fi, out, arg, idx = saeval.sa_train_plain(
            radius, k, *t, relative, normalize_dp)
        ref = sa_train_pallas(radius, k, *(jnp.asarray(a) for a in arrays),
                              relative, normalize_dp, 1, False)
        # the backward's record: each output is the value of its slot, the
        # first slot holding it (torch.argmax's rule, which the kernel's
        # shuffle reduction keeps: ties to the lower slot)
        o = saeval._slot_outputs(radius, k, *t, relative, normalize_dp)[2]
        a = arg.long()
        assert arg.dtype == torch.uint8 and int(a.max()) < k
        assert torch.equal(torch.gather(o, 2, a[:, :, None]).squeeze(2), out)
        hits = o == out[:, :, None]
        assert not (hits & (torch.arange(k)[:, None] < a[:, :, None])).any()
        if radius > 0:
            assert (hits.sum(2) > 1).any()  # the duplicate rows tie
    else:
        new_xyz, fi, out = saeval.sa_eval_plain(radius, k, *t,
                                                relative=relative,
                                                normalize_dp=normalize_dp)
        ref = sa_eval_pallas(radius, k, *(jnp.asarray(a) for a in arrays),
                             relative=relative, normalize_dp=normalize_dp)
    r_new, r_fi, r_out = (np.asarray(v) for v in ref)
    assert out.shape == r_out.shape == (2, 36, 40)
    np.testing.assert_array_equal(new_xyz.numpy(), r_new)
    np.testing.assert_array_equal(fi.numpy(), r_fi)
    np.testing.assert_allclose(out.numpy(), r_out, rtol=2e-2, atol=2e-2)
    if radius == 0.0:
        # every ball empty: all K slots hold point 0
        idx = saeval._grouped_rows(radius, k, t[0], t[1], t[2], relative,
                                   normalize_dp)[1]
        assert (idx == 0).all()
