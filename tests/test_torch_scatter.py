"""The scatter-adds of rows 13 and 15 (``ops.scatter_rows``, shared by
``ops.fpinterp``'s d_feat backward and ``ops.gather``'s backward) on the CPU.

- ``choose``, the host-side launch shape of ``csrc/scatter_rows.cuh``, gives
  every shape the first-draft kernels took an instance (the GAN step's
  decode levels and head pooling, the resampling shape with distinct rows,
  FPS's gather under autograd, C = 1, 3, 4 and C off the vector, misaligned
  rows, slots past one round of shared memory, rows past one tile) within
  the kernels' own limits, picks the design the timings chose at the GAN
  step's shapes, and refuses only what the kernels cannot address.
- ``scatter_rows_ordered``, the plain function of the kernels' sum order
  (each row from 0, its slots ascending, which the kernels equal bit for bit
  on the card), reproduces a slot-by-slot f32 loop exactly, leaves unnamed
  rows zero and drops slots outside the rows.
- ``weighted_gather3_bwd_ordered`` and ``gather_rows_bwd_ordered`` against
  the JAX package's TPU kernels in interpret mode
  (``ADAPTPOINT_TPU_PALLAS_INTERPRET=1``, as ``tests/test_torch_fpinterp.py``
  runs them) within the bounds those tests hold the plain versions to: d_feat
  within the f32 reordering bound plus one bf16 ulp, the row gather's
  backward within 1e-6 * (1 + |ref|) in f32 and exact in bf16 on eighths.
- The CUDA wrappers raise ``ValueError`` on CPU tensors before any launch.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from adaptpoint_tpu.ops.pallas.gather import gather_rows_pallas
from adaptpoint_tpu_torch import ops
from adaptpoint_tpu_torch.ops import fpinterp, gather
from adaptpoint_tpu_torch.ops import scatter_rows as sr

EPS32 = 2.0 ** -23
SMEM_OPT_IN = 232448  # bytes of shared memory a block may use on sm_90

# (B, slots S, destination rows M, C, aux (the weighted gather), source
# element bytes, 16-byte aligned): shapes the first drafts took
SHAPES = {
    "row 13 decode 2048": (32, 6144, 1024, 128, True, 4, True),
    "row 13 decode 1024": (32, 3072, 512, 256, True, 4, True),
    "row 13 decode 512": (32, 1536, 256, 512, True, 4, True),
    "row 13 decode 256": (32, 768, 128, 1024, True, 4, True),
    "row 13 C=3": (2, 900, 77, 3, True, 4, True),
    "row 13 C=5 misaligned": (2, 150, 3000, 5, True, 4, False),
    "row 13 slots past a round": (2, 24000, 40, 8, True, 4, True),
    "row 13 rows past a tile": (1, 30000, 4096, 64, True, 4, True),
    "row 15 head pooling f32": (32, 96, 128, 1024, False, 4, True),
    "row 15 head pooling bf16": (32, 96, 128, 1024, False, 2, True),
    "row 15 decode f32": (32, 6144, 1024, 128, False, 4, True),
    "row 15 decode bf16": (32, 3072, 512, 256, False, 2, True),
    "row 15 resample": (32, 1024, 2048, 4, False, 4, True),
    "row 15 fps under autograd": (32, 1200, 2048, 4, False, 4, True),
    "row 15 C=1": (2, 500, 97, 1, False, 4, True),
    "row 15 C=3": (3, 777, 301, 3, False, 4, True),
    "row 15 C=4 bf16": (2, 40, 5000, 4, False, 2, True),
    "row 15 C=6 bf16": (8, 9000, 300, 6, False, 2, True),
    "row 15 misaligned": (8, 9000, 300, 64, False, 4, False),
    "row 15 slots past a round": (2, 100000, 50, 12, False, 4, True),
    "row 15 rows past a tile": (4, 20000, 100000, 16, False, 4, True),
}


@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
def test_choose_gives_every_first_draft_shape_an_instance(shape):
    B, S, M, C, aux, elem, aligned = shape
    t = sr.choose(*shape)
    assert t.design in sr.DESIGNS.values()
    if t.design == sr.L2RED:  # a thread a slot and a vector of channels
        assert t.vec in (1, 4) and C % t.vec == 0
        assert B * S * C <= 1 << 18
        return
    lanes = 1 << t.lshift
    assert t.vec in (1, 4, 8) and C % t.vec == 0 and 1 <= lanes <= 32
    assert t.vec == 1 or aligned
    assert t.vec != 8 or elem == 2 or t.design == sr.STAGED
    assert t.rows % (256 // lanes) == 0 and t.rows <= 1024  # whole groups
    assert 1 <= t.chunk <= min(S, 65535)  # 16-bit list entries
    assert t.chunk == S or t.chunk % 3 == 0  # rounds stage whole 3-NN rows
    smem = sr.smem_bytes(t, S, aux, S // 3)
    assert smem <= SMEM_OPT_IN
    if t.design == sr.STAGED:  # one round, one tile: the whole cloud
        assert aux and t.chunk == S and t.rows >= M and t.vec == 8
    else:  # the grid addresses every tile and slice
        assert B * -(-M // t.rows) < 2 ** 31
        assert -(-C // (lanes * t.vec)) < 65536


def test_choose_picks_the_timed_designs_at_the_gan_step_shapes():
    """STAGED at the decode's first level (C = 1024), ORDERED at the
    others and at every row-15 shape of the f32 step, L2RED at the
    resampling shape; tiles of 128 rows, a warp a row, 16-byte accesses."""
    picks = {k: sr.choose(*v) for k, v in SHAPES.items()}
    assert picks["row 13 decode 256"] == sr.ScatterTiling(sr.STAGED, 8, 4,
                                                          128, 768)
    for k in ("row 13 decode 512", "row 13 decode 1024",
              "row 13 decode 2048", "row 15 head pooling f32",
              "row 15 decode f32"):
        assert picks[k].design == sr.ORDERED and picks[k].vec == 4, k
        assert picks[k].lshift == 5 and picks[k].rows == 128, k
    assert picks["row 15 decode bf16"].vec == 8
    assert picks["row 15 resample"].design == sr.L2RED
    for k, t in picks.items():  # one launch's smem fits two blocks an SM
        assert sr.smem_bytes(t, SHAPES[k][1], SHAPES[k][4],
                             SHAPES[k][1] // 3) <= 115712, k


@pytest.mark.parametrize("shape", [(1, 8, 2 ** 31, 4), (0, 8, 8, 4),
                                   (2, 0, 8, 4), (2, 8, 8, 0)])
def test_choose_refuses_only_what_the_kernels_cannot_address(shape):
    with pytest.raises(ValueError):
        sr.choose(*shape, False, 4)


def test_choose_refuses_staged_where_it_does_not_fit():
    with pytest.raises(ValueError):
        sr.choose(32, 6144, 1024, 128, True, 4, True, design=sr.STAGED)
    with pytest.raises(ValueError):  # row 15 has no staged instance
        sr.choose(32, 768, 128, 1024, False, 4, True, design=sr.STAGED)


def test_scatter_rows_ordered_is_the_ascending_f32_sum():
    """Addends chosen so that the f32 sum depends on the order: the
    function equals a slot-by-slot loop from 0, bit for bit."""
    rng = np.random.default_rng(0)
    b, s, m, c = 2, 300, 17, 5
    add = (rng.standard_normal((b, s, c))
           * 10.0 ** rng.integers(-6, 7, (b, s, 1))).astype(np.float32)
    dest = rng.integers(-2, m + 2, (b, s))  # some outside [0, m)
    dest[:, 10:20] = 3  # one row named many times
    got = sr.scatter_rows_ordered(torch.from_numpy(add),
                                  torch.from_numpy(dest), m).numpy()
    want = np.zeros((b, m, c), np.float32)
    for bb in range(b):
        for k in range(s):
            if 0 <= dest[bb, k] < m:
                want[bb, dest[bb, k]] = (want[bb, dest[bb, k]]
                                         + add[bb, k]).astype(np.float32)
    np.testing.assert_array_equal(got, want)
    unnamed = [r for r in range(m) if r not in set(dest[0])]
    assert (got[0, unnamed] == 0).all()
    # a different order gives different bits somewhere: the order matters
    rev = sr.scatter_rows_ordered(torch.from_numpy(add[:, ::-1].copy()),
                                  torch.from_numpy(dest[:, ::-1].copy()), m)
    assert not torch.equal(rev, torch.from_numpy(got))


def _fp_problem(seed, b, m, c, n):
    """As tests/test_torch_fpinterp.py builds them: bf16 features, indices
    with repeated neighbours, positive weights summing to 1."""
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
    x = np.maximum(np.abs(np.asarray(x, np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(x)) - 7)


@pytest.mark.parametrize("shape", [(2, 128, 128, 512), (1, 256, 256, 192)],
                         ids=["B2_M128_C128_N512", "B1_M256_C256_N192"])
def test_weighted_gather3_bwd_ordered_matches_the_interpreted_kernel(
        shape, monkeypatch):
    monkeypatch.setenv("ADAPTPOINT_TPU_PALLAS_INTERPRET", "1")
    from adaptpoint_tpu.ops.pallas.fpinterp import weighted_gather3
    b, m, c, n = shape
    feat, idx, w, g = _fp_problem(2, b, m, c, n)
    _, vjp = jax.vjp(lambda f: weighted_gather3(f, jnp.asarray(idx),
                                                jnp.asarray(w)),
                     jnp.asarray(feat, jnp.bfloat16))
    (ref,) = vjp(jnp.asarray(g))
    ref = np.asarray(ref.astype(jnp.float32))
    ti, tw, tg = (torch.from_numpy(a) for a in (idx, w, g))
    got = fpinterp.weighted_gather3_bwd_ordered(ti, tw, tg, m)
    assert got.dtype == torch.bfloat16 and got.shape == (b, m, c)
    got = got.float().numpy()
    hi, lo = fpinterp._split_weights(ti, tw)
    gb = np.asarray(jnp.asarray(g, jnp.bfloat16).astype(jnp.float32))
    terms = (hi + lo).numpy()[..., None] * np.abs(gb)[:, :, None, :]
    abs_sum, count = np.zeros((b, m, c)), np.zeros((b, m, 1))
    for bb in range(b):
        np.add.at(abs_sum[bb], idx[bb].reshape(-1), terms[bb].reshape(-1, c))
        np.add.at(count[bb], idx[bb].reshape(-1), 1.0)
    tol = count * EPS32 * abs_sum + _bf16_ulp(np.maximum(np.abs(got),
                                                         np.abs(ref)))
    err = np.abs(got - ref)
    assert (err <= tol).all(), float((err - tol).max())
    # and the plain version (scatter_add_'s order) within the same bound
    plain = fpinterp.weighted_gather3_bwd_plain(
        torch.from_numpy(feat).to(torch.bfloat16), ti, tw, tg,
        need_w=False)[0].float().numpy()
    assert (np.abs(got - plain) <= tol).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [3, 4, 1024])
def test_gather_rows_bwd_ordered_matches_the_interpreted_kernel(c, dtype):
    rng = np.random.default_rng(10 + c)
    b, n, m = 2, 40, 96
    idx = rng.integers(0, n, (b, m)).astype(np.int32)  # m > n: repeats
    idx[:, :8] = 7  # one row named eight times
    if dtype == "bfloat16":  # eighths: every sum of repeats is exact
        g = rng.integers(-32, 32, (b, m, c)).astype(np.float32) / 8
    else:
        g = rng.standard_normal((b, m, c)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    pts = jnp.zeros((b, n, c), jdt)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda p: gather_rows_pallas(p, jnp.asarray(idx)),
                         pts)
        (ref,) = vjp(jnp.asarray(g).astype(jdt))
    want = np.asarray(ref.astype(jnp.float32))
    got = gather.gather_rows_bwd_ordered(torch.from_numpy(g).to(tdt),
                                         torch.from_numpy(idx), n)
    assert got.dtype == tdt and got.shape == (b, n, c)
    got = got.float().numpy()
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:
        assert (np.abs(got - want) <= 1e-6 * (1 + np.abs(want))).all()
    assert (got[:, [r for r in range(n) if r not in set(idx[0])
                    and r not in set(idx[1])]] == 0).all()


def test_scatter_wrappers_raise_on_cpu_tensors_before_any_launch():
    before = ops.launch_counts()
    g = torch.zeros((2, 6, 4))
    idx = torch.zeros((2, 6), dtype=torch.int32)
    with pytest.raises(ValueError):
        gather.gather_rows_bwd_cuda(g, idx, 3)
    feat = torch.zeros((2, 3, 4), dtype=torch.bfloat16)
    i3 = torch.zeros((2, 2, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        fpinterp.weighted_gather3_bwd_cuda(feat, i3, torch.ones((2, 2, 3)),
                                           torch.zeros((2, 2, 4)),
                                           need_w=False)
    assert ops.launch_counts() == before
