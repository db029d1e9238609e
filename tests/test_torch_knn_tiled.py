"""The tiled kNN instance (kernel row 11 past ``knn_max_points(C)``) on the
CPU: what the kernel does, step by step, held to the plain version the card
holds it to (``chip_smoke.py`` ``check_knn_tiled``, index for index), and
the host's copy of its plan.

- ``tiled_mirror`` replays ``csrc/knn.cu`` ``knn_tiled_kernel`` in numpy:
  the cross products and norms summed from -0 one channel after another in
  64-channel stages, the distances of each 64-point tile, each query's list
  of 32 started by the same bitonic network, then rows of 32 candidates
  filtered by the list's k-th entry and inserted by rank, and the output
  rule. Under hypothesis (ties, -0 and +0, NaN and +inf rows, NaN queries,
  queries equal to support points, k > N, N not a multiple of the tile) it
  equals ``knn_idx_plain``.
- The pair order the kernel sorts by, (distance, index), is the order in
  which the plain version's passes take the distances, -0 and +0 included.
- ``knn_idx_plain`` past ``knn_max_points(C)`` at C = 67 and ragged N
  against JAX's ``knn_point``; its NaN / +inf rule on small cases, and
  where that rule parts from JAX's ``knn_point``, which takes a NaN
  distance first.
- ``knn_tiled_plan`` (the kernel's constants and shared memory), its
  bounds, the chooser past C = 1416 and its refusal past
  ``TILED_MAX_CHANNELS``, and the wrapper's raise on CPU tensors.
"""
from unittest import mock

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax.numpy as jnp

from adaptpoint_tpu.ops import geometry as jgeo
from adaptpoint_tpu_torch.ops import knn

F32 = np.float32
INT_MAX = 2 ** 31 - 1


def _before(d, j, e, i):
    return d < e or (d == e and j < i)


def _warp_sort(d, j):
    """csrc/knn.cu warp_sort: the bitonic network over 32 lanes."""
    d, j = list(d), list(j)
    size = 2
    while size <= 32:
        stride = size >> 1
        while stride > 0:
            nd, nj = list(d), list(j)
            for lane in range(32):
                o = lane ^ stride
                keep_min = ((lane & stride) == 0) == ((lane & size) == 0)
                if (_before(d[o], j[o], d[lane], j[lane]) if keep_min
                        else _before(d[lane], j[lane], d[o], j[o])):
                    nd[lane], nj[lane] = d[o], j[o]
            d, j = nd, nj
            stride >>= 1
        size <<= 1
    return d, j


def _warp_insert(d, j, v, i):
    """csrc/knn.cu warp_insert."""
    rank = sum(_before(d[l], j[l], v, i) for l in range(32))
    if rank < 32:
        d = d[:rank] + [v] + d[rank:31]
        j = j[:rank] + [i] + j[rank:31]
    return d, j


def _sum_from_neg_zero(a, b, c_total, chunk):
    """sum_c a[..., c] * b[..., c] from -0, one channel after another, in
    stages of ``chunk`` channels (the kernel's accumulators)."""
    acc = np.full(np.broadcast_shapes(a.shape[:-1], b.shape[:-1]), -0.0, F32)
    for c0 in range(0, c_total, chunk):
        for c in range(c0, min(c0 + chunk, c_total)):
            acc = (acc + (a[..., c] * b[..., c]).astype(F32)).astype(F32)
    return acc


def tiled_distances(x, q, chunk=64):
    """The kernel's distance tile arithmetic for one cloud: (M, N) f32."""
    c = x.shape[-1]
    with np.errstate(invalid="ignore", over="ignore"):  # NaN / inf rows
        q2 = _sum_from_neg_zero(q, q, c, chunk)
        x2 = _sum_from_neg_zero(x, x, c, chunk)
        cross = _sum_from_neg_zero(q[:, None, :], x[None, :, :], c, chunk)
        return ((q2[:, None] + x2[None, :]).astype(F32)
                - (F32(2.0) * cross).astype(F32)).astype(F32)


def tiled_mirror(k, x, q, tile=64):
    """csrc/knn.cu knn_tiled_kernel on one cloud: x (N, C), q (M, C) f32
    -> (M, k) int32."""
    n_all = x.shape[0]
    dist = tiled_distances(x, q)
    out = np.zeros((q.shape[0], k), np.int32)
    for m in range(q.shape[0]):
        d = j = None
        for base in range(0, n_all, tile):
            n = min(tile, n_all - base)
            for h in range(tile // 32):
                row = []
                for lane in range(32):
                    p = h * 32 + lane
                    v = dist[m, base + p] if p < n else F32(np.nan)
                    row.append((v, base + p, p < n and v < np.inf))
                if base == 0 and h == 0:
                    d, j = _warp_sort([v if ok else F32(np.inf)
                                       for v, _, ok in row],
                                      [i if ok else INT_MAX
                                       for _, i, ok in row])
                    continue
                td, tj = d[k - 1], j[k - 1]
                for v, i, ok in row:  # the ballot, lowest lane first
                    if ok and _before(v, i, td, tj):
                        d, j = _warp_insert(d, j, v, i)
        first = 0 if j[0] == INT_MAX else j[0]
        out[m] = [first if j[l] == INT_MAX else j[l] for l in range(k)]
    return out


def _plain(k, x, q):
    return knn.knn_idx_plain(k, torch.from_numpy(x[None]),
                             torch.from_numpy(q[None]))[0].numpy()


@st.composite
def clouds(draw):
    n = draw(st.integers(1, 150))
    c = draw(st.integers(1, 5))
    m = draw(st.integers(1, 6))
    k = draw(st.integers(1, 32))
    seed = draw(st.integers(0, 2 ** 31))
    rng = np.random.default_rng(seed)
    # few distinct values: many ties and exact zeros of both signs
    vals = np.array([0.0, -0.0, 1.0, -1.0, 0.5, 2.0, -3.0], F32)
    if draw(st.booleans()):
        x = rng.choice(vals, (n, c)).astype(F32)
    else:
        x = rng.standard_normal((n, c)).astype(F32)
    if n > 2 and draw(st.booleans()):  # runs of equal points
        x = np.repeat(x[: -(-n // 3)], 3, axis=0)[:n].copy()
    q = np.concatenate([x[rng.integers(0, n, m // 2 + 1)],
                        rng.standard_normal((m, c)).astype(F32)])[:m].copy()
    bad = draw(st.sampled_from(["none", "nan", "inf", "both", "query"]))
    if bad in ("nan", "both"):
        x[rng.integers(0, n, 1 + n // 10)] = np.nan
    if bad in ("inf", "both"):
        x[rng.integers(0, n, 1 + n // 10), rng.integers(0, c)] = np.inf
    if bad == "query":
        q[0, 0] = np.nan
    return k, x, q


@settings(max_examples=60, deadline=None)
@given(clouds())
def test_tiled_mirror_equals_the_plain_version(case):
    """The kernel's dataflow gives the plain version's indices, whatever the
    ties, zeros, NaN / +inf rows and k against N."""
    k, x, q = case
    np.testing.assert_array_equal(tiled_mirror(k, x, q), _plain(k, x, q))


@settings(max_examples=40, deadline=None)
@given(st.integers(1, 140), st.integers(0, 2 ** 31))
def test_distances_from_neg_zero_in_stages_are_the_plain_bits(c, seed):
    """Accumulators that start at -0 and take C in 64-channel stages give the
    plain expanded_sq_dist's bits: -0 + x == x for every float."""
    rng = np.random.default_rng(seed)
    vals = np.array([0.0, -0.0, 1e-30, -1e30, 3.0, -2.5], F32)
    x = np.where(rng.random((70, c)) < 0.3, rng.choice(vals, (70, c)),
                 rng.standard_normal((70, c))).astype(F32)
    q = np.concatenate([x[:5], -x[5:9]]).copy()
    ref = knn.expanded_sq_dist(torch.from_numpy(q[None]),
                               torch.from_numpy(x[None]))[0].numpy()
    got = tiled_distances(x, q)
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


@settings(max_examples=80, deadline=None)
@given(st.lists(st.sampled_from([0.0, -0.0, 1.0, 0.25, -0.5, 7.0,
                                 float("inf"), float("nan"), -float("inf")]),
                min_size=1, max_size=40))
def test_pair_order_is_the_plain_passes_order(ds):
    """A list kept sorted by the kernel's ``before`` on (distance, index),
    filled in any order (here backwards) with the finite distances of a
    row, is the order in which knn_idx_plain's passes take them, -0 and +0
    included; the slots past them repeat the nearest."""
    d = np.array(ds, F32)
    lst = []
    for i in reversed(range(len(d))):
        if d[i] < np.inf:
            rank = sum(_before(e, j, d[i], i) for e, j in lst)
            lst.insert(rank, (d[i], i))
    first = lst[0][1] if lst else 0
    want = [i for _, i in lst] + [first] * (len(d) - len(lst))
    with mock.patch.object(knn, "expanded_sq_dist",
                           lambda q, x: torch.from_numpy(d)[None, None]):
        got = knn.knn_idx_plain(len(d), torch.zeros(1, len(d), 1),
                                torch.zeros(1, 1, 1))
    assert got[0, 0].tolist() == want


def test_plain_never_selects_nan_or_inf():
    """A NaN or +inf distance is never taken: such slots repeat the
    nearest; a NaN query gets index 0 in every slot."""
    x = np.array([[0.0], [np.nan], [1.0], [np.inf], [3.0]], F32)
    q = np.array([[0.9], [np.nan]], F32)
    got = _plain(5, x, q)
    np.testing.assert_array_equal(got, [[2, 0, 4, 2, 2], [0, 0, 0, 0, 0]])
    np.testing.assert_array_equal(tiled_mirror(5, x, q), got)
    np.testing.assert_array_equal(_plain(8, x, q)[0], [2, 0, 4] + [2] * 5)


@pytest.mark.parametrize("k,jax_idx,port_idx", [
    (3, [[1, 3, 2], [0, 1, 2]], [[2, 0, 4], [0, 0, 0]]),
    (5, [[1, 3, 2, 0, 4], [0, 1, 2, 3, 4]], [[2, 0, 4, 2, 2], [0] * 5])])
def test_nan_rule_parts_from_jax(k, jax_idx, port_idx):
    """Where a distance is not finite the port's rule differs from the
    JAX package's on purpose: JAX's knn_point (k sequential argmins) takes
    a NaN distance first (the NaN row 1, then row 3, whose +inf makes the
    expanded form inf - inf), and a NaN query takes 0, 1, 2, ...; the port
    (its plain version and its kernels alike) never selects one. On finite
    inputs the two agree (the tests above and
    test_knn_plain_matches_jax_past_the_staged_kernel)."""
    x = np.array([[[0.0], [np.nan], [1.0], [np.inf], [3.0]]], F32)
    q = np.array([[[0.9], [np.nan]]], F32)
    _, ref = jgeo.knn_point(k, jnp.asarray(x), jnp.asarray(q))
    np.testing.assert_array_equal(np.asarray(ref)[0], jax_idx)
    got = knn.knn_idx_plain(k, torch.from_numpy(x), torch.from_numpy(q))
    np.testing.assert_array_equal(got[0].numpy(), port_idx)
    np.testing.assert_array_equal(tiled_mirror(k, x[0], q[0]), port_idx)


@pytest.mark.parametrize("k,n,m,c,kind", [(20, 1021, 77, 67, "random"),
                                          (20, 1021, 77, 64, "runs"),
                                          (32, 900, 9, 132, "random")])
def test_knn_plain_matches_jax_at_the_tiled_edges(k, n, m, c, kind):
    """Past knn_max_points(C), at C not a multiple of 4 or of the 64-channel
    stage and N not a multiple of the 64-point tile: the plain version the
    card holds the tiled kernel to equals JAX's knn_point index for index;
    runs of three equal points cross the tiles' edges."""
    assert n > knn.knn_max_points(c)
    assert knn.knn_variant(k, n, c).kind == "tiled"
    rng = np.random.default_rng(n + c)
    x = rng.standard_normal((2, n, c)).astype(F32)
    if kind == "runs":
        x = np.repeat(x[:, : -(-n // 3)], 3, axis=1)[:, :n].copy()
    q = np.concatenate([x[:, : m // 2], rng.standard_normal(
        (2, m - m // 2, c)).astype(F32)], axis=1)
    _, ref = jgeo.knn_point(k, jnp.asarray(x), jnp.asarray(q))
    got = knn.knn_idx_plain(k, torch.from_numpy(x), torch.from_numpy(q))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_tiled_mirror_at_a_dgcnn_like_row():
    """The mirror at N = 1024, C = 64, k = 20 (DGCNN's shape, one cloud, a
    few queries, leaky-ReLU'd features) equals the plain version."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1024, 64)).astype(F32)
    x = np.where(x > 0, x, F32(0.2) * x).astype(F32)
    q = x[[0, 63, 64, 1023]].copy()
    np.testing.assert_array_equal(tiled_mirror(20, x, q), _plain(20, x, q))


def test_tiled_plan_and_refusals():
    """The plan is the kernel's constants: 64 queries a block, 64 points a
    tile, 64 channels a stage, 2 stages; its shared memory, the same at
    every C, within 227 KB and within the half an SM that two blocks
    need (the launch bounds ask for two)."""
    plan = knn.knn_tiled_plan()
    assert plan == (64, 64, 64, 2, 88576)
    ring = plan.stages * (plan.queries + plan.points) * (plan.chunk + 4)
    assert plan.smem_bytes == 4 * (ring + plan.queries * (plan.points + 8)
                                   + plan.queries + plan.points)
    assert plan.smem_bytes <= 227 * 1024
    assert 2 * (plan.smem_bytes + 1024) <= 228 * 1024
    # (chunk + 4) floats a row: 8 consecutive rows start 4 banks apart
    assert sorted((r * (plan.chunk + 4)) % 32 for r in range(8)) == \
        list(range(0, 32, 4))
    # the ring takes any C: only the launcher's int bounds it
    assert knn.TILED_MAX_CHANNELS == INT_MAX
    for c in (3, 64, 67, 128, 1416, 1417, 2100, 65536):
        n = knn.knn_max_points(c) + 1
        assert knn.knn_variant(20, n, c) == ("tiled", knn.MAX_K)
    with pytest.raises(ValueError):
        knn.knn_variant(20, 2000, knn.TILED_MAX_CHANNELS + 1)


def test_tiled_raises_on_cpu_tensors_and_counts_no_launch():
    before = (knn.LAUNCHES, knn.LAUNCHES_TILED)
    with pytest.raises(ValueError, match="CUDA"):
        knn.knn_idx_cuda(20, torch.zeros(1, 60, 2100),
                         torch.zeros(1, 5, 2100))
    with pytest.raises(ValueError, match="CUDA"):
        knn.knn_idx_cuda(20, torch.zeros(1, 1024, 64),
                         torch.zeros(1, 1024, 64))
    assert (knn.LAUNCHES, knn.LAUNCHES_TILED) == before
