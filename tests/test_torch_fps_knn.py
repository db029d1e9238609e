"""FPS (kernel row 1) and exact kNN (row 11) of the port on the CPU: the plain
versions the CUDA kernels are held to on the card (``chip_smoke.py``, index
for index), against the JAX package, and the host-side choosers of the
kernels' launch shapes.

- ``furthest_point_sample_plain`` against ``furthest_point_sample_pallas``
  in interpret mode and ``furthest_point_sample_xla``, exact, at N = 1000 and
  4097 (not multiples of the TPU kernel's 128 lanes or the CUDA kernel's
  blocks), npoint = 1 and npoint = N, a cloud with half its points at the
  origin (ties of the running minimum) and B = 1.
- ``knn_idx_plain`` against ``adaptpoint_tpu.ops.geometry.knn_point``,
  exact, at k = 32 (the kernel's MAX_K, past the JAX package's iterated
  min at 24: its ``top_k`` route), C = 35 (feature-space kNN), k > N and
  every point twice (ties to the lower index).
- ``fps_tiling`` (the chain kernel's threads a cloud by N and points a
  thread up to 4096 points, the pruned kernel past it, any N) and
  ``knn_variant`` (a thread or a warp a query by k, N, C; the list length;
  the tiled instance past the staged support), including the shapes at
  which each refuses.
- Both wrappers raise on CPU tensors and count no launch.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adaptpoint_tpu.ops import geometry as jgeo
from adaptpoint_tpu.ops.pallas.fps import furthest_point_sample_pallas
from adaptpoint_tpu_torch.ops import fpsample, knn


def _cloud(seed, b, n, c=3, dropped=0.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, c)).astype(np.float32)
    if dropped:
        x *= (rng.random((b, n)) >= dropped)[..., None]
    return x


# (B, N, npoint, share of points at the origin)
FPS_CASES = [(2, 1000, 1, 0.0), (2, 1000, 1000, 0.0), (1, 4097, 4097, 0.0),
             (1, 4097, 333, 0.0), (2, 1024, 512, 0.5), (1, 256, 64, 0.0)]


@pytest.mark.parametrize("b,n,npoint,dropped", FPS_CASES)
def test_fps_plain_matches_pallas_and_xla(b, n, npoint, dropped):
    xyz = _cloud(n + npoint, b, n, dropped=dropped)
    got = fpsample.furthest_point_sample_plain(torch.from_numpy(xyz),
                                               npoint).numpy()
    assert got.dtype == np.int32 and got.shape == (b, npoint)
    assert (got[:, 0] == 0).all()
    pallas = np.asarray(furthest_point_sample_pallas(jnp.asarray(xyz),
                                                     npoint, True))
    xla = np.asarray(jgeo.furthest_point_sample_xla(jnp.asarray(xyz),
                                                    npoint))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, xla)
    if npoint == n and not dropped:  # distinct points: each once
        assert all(len(set(r)) == n for r in got)


# (k, B, N, M, C, kind of support)
KNN_CASES = [(32, 2, 200, 17, 3, "random"), (32, 1, 40, 9, 3, "random"),
             (8, 2, 60, 11, 35, "random"), (32, 2, 90, 5, 35, "random"),
             (24, 2, 10, 7, 3, "random"), (5, 2, 3, 4, 35, "random"),
             (6, 2, 24, 7, 3, "twice"), (32, 2, 48, 7, 3, "twice"),
             (12, 2, 30, 6, 35, "twice")]


@pytest.mark.parametrize("k,b,n,m,c,kind", KNN_CASES)
def test_knn_plain_matches_jax_knn_point(k, b, n, m, c, kind):
    """Indices equal, nearest first, the lower index first among equal
    distances; a cloud smaller than k repeats its nearest."""
    if kind == "twice":  # every point twice, a quarter of them at the origin
        half = _cloud(k + n, b, n // 2, c)
        x = np.concatenate([half, half], axis=1)
        x[:, ::4] = 0.0
    else:
        x = _cloud(k + n, b, n, c)
    q = _cloud(k + m + 1, b, m, c)
    _, ref = jgeo.knn_point(k, jnp.asarray(x), jnp.asarray(q))
    got = knn.knn_idx_plain(k, torch.from_numpy(x), torch.from_numpy(q))
    assert got.dtype == torch.int32 and got.shape == (b, m, k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    if k > n:
        assert (got.numpy()[..., n:] == got.numpy()[..., :1]).all()
    if kind == "twice":  # of equal points the lowest index comes first
        for bi in range(b):
            for j in got.numpy()[bi, :, 0]:
                same = np.all(x[bi] == x[bi, j], axis=-1)
                assert j == np.argmax(same)


PRUNED = (1024, 0, "pruned")


@pytest.mark.parametrize("n,want", [(1, (512, 1)), (300, (512, 1)),
                                    (1024, (512, 2)), (2048, (512, 4)),
                                    (2049, (1024, 4)), (4096, (1024, 4)),
                                    (4097, PRUNED), (16384, PRUNED),
                                    (16385, PRUNED), (24000, PRUNED),
                                    (24577, PRUNED), (32768, PRUNED),
                                    (51200, PRUNED), (51201, PRUNED)])
def test_fps_tiling_by_n(n, want):
    """The chain kernel on 512 threads a cloud up to 2048 points, then 1024
    up to 4096, points a thread the power of two that covers N (the
    coordinates in registers); past 4096 the pruned kernel on 1024 threads,
    its running minima in shared memory up to 51200 points and in the
    scratch past them (its plan, from N)."""
    tl = fpsample.fps_tiling(n)
    assert tl == fpsample.FpsTiling(*want)
    if tl.kind == "chain":
        assert tl.threads * tl.per_thread >= n \
            > tl.threads * tl.per_thread // 2 or tl.per_thread == 1
    else:
        plan = fpsample.pruned_plan(n)
        assert plan.n_pad >= n and plan.smem_minima == (n <= 51200)


def test_fps_tiling_forced_threads_and_refusals():
    """The instance follows N alone: every N up to 65536 (and a few far
    past it) gets one of the kernels' compiled instances, each instance is
    used, and only N < 1 is refused: the old ceiling of 32768 points is
    gone (ROADMAP C.9)."""
    used = {tuple(fpsample.fps_tiling(n))
            for n in list(range(1, 65537)) + [100003, 10 ** 7]}
    assert used == set(fpsample.FPS_INSTANCES)
    for n in (0, -1):
        with pytest.raises(ValueError):
            fpsample.fps_tiling(n)
    assert not hasattr(fpsample, "FPS_MAX_POINTS")


@pytest.mark.parametrize("k,n,c,want", [
    (3, 1024, 3, ("thread", 3)), (3, 128, 3, ("thread", 3)),
    (1, 5, 3, ("thread", 1)), (4, 64, 3, ("thread", 4)),
    (5, 8, 3, ("thread", 8)), (8, 2048, 3, ("thread", 8)),
    (24, 128, 3, ("warp", 4)), (24, 1024, 3, ("warp", 32)),
    (9, 1024, 3, ("warp", 16)), (32, 1024, 3, ("warp", 32)),
    (32, 20, 3, ("warp", 1)), (3, 300, 35, ("warp", 4)),
    (8, 300, 35, ("warp", 8)), (16, 7, 35, ("warp", 1))])
def test_knn_variant_by_k_n_c(k, n, c, want):
    """A thread a query at C = 3 and k <= 8 (a list of k up to 4, else 8);
    a warp a query otherwise, each lane's list min(k, ceil(N / 32)) rounded
    up to a power of two."""
    assert tuple(knn.knn_variant(k, n, c)) == want


def test_knn_variant_refusals():
    """Past knn_max_points(C) the support no longer fits shared memory
    whole and the tiled instance takes it (any N); what is refused is k
    outside 1-32, N < 1 and C outside 1 to the tiled instance's widest."""
    assert knn.knn_max_points(3) == 227 * 1024 // 16 == 14528
    assert knn.knn_max_points(35) == 227 * 1024 // 144
    knn.knn_variant(32, knn.knn_max_points(3), 3)
    for n, c in ((knn.knn_max_points(3) + 1, 3),
                 (knn.knn_max_points(35) + 1, 35)):
        assert knn.knn_variant(3, n, c).kind == "tiled"
    for k, n, c in ((0, 10, 3), (33, 10, 3), (3, 0, 3), (3, 10, 0),
                    (3, 10, knn.TILED_MAX_CHANNELS + 1)):
        with pytest.raises(ValueError):
            knn.knn_variant(k, n, c)


def test_wrappers_raise_on_cpu_tensors_and_count_no_launch():
    before = (fpsample.LAUNCHES, knn.LAUNCHES)
    x = torch.zeros(1, 8, 3)
    with pytest.raises(ValueError, match="CUDA"):
        fpsample.furthest_point_sample_cuda(x, 4)
    with pytest.raises(ValueError, match="CUDA"):
        knn.knn_idx_cuda(3, x, x)
    with pytest.raises(ValueError, match="CUDA"):
        knn.knn_idx_cuda(32, torch.zeros(1, 8, 35), torch.zeros(1, 2, 35))
    assert (fpsample.LAUNCHES, knn.LAUNCHES) == before
