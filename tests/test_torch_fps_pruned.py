"""The pruned FPS kernel's host side and its arithmetic, on the CPU.

``csrc/fps.cu`` ``fps_pruned_kernel`` (row 1 past 4096 points) sorts a
cloud into buckets and skips, each step, every bucket whose lower bound on
the distance to the last winner is at least its best running minimum. The
card holds the kernel's indices to the plain FPS (``chip_smoke.py``
``FPS_EDGES``); here:

- the bound (``fpsample.bucket_lower_bound``) is <= the f32 FPS distance of
  every point in its box, bit for bit: hypothesis draws boxes, points on
  and in them, q inside and outside, corners and -0.0;
- a step-by-step mirror of the kernel's dataflow (Morton buckets, the
  bound, (minimum, lowest index) keys) gives the plain FPS's indices on a
  uniform room, a room of surfaces and a cloud of duplicated points, and
  touches few buckets late in the run; and on a sphere of the sphere
  protocol padded by resampling (16384 points, 3000 distinct, npoint 4096),
  where every step past the 3000th finds all minima 0 and must pick the
  lowest index, 0, with no bucket below its bound;
- the plan (``fpsample.pruned_plan``, the host copy of the kernel's) and
  the chooser past 16384 points, with no ceiling on N;
- the rooms of surfaces the card's checks and timings use
  (``scripts/surface_rooms.py``) lie on their planes within the jitter;
- the plain FPS at N = 40000 equals the JAX package's, the function the
  port now takes past 32768 points.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from adaptpoint_tpu.ops.geometry import furthest_point_sample_xla
from scripts.surface_rooms import padded_sphere, surface_room
from adaptpoint_tpu_torch.ops import fpsample
from adaptpoint_tpu_torch.ops.geometry import _sq_dist

F32 = np.float32
# finite f32 coordinates of a room's scale and beyond, both signs, -0.0
coord = st.one_of(
    st.floats(-1e4, 1e4, width=32, allow_nan=False),
    st.sampled_from([0.0, -0.0, 1e-38, -1e-38, 1.0, -1.0, 3.0, 4.0]))


@settings(max_examples=300, deadline=None, database=None)
@given(a=st.lists(coord, min_size=3, max_size=3),
       b=st.lists(coord, min_size=3, max_size=3),
       q=st.lists(coord, min_size=3, max_size=3),
       t=st.lists(st.floats(0, 1, width=32), min_size=24, max_size=24),
       inside=st.booleans())
def test_the_bucket_bound_is_below_every_distance_in_the_box(a, b, q, t,
                                                             inside):
    lo = torch.tensor(np.minimum(a, b), dtype=torch.float32)
    hi = torch.tensor(np.maximum(a, b), dtype=torch.float32)
    t = torch.tensor(t, dtype=torch.float32).reshape(8, 3)
    # points in the box: the eight corners, points on its faces and within
    corners = torch.stack([torch.where(torch.tensor(
        [(c >> k) & 1 for k in range(3)], dtype=torch.bool), hi, lo)
        for c in range(8)])
    within = torch.minimum(torch.maximum(lo + t * (hi - lo), lo), hi)
    face = within.clone()
    face[:4, 0], face[4:, 1] = lo[0], hi[1]
    pts = torch.cat([corners, within, face])
    qv = torch.tensor(q, dtype=torch.float32)
    if inside:  # q within the box: the bound is 0
        qv = within[0]
    lb = fpsample.bucket_lower_bound(qv, lo, hi)
    d = _sq_dist(pts, qv[None])
    assert bool((lb <= d).all()), (lb, d.min())
    if inside:
        assert float(lb) == 0.0


def test_the_bucket_bound_keeps_negative_zero_and_its_corner():
    lo = torch.tensor([-0.0, 0.0, -0.0])
    hi = torch.tensor([0.0, -0.0, 1.0])
    q = torch.tensor([-0.0, 0.0, 2.0])
    lb = fpsample.bucket_lower_bound(q, lo, hi)
    assert float(lb) == 1.0 and not torch.signbit(lb)
    # the box's far corner from an outside q: the bound is its distance
    q = torch.tensor([5.0, -3.0, 0.5])
    box_lo, box_hi = torch.tensor([1.0, 1.0, 0.0]), torch.tensor([2.0, 2.0,
                                                                  1.0])
    lb = fpsample.bucket_lower_bound(q, box_lo, box_hi)
    assert float(lb) == float(_sq_dist(torch.tensor([2.0, 1.0, 0.5]), q))


def morton_order(xyz: np.ndarray) -> np.ndarray:
    """The kernel's order: points by the Morton cell of a 16^3 grid over
    the cloud's box (any order within a cell; the result does not depend
    on it)."""
    lo, hi = xyz.min(0), xyz.max(0)
    ext = np.where(hi > lo, hi - lo, 1.0)
    cell = np.clip(((xyz - lo) * (16 / ext)).astype(np.int64), 0, 15)
    code = np.zeros(len(xyz), np.int64)
    for k in range(4):
        for ax in range(3):
            code |= ((cell[:, ax] >> k) & 1) << (3 * k + ax)
    return np.argsort(code, kind="stable")


def pruned_fps_mirror(xyz: torch.Tensor, npoint: int, bucket: int):
    """The kernel's dataflow on one cloud (N, 3) f32 with buckets of
    ``bucket`` points (32, or a larger multiple of 32 as the kernel takes
    past 65536 points), step by step: returns (indices, buckets updated at
    each step)."""
    n = xyz.shape[0]
    s = bucket
    nb = -(-n // s)
    order = torch.from_numpy(morton_order(xyz.numpy()))
    pts = xyz[order]
    ids = order.clone()
    pad = nb * s - n
    pts = torch.cat([pts, torch.zeros(pad, 3)]).reshape(nb, s, 3)
    ids = torch.cat([ids, torch.full((pad,), -1)]).reshape(nb, s)
    real = ids >= 0
    big = torch.tensor(float("inf"))
    lo = torch.where(real[..., None], pts, big).amin(1)
    hi = torch.where(real[..., None], pts, -big).amax(1)
    mind = torch.where(real, torch.tensor(1e10), torch.tensor(-1.0))
    kv = torch.full((nb,), 1e10)
    ki = torch.where(real, ids, torch.tensor(2 ** 31)).amin(1)
    out, touched = [0], []
    q = xyz[0]
    for _ in range(1, npoint):
        near = (fpsample.bucket_lower_bound(q, lo, hi) < kv).nonzero()[:, 0]
        touched.append(len(near))
        m = torch.minimum(mind[near], _sq_dist(pts[near], q[None, None]))
        mind[near] = m
        best = m.amax(1)
        kv[near] = best
        ki[near] = torch.where((m == best[:, None]) & real[near], ids[near],
                               torch.tensor(2 ** 31)).amin(1)
        top = kv.max()
        w = int(torch.where(kv == top, ki, torch.tensor(2 ** 31)).min())
        out.append(w)
        q = xyz[w]
    return torch.tensor(out, dtype=torch.int32), touched


def _uniform(n, seed):
    return (np.random.default_rng(seed).random((n, 3)) * [4, 4, 3]).astype(F32)


def _duplicated(n, seed):
    half = _uniform(n // 2, seed)
    x = np.concatenate([half, half[::-1], half[:n - 2 * (n // 2)]])
    x[::7] = x[0]  # a seventh of the points on the first one
    return x


@pytest.mark.parametrize("kind,bucket", [("uniform", 32), ("surface", 32),
                                         ("duplicated", 32),
                                         ("uniform", 64)])
def test_the_pruned_dataflow_gives_the_plain_fps(kind, bucket):
    n, npoint = 3000, 750
    x = {"uniform": lambda: _uniform(n, 1),
         "surface": lambda: surface_room(n, np.random.default_rng(2))[0],
         "duplicated": lambda: _duplicated(n, 3)}[kind]()
    xyz = torch.from_numpy(x)
    got, touched = pruned_fps_mirror(xyz, npoint, bucket)
    ref = fpsample.furthest_point_sample_plain(xyz[None], npoint)[0]
    assert torch.equal(got, ref)
    nb = -(-n // bucket)
    # every bucket at the first step; late steps touch a small share
    assert touched[0] == nb
    assert np.mean(touched[len(touched) // 2:]) < 0.25 * nb


def test_the_pruned_dataflow_on_a_padded_sphere():
    n, real, npoint = 16384, 3000, 4096
    xyz = torch.from_numpy(padded_sphere(n, real, np.random.default_rng(4)))
    assert len(np.unique(xyz.numpy(), axis=0)) == real
    got, touched = pruned_fps_mirror(xyz, npoint, 32)
    ref = fpsample.furthest_point_sample_plain(xyz[None], npoint)[0]
    assert torch.equal(got, ref)
    assert len(set(ref[:real].tolist())) == real
    assert (ref[real:] == 0).all()
    assert touched[0] == n // 32 and max(touched[real:]) == 0


# ------------------------------------------------------------- the plan

@pytest.mark.parametrize("n,want", [
    (16385, (32, 513, 16416, True, 65664, 65664)),
    (24000, (32, 750, 24000, True, 96000, 96000)),
    (32768, (32, 1024, 32768, True, 131072, 131072)),
    (32769, (32, 1025, 32800, True, 131200, 131200)),
    (100000, (64, 1563, 100032, False, 16384, 500160))])
def test_the_pruned_plan_at_the_chooser_sizes(n, want):
    """Buckets of the smallest multiple of 32 that leaves at most two a
    thread of 1024; the minima in shared memory up to 200 KB of them, in
    the scratch past it; the scratch a cloud 16 bytes a slot (x, y, z,
    index) and 4 more where the minima go there."""
    plan = fpsample.pruned_plan(n)
    assert tuple(plan) == want
    assert plan.buckets <= 2048 and plan.n_pad >= n > plan.n_pad - plan.bucket
    assert tuple(fpsample.fps_tiling(n)) == (1024, 0, "pruned")


def test_the_pruned_plan_forced_and_its_refusals():
    """The plan follows N alone: buckets of 32 up to 65536 points, then the
    next multiple of 32 that keeps two buckets a thread; refused for N < 1
    and where the slots pass the kernel's 32-bit indexing (2**29 float4s:
    the last N it takes is 2**29 - 2**18, in 2048 buckets)."""
    assert fpsample.pruned_plan(65536).bucket == 32
    assert fpsample.pruned_plan(65537).bucket == 64
    last = fpsample.pruned_plan(2 ** 29 - 2 ** 18)
    assert (last.buckets, last.n_pad) == (2048, 2 ** 29 - 2 ** 18)
    for n in (0, -1, 2 ** 29 - 1, 2 ** 29, 2 ** 31 - 1):
        with pytest.raises(ValueError):
            fpsample.pruned_plan(n)
    # the largest minima kept in shared memory: 200 KB
    assert fpsample.pruned_plan(51200).smem_minima
    assert not fpsample.pruned_plan(51201).smem_minima


@pytest.mark.parametrize("n", [65536, 100003, 10 ** 6, 2 ** 27])
def test_the_chooser_has_no_ceiling(n):
    tl = fpsample.fps_tiling(n)
    plan = fpsample.pruned_plan(n)
    assert tl == (1024, 0, "pruned") and plan.n_pad >= n
    assert not plan.smem_minima
    assert plan.bucket % 32 == 0 and plan.buckets <= 2048


# ----------------------------------------------- the function past 32768

def test_plain_fps_past_the_old_ceiling_equals_jax():
    """40000 -> 256 on a room of surfaces: index for index."""
    x, _ = surface_room(40000, np.random.default_rng(4))
    got = fpsample.furthest_point_sample_plain(torch.from_numpy(x)[None], 256)
    ref = np.asarray(furthest_point_sample_xla(jnp.asarray(x[None]), 256))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_the_surface_rooms_lie_on_their_planes():
    """Every point within 5 jitters of a wall, the floor, the ceiling or a
    table top (z = 0.75), colours in 0-255, the same room from the same
    seed."""
    pos, rgb = surface_room(20000, np.random.default_rng(7))
    again, _ = surface_room(20000, np.random.default_rng(7))
    np.testing.assert_array_equal(pos, again)
    gap = np.min(np.abs(np.stack([pos[:, 0], pos[:, 0] - 4, pos[:, 1],
                                  pos[:, 1] - 4, pos[:, 2], pos[:, 2] - 3,
                                  pos[:, 2] - 0.75])), axis=0)
    assert pos.dtype == np.float32 and float(gap.max()) < 5 * 0.003
    assert rgb.min() >= 0 and rgb.max() <= 255
