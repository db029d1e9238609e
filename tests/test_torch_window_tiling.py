"""The host side of the windowed max-pooled ball group's Hopper kernels
(kernel rows 20, 21, ``ops.window``), on the CPU.

- ``fwd_tiling`` (the forward's launch shape: centers a block, the bit-map
  or sorted selection, the channel vector) and ``bwd_tiling`` (row 8's,
  which the windowed backward shares) at the augmentor's four grouper
  shapes and at the edges ``chip_smoke.py`` runs on the card (K = 1 to 255,
  C = 3, 13, 1024, N = 1000, misaligned features, every forced tiling);
- ``fwd_smem_bytes``, the host copy of the forward kernel's shared memory
  (``chip_smoke.py`` holds it equal to the kernel's own), pinned at the
  grouper shapes, and the sorted layout never above the first draft's, so
  that every shape the first draft took is still taken;
- every refusal, raised before any launch;
- the bound the bit-map selection scans within (csrc/window.cu
  ``key_range``), replayed in f32: no window point outside its two binary
  searches is in the ball, on ties, signed zeros and points at the radius.

The plain versions' agreement with the interpreted TPU kernels is
``tests/test_torch_window.py``'s; here the splits it leaves out (2, and
mixed forward / backward splits) are added.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adaptpoint_tpu_torch import ops
from adaptpoint_tpu_torch.ops import ballgroup_max as bgm
from adaptpoint_tpu_torch.ops import window
from test_torch_window import K as JK, _case, jwin  # noqa: F401

SMEM_OPT_IN = 232448  # bytes a block may use on the H100
# the augmentor's groupers at B = 32, K = 24: (N, M, C, radius, tm, the width
# the smoke's clouds need at grouper 1 / pick_window's elsewhere)
GROUPERS = [(2048, 1024, 128, 0.1, 256, 1408), (1024, 512, 256, 0.2, 256, 896),
            (512, 256, 512, 0.4, 256, 512), (256, 128, 1024, 0.8, 128, 256)]
# the chooser's picks there: (centers, bytes of shared memory), and row 8's
# backward slices (channels, rows)
PICKS = [(32, 28160), (16, 17152), (8, 9600), (8, 5248)]
SLICES = [(8, 2048), (16, 1024), (32, 512), (32, 256)]
# chip_smoke.py WINDOW_EDGES' shapes: (B, N, M, C, K, tm, w, aligned)
EDGES = {"n_1000_c_13": (2, 1000, 256, 13, 24, 128, 896, True),
         "k_1_c_3": (2, 1000, 256, 3, 1, 128, 1024, True),
         "k_64_c_1024": (2, 512, 128, 1024, 64, 64, 512, True),
         "k_255": (1, 1000, 128, 16, 255, 128, 1024, True),
         "narrow_window": (2, 1000, 256, 13, 24, 128, 256, True),
         "misaligned": (2, 1000, 256, 16, 24, 128, 512, False)}


def _first_draft_smem(w, k):
    """The first draft's forward layout (window.cu's smem_bytes before its
    redesign): the window's indices to a power of two, its coordinates, 8
    warps' slots."""
    return (1 << (w - 1).bit_length()) * 4 + w * 12 + 8 * k * 4


@pytest.mark.parametrize("i", range(4), ids=[f"grouper_{i + 1}"
                                             for i in range(4)])
def test_launch_shapes_at_the_grouper_shapes(i):
    n, m, c, r, tm, w = GROUPERS[i]
    assert window.pick_window(window._round_up(n, 128), r, m, tm) \
        == (896 if i == 0 else w)
    tl = window.fwd_tiling(32, n, m, c, 24, tm, w)
    assert tl == window.FwdTiling("bitmap", PICKS[i][0], 4)
    assert window.fwd_smem_bytes(tl.design, tl.centers, n, 24, w) \
        == PICKS[i][1]
    # the most centers that still give four blocks an SM on 132 SMs
    assert 32 * m // tl.centers >= 4 * 132 or tl.centers == 8
    assert tuple(window.bwd_tiling(n, c)) == SLICES[i]


@pytest.mark.parametrize("edge", sorted(EDGES))
def test_launch_shapes_at_the_edges(edge):
    b, n, m, c, k, tm, w, aligned = EDGES[edge]
    tl = window.fwd_tiling(b, n, m, c, k, tm, w, aligned)
    assert tl.design == "bitmap" and tm % tl.centers == 0
    assert tl.vec == (4 if aligned and c % 4 == 0 else 1)
    assert window.fwd_smem_bytes(tl.design, tl.centers, n, k, w) \
        <= SMEM_OPT_IN
    bt = window.bwd_tiling(n, c)
    assert bgm.bwd_smem_bytes(bt.s, bt.r) <= SMEM_OPT_IN and bt.r == n
    # every forced tiling chip_smoke.py runs is taken at its shape
    for forced in (("bitmap", 8, 1), ("sorted", 8, 1), ("sorted", 32, 1)):
        if tm % forced[1] == 0:
            assert tuple(window.fwd_tiling(b, n, m, c, k, tm, w, aligned,
                                           *forced)) == forced


@pytest.mark.parametrize("forced", [
    ("bitmap", 32, 4), ("bitmap", 16, 4), ("bitmap", 8, 4), ("bitmap", 32, 1),
    ("sorted", 8, 4), ("sorted", 32, 4), ("sorted", 8, 1)])
def test_forced_tilings_at_grouper_one(forced):
    tl = window.fwd_tiling(4, 2048, 1024, 128, 24, 256, 1408, True, *forced)
    assert tuple(tl) == forced
    smem = window.fwd_smem_bytes(tl.design, tl.centers, 2048, 24, 1408)
    assert smem <= SMEM_OPT_IN
    if tl.design == "sorted" and tl.centers <= 8:
        assert smem <= _first_draft_smem(1408, 24)


def test_every_shape_the_first_draft_took_is_taken():
    """Where the N-bit maps do not fit, the sorted layout at 8 centers takes
    over, never above the first draft's bytes; the chooser raises only
    where the first draft's layout did not fit either."""
    seen = set()
    for n in (1000, 2048, 4096, 12800, 13952, 60000, 250000):
        n_pad = window._round_up(n, 128)
        for w in sorted({128, 1024, 4096, 12800, 13824, n_pad}):
            if w > n_pad:
                continue
            for k in (1, 24, 32, 255):
                took = _first_draft_smem(w, k) <= SMEM_OPT_IN
                try:
                    tl = window.fwd_tiling(2, n, 256, 16, k, 256, w)
                except ValueError:
                    assert not took, (n, w, k)
                    continue
                seen.add(tl.design)
                smem = window.fwd_smem_bytes(tl.design, tl.centers, n, k, w)
                assert smem <= SMEM_OPT_IN
                if tl.design == "sorted":
                    assert smem <= _first_draft_smem(w, k)
    assert seen == {"bitmap", "sorted"}


@pytest.mark.parametrize("args,match", [
    ((32, 2048, 1024, 128, 0, 256, 896), "K <= 255"),
    ((32, 2048, 1024, 128, 256, 256, 896), "K <= 255"),
    ((32, 2048, 1000, 128, 24, 256, 896), "multiple of tm"),
    ((32, 2048, 1024, 0, 24, 256, 896), "C >= 1"),
    ((32, 2048, 1024, 128, 24, 256, 900), "multiple of 128"),
    ((32, 2048, 1024, 128, 24, 256, 0), "multiple of 128"),
    ((32, 2048, 1024, 128, 24, 256, 2176), "multiple of 128"),
    ((2, 20000, 256, 16, 255, 256, 20096), "shared memory")])
def test_the_forward_chooser_refuses(args, match):
    with pytest.raises(ValueError, match=match):
        window.fwd_tiling(*args)


@pytest.mark.parametrize("forced,aligned,match", [
    (("heap", 8, 4), True, "design"), (("bitmap", 64, 4), True, "divide"),
    (("bitmap", 12, 4), True, "divide"), (("bitmap", 8, 4), False, "aligned"),
    (("bitmap", 8, 2), True, "aligned")])
def test_forced_tilings_it_cannot_take_are_refused(forced, aligned, match):
    with pytest.raises(ValueError, match=match):
        window.fwd_tiling(2, 1000, 256, 16, 24, 128, 512, aligned, *forced)
    with pytest.raises(ValueError):
        window.fwd_tiling(2, 1000, 256, 13, 24, 128, 512, True, "bitmap", 8,
                          4)  # C = 13 takes one channel a thread


@pytest.fixture
def no_launch(monkeypatch):
    """The wrappers with the device check lifted and the library replaced by
    one that fails the test if anything reaches it."""
    def launched():
        raise AssertionError("reached the kernel library")
    monkeypatch.setattr(window, "_lib", launched)
    monkeypatch.setattr(window, "_check_inputs", lambda *a, **k: None)


def _fwd_inputs(n=64, m=8, c=5, k=4, tm=8, w=128, splits=1):
    xyz = torch.zeros(1, n, 3)
    q = torch.arange(m, dtype=torch.int32)[None]
    prep = window.window_prep(xyz, q, 0.3, 8, 128, stats_only=True)
    return (0.3, k, xyz, q, torch.zeros(1, n, c), prep, w, tm, splits)


@pytest.mark.parametrize("bad,match", [
    ({"k": 256}, "K <= 255"), ({"k": 0}, "K <= 255"),
    ({"w": 256}, "multiple of 128"), ({"tm": 3}, "multiple of tm"),
    ({"splits": 4}, "1-3"), ({"splits": 0}, "1-3")])
def test_the_forward_wrapper_refuses_before_any_launch(no_launch, bad,
                                                       match):
    before = ops.launch_counts()
    with pytest.raises(ValueError, match=match):
        window.ball_group_max_windowed_cuda(*_fwd_inputs(**bad))
    with pytest.raises(ValueError, match="aligned"):
        window.ball_group_max_windowed_cuda(
            *_fwd_inputs(), tiling=window.FwdTiling("bitmap", 8, 4))
    assert ops.launch_counts() == before


@pytest.mark.parametrize("bad,match", [
    ({"grad_splits": 4}, "1-3"), ({"k": 256}, "K <= 255"),
    ({"cpu": True}, "CUDA tensor")])
def test_the_backward_wrapper_refuses_before_any_launch(no_launch, bad,
                                                        match):
    k = bad.get("k", 4)
    idx = torch.zeros(1, 8, k, dtype=torch.int32)
    cnt = torch.zeros(1, 8, dtype=torch.int32)
    u8 = torch.zeros(1, 8, 5, dtype=torch.uint8)
    before = ops.launch_counts()
    with pytest.raises(ValueError, match=match):
        window.ball_group_max_windowed_bwd_cuda(
            idx, cnt, cnt, u8, u8, None, None, torch.zeros(1, 8, 5), None, 64,
            bad.get("grad_splits", 1))
    assert ops.launch_counts() == before


def _key_range(keys, qk, r2):
    """csrc/window.cu key_range in f32: the positions of the sorted ``keys``
    whose fl(fl(qk - x)^2) < r2, by its two binary searches."""
    f = np.float32

    def sq(x):
        d = f(f(qk) - f(x))
        return f(d * d)

    a, b = 0, len(keys)
    while a < b:
        mid = (a + b) // 2
        if keys[mid] >= qk or sq(keys[mid]) < r2:
            b = mid
        else:
            a = mid + 1
    lo, b = a, len(keys)
    while a < b:
        mid = (a + b) // 2
        if keys[mid] > qk and sq(keys[mid]) >= r2:
            b = mid
        else:
            a = mid + 1
    return lo, a


@pytest.mark.parametrize("kind", ["gauss", "grid", "at_the_radius"])
def test_the_key_range_holds_every_in_ball_point(kind):
    """No point outside [lo, hi) is in the ball (d2 rounded step by step, as
    the kernel and the plain version round it): a selection that scans only
    that range finds the whole ball."""
    rng = np.random.default_rng(7)
    r = np.float32(0.25)
    r2 = np.float32(r * r)
    n = 600
    if kind == "gauss":
        pts = rng.standard_normal((n, 3)).astype(np.float32) * 0.5
    elif kind == "grid":  # long runs of equal keys, and signed zeros
        pts = (np.round(rng.standard_normal((n, 3)) * 4) / 16
               ).astype(np.float32)
        pts[::7, 0] = -0.0
    else:  # points exactly one radius away along the key, or one ulp in
        pts = np.zeros((n, 3), np.float32)
        pts[:, 0] = np.where(rng.random(n) < 0.5, r, -r)
        pts[::3, 0] = np.nextafter(pts[::3, 0], np.float32(0))
        pts[:, 1:] = rng.standard_normal((n, 2)).astype(np.float32) * 1e-3
    for axis in range(3):
        s = pts[np.argsort(pts[:, axis], kind="stable")]
        keys = s[:, axis]
        for q in list(s[::37]) + [np.zeros(3, np.float32)]:
            d = (q[None] - s).astype(np.float32)
            d2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
            inball = np.flatnonzero(d2 < r2)
            lo, hi = _key_range(keys, q[axis], r2)
            assert ((inball >= lo) & (inball < hi)).all(), (axis, q)
            if kind == "at_the_radius" and axis == 0 and not q.any():
                assert hi - lo < n  # the range does cut the window


@pytest.mark.parametrize("splits,grad_splits", [(2, 2), (1, 3), (3, 1)])
def test_other_splits_match_jax(jwin, splits, grad_splits):  # noqa: F811
    """Forward at 2 splits, and forward and backward rounded to different
    splits, against the interpreted TPU kernels (the backward within
    ``5e-6 * max(|g|, 1)``, as ``tests/test_torch_window.py`` holds it)."""
    import jax
    radius, tm = 0.3, 128
    xyz, feats, qidx = _case(4)

    def outs(x, f):
        return jwin.ball_group_maxpool_windowed(
            radius, JK, x, jnp.asarray(qidx), f, splits, grad_splits, tm)

    def loss(o, xp):
        return ((o[0] ** 2).sum() + (o[1] * 0.5).sum() + xp.sin(o[2]).sum()
                + xp.cos(o[3]).sum())

    ref = outs(jnp.asarray(xyz), jnp.asarray(feats))
    jgx, jgf = jax.grad(lambda x, f: loss(outs(x, f), jnp), argnums=(0, 1))(
        jnp.asarray(xyz), jnp.asarray(feats))
    x = torch.from_numpy(xyz).requires_grad_()
    f = torch.from_numpy(feats).requires_grad_()
    got = ops.ball_group_max_windowed(radius, JK, x, torch.from_numpy(qidx),
                                      f, splits, grad_splits, tm)
    for name, a, b in zip(("new_xyz", "fi", "fmax", "fmin"), ref, got):
        np.testing.assert_array_equal(b.detach().numpy(), np.asarray(a),
                                      err_msg=name)
    gx, gf = torch.autograd.grad(loss(got, torch), (x, f))
    for name, r_, g in (("g_xyz", jgx, gx), ("g_feats", jgf, gf)):
        r_ = np.asarray(r_)
        bound = 5e-6 * max(float(np.abs(r_).max()), 1.0)
        assert float(np.abs(g.numpy() - r_).max()) <= bound, name
