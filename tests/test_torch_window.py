"""The windowed max-pooled ball group of the port (``ops.window``, rows 20 and
21 of the kernel table) against the JAX package, on the CPU.

The port's plain versions, which its CUDA kernels equal exactly (forward)
and within the reordering bound (backward) on the card, against the TPU
kernels of ``adaptpoint_tpu/ops/pallas/window.py`` run in interpret mode
(``ADAPTPOINT_TPU_PALLAS_INTERPRET=1``), at the size of
``tests/test_window_kernel.py`` (B=2, N=512, M=256, C=16, K=8):

- ``window_prep``: every permutation, the window starts and ``ok`` equal,
  also on a cloud whose keys tie (both sorts are stable);
- the forward equal at ``splits`` 1 and 3, at r = 0.3, 0.05 (an explicit
  narrow width, 384) and 1.5, and on a cloud whose windows overflow
  (``ok`` False), where both give the same truncated balls;
- gradients within ``5e-6 * max(|g|, 1)`` at ``grad_splits`` 1 (the
  TPU kernel sums its one-hot products in another order), also where
  ``ok`` is False and empty balls send their cotangent to row 0;
- where ``ok`` holds, the forward equals the port's own full-N
  ``ops.ball_group_max``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaptpoint_tpu_torch import ops
from adaptpoint_tpu_torch.ops import window

B, N, M, C, K = 2, 512, 256, 16, 8
PREP_KEYS = ("order", "inv", "cperm", "cinv", "qpos", "win")


@pytest.fixture
def jwin(monkeypatch):
    """The JAX package's window module with its kernels interpreted."""
    monkeypatch.setenv("ADAPTPOINT_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.delenv("ADAPTPOINT_TPU_WINDOW", raising=False)
    from adaptpoint_tpu.ops.pallas import window as jw
    return jw


def _case(seed, kind="gauss"):
    rng = np.random.default_rng(seed)
    if kind == "gauss":
        xyz = rng.standard_normal((B, N, 3)).astype(np.float32)
    elif kind == "ties":  # keys on a grid of 0.25: long runs of equal keys
        xyz = (np.round(rng.standard_normal((B, N, 3)) * 4) / 4
               ).astype(np.float32)
    else:  # "overflow": a cloud narrower than the ball along its key axis,
        # away from the origin: the windows overflow, and a center outside
        # its window sees an empty ball
        xyz = np.zeros((B, N, 3), np.float32)
        xyz[..., 1] = rng.standard_normal((B, N)) * 1e-6
        xyz[..., 0] = 3.0 + rng.standard_normal((B, N)) * 0.2
    feats = rng.standard_normal((B, N, C)).astype(np.float32)
    qidx = np.stack([rng.choice(N, M, replace=False)
                     for _ in range(B)]).astype(np.int32)
    return xyz, feats, qidx


def _jax_prep(jw, xyz, qidx, radius, tm, w):
    return jw.window_prep(jnp.asarray(xyz), jnp.asarray(qidx), radius, tm, w)


@pytest.mark.parametrize("kind,radius,tm,width,fits", [
    ("gauss", 0.3, 128, None, True), ("gauss", 0.05, 64, 384, True),
    ("gauss", 1.5, 128, None, True), ("ties", 0.3, 128, None, True),
    ("ties", 0.5, 64, 256, False), ("overflow", 0.3, 128, 256, False)])
def test_window_prep_matches_jax(jwin, kind, radius, tm, width, fits):
    xyz, _, qidx = _case(3, kind)
    w = window.pick_window(512, radius, M, tm, width=width)
    ref = _jax_prep(jwin, xyz, qidx, radius, tm, w)
    got = window.window_prep(torch.from_numpy(xyz), torch.from_numpy(qidx),
                             radius, tm, w)
    for k in PREP_KEYS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
        assert got[k].dtype == torch.int32, k
    np.testing.assert_array_equal(got["xyz_s"].numpy(),
                                  np.asarray(ref["xyz_s"]))
    assert bool(got["ok"]) == bool(ref["ok"])
    assert bool(got["ok"]) == fits
    # the width window_prep reports as needed makes the windows fit
    need = int(got["need"])
    assert need % 128 == 0 and need <= 512
    assert bool(window.window_prep(torch.from_numpy(xyz),
                                   torch.from_numpy(qidx), radius, tm,
                                   need)["ok"])
    if need > 128 and bool(got["ok"]):
        assert need <= w


def test_pick_window_matches_jax(jwin, monkeypatch):
    for n_pad, r, m, tm in ((2048, 0.1, 1024, 256), (1024, 0.2, 512, 256),
                            (512, 0.4, 256, 256), (256, 0.8, 128, 128),
                            (512, 0.05, 256, 64), (512, 1.5, 256, 128)):
        assert window.pick_window(n_pad, r, m, tm) \
            == jwin.pick_window(n_pad, r, m, tm)
    # the grouper shapes' widths
    assert [window.pick_window(n, r, m, 256 if m % 256 == 0 else 128)
            for n, m, r in ((2048, 1024, 0.1), (1024, 512, 0.2),
                            (512, 256, 0.4), (256, 128, 0.8))] \
        == [896, 896, 512, 256]
    monkeypatch.setenv("ADAPTPOINT_TPU_WINDOW", "300")
    assert window.pick_window(512, 0.3, 256, 128, width=300) \
        == jwin.pick_window(512, 0.3, 256, 128) == 384


def _jax_op(jw, monkeypatch, width, radius, xyz, qidx, feats, splits,
            grad_splits, tm):
    if width:
        monkeypatch.setenv("ADAPTPOINT_TPU_WINDOW", str(width))
    return jw.ball_group_maxpool_windowed(
        radius, K, jnp.asarray(xyz), jnp.asarray(qidx), jnp.asarray(feats),
        splits, grad_splits, tm)


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("kind,radius,tm,width", [
    ("gauss", 0.3, 128, None), ("gauss", 0.05, 64, 384),
    ("gauss", 1.5, 128, None), ("overflow", 0.3, 128, 256)])
def test_windowed_forward_matches_jax(jwin, monkeypatch, kind, radius, tm,
                                      width, splits):
    xyz, feats, qidx = _case(0, kind)
    w = window.pick_window(512, radius, M, tm, width=width)
    ok = bool(window.window_prep(torch.from_numpy(xyz),
                                 torch.from_numpy(qidx), radius, tm, w)["ok"])
    assert ok == (kind != "overflow")
    ref = _jax_op(jwin, monkeypatch, width, radius, xyz, qidx, feats, splits,
                  splits, tm)
    got = ops.ball_group_max_windowed(
        radius, K, torch.from_numpy(xyz), torch.from_numpy(qidx),
        torch.from_numpy(feats), splits, splits, tm, w)
    for name, r, g in zip(("new_xyz", "fi", "fmax", "fmin"), ref, got):
        assert g.dtype == torch.float32 and g.shape == r.shape, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(r),
                                      err_msg=name)
    if not ok:
        # truncated: some centers lie outside their windows (zeros) and
        # the result is not the full-N op's
        assert (got[0] == 0).all(dim=-1).any()
        full = ops.ball_group_max(radius, K, torch.from_numpy(xyz),
                                  torch.from_numpy(qidx),
                                  torch.from_numpy(feats))
        assert not torch.equal(full[2], got[2])
    elif splits == 1:
        full = ops.ball_group_max(radius, K, torch.from_numpy(xyz),
                                  torch.from_numpy(qidx),
                                  torch.from_numpy(feats))
        for name, a, b in zip(("new_xyz", "fi", "fmax", "fmin"), full, got):
            assert torch.equal(a, b), name


def _loss(out, xp):
    nx, fi, fmax, fmin = out
    return ((nx ** 2).sum() + (fi * 0.5).sum() + xp.sin(fmax).sum()
            + xp.cos(fmin).sum())


@pytest.mark.parametrize("kind,width", [("gauss", None), ("overflow", 256)])
def test_windowed_gradients_match_jax(jwin, monkeypatch, kind, width):
    radius, tm = 0.3, 128
    xyz, feats, qidx = _case(1, kind)
    if width:
        monkeypatch.setenv("ADAPTPOINT_TPU_WINDOW", str(width))

    def jloss(x, f):
        return _loss(jwin.ball_group_maxpool_windowed(
            radius, K, x, jnp.asarray(qidx), f, 1, 1, tm), jnp)

    jgx, jgf = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(xyz),
                                               jnp.asarray(feats))
    x = torch.from_numpy(xyz).requires_grad_()
    f = torch.from_numpy(feats).requires_grad_()
    out = ops.ball_group_max_windowed(radius, K, x, torch.from_numpy(qidx), f,
                                      1, 1, tm, width)
    gx, gf = torch.autograd.grad(_loss(out, torch), (x, f))
    for name, r, g in (("g_xyz", jgx, gx), ("g_feats", jgf, gf)):
        r = np.asarray(r)
        mag = float(np.abs(r).max())
        assert float(np.abs(g.numpy() - r).max()) <= 5e-6 * max(mag, 1.0), \
            name
    if kind == "overflow":
        # centers outside their windows see balls around the origin; some
        # are empty and send g_fmax + g_fmin to row 0
        prep = window.window_prep(torch.from_numpy(xyz),
                                  torch.from_numpy(qidx), radius, tm, width)
        res = window.ball_group_max_windowed_plain(
            radius, K, torch.from_numpy(xyz), torch.from_numpy(qidx),
            torch.from_numpy(feats), prep, width, tm)
        assert (res[6] == 0).any() and (res[8] < 0).any()
        assert not bool(prep["ok"])


def test_windowed_plain_versions_hold_residuals():
    """The plain forward's residuals agree with its outputs: each output's
    winning slot holds its value, the slots are in-ball and ascending in
    original index, and the backward without cotangents gives nothing."""
    xyz, feats, qidx = _case(2)
    radius, tm = 0.5, 128
    x, f, q = (torch.from_numpy(a) for a in (xyz, feats, qidx))
    w = window.pick_window(512, radius, M, tm)
    prep = window.window_prep(x, q, radius, tm, w)
    assert bool(prep["ok"])
    new_xyz, fi, fmax, fmin, amax, amin, cnt, idx, qrow = \
        window.ball_group_max_windowed_plain(radius, K, x, q, f, prep, w, tm)
    assert torch.equal(qrow, q) and (cnt > 0).all()
    vals = f.to(torch.bfloat16).float()[
        torch.arange(B)[:, None, None], idx.long()]          # (B, M, K, C)
    assert torch.equal(vals.gather(2, amax.long()[:, :, None]).squeeze(2),
                       fmax)
    assert torch.equal(vals.gather(2, amin.long()[:, :, None]).squeeze(2),
                       fmin)
    full = (cnt == K)[..., None]
    steps = idx[..., 1:] - idx[..., :-1]
    assert ((steps > 0) | ~full).all()
    g = window.ball_group_max_windowed_bwd_plain(
        idx, cnt, qrow, amax, amin, None, None, None, None, N)
    assert not g[0].any() and not g[1].any()
