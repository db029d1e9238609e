"""The kernels' host side at the S3DIS path's shapes, on the CPU.

``cfgs/s3dis/pointnext-b.yaml`` at B = 8 on crops of N = 24000 points: four
strided SA stages 24000 -> 6000 -> 1500 -> 375 -> 93, one InvResMLP at
stages 1, 3 and 4 and two at stage 2 (query = support), and four FP levels
in the decoder. Pure Python, as ``tests/test_torch_width64_tiling.py`` holds
the width-64 stages; ``chip_smoke.py``'s ``seg`` phase holds the kernels to
their plain versions at the same shapes on the card.

- FPS (row 1): ``fps_tiling`` takes the crop and any larger cloud (the
  pruned kernel, one block a cloud, past 16384 points) and refuses only
  N < 1; the plain FPS at N = 24000 equals the JAX package's FPS index for
  index.
- The ball group (rows 2, 4) at every SA and InvResMLP shape: the tiling
  fits (the 24000-point support is not staged in shared memory), and the
  element counts stay below the kernels' 32-bit indexing
  (``_build.check_int32``, which raises at 2**31).
- The kNN (row 11) at the four FP levels: the support fits
  ``knn_max_points(3)``.
- The PointNeXt-S cfg's fused routes (rows 3, 16-19) at its stages.
- The fused train-BN gate follows the JAX package's: a stage takes the
  fused train-BN route only where its ``N // stride`` centers are a
  multiple of 8, so of S3DIS's four stages only the first (6000 centers);
  1500, 375 and 93 take the ball-group route in both packages.
- The sphere protocol (``pointnext-s_sphere.yaml``, B = 8 spheres of
  N = 16384 points): its four stages 16384 -> 4096 -> 1024 -> 256 -> 64 all
  pass the train-BN gate, and every chooser of the path takes them: FPS
  (the pruned kernel at 16384, the chain below), the ball group, row 3's
  tiling, ``satrainbn.plan_host`` for the five passes, the element counts,
  and the kNN at the four FP levels.
- PointNeXt-L and -XL (``pointnext-{l,xl}.yaml``) at B = 8, N = 24000:
  the ball group at every SA stage and InvResMLP block (XL: width 64,
  blocks [1, 4, 7, 4, 4]) and the kNN at their FP levels.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adaptpoint_tpu.ops.geometry import furthest_point_sample_xla
from adaptpoint_tpu_torch import ops
from adaptpoint_tpu_torch.models import build_model_from_cfg
from adaptpoint_tpu_torch.models.backbone.pointnext import (InvResMLP,
                                                           SetAbstraction)
from adaptpoint_tpu_torch.ops import (_build, ballgroup, fpsample, knn,
                                      saeval, satrainbn)
from adaptpoint_tpu_torch.utils import EasyConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, N, K = 8, 24000, 32
# (N -> M, C in, C out, radius): PointNeXt-B's strided SA stages
SA_STAGES = [(24000, 6000, 32, 64, 0.1), (6000, 1500, 64, 128, 0.2),
             (1500, 375, 128, 256, 0.4), (375, 93, 256, 512, 0.8)]
# (N, C, radius): its InvResMLP blocks, query = support
BLOCKS = [(6000, 64, 0.2), (1500, 128, 0.4), (1500, 128, 0.4),
          (375, 256, 0.8), (93, 512, 1.6)]
# (queries, support, coarse channels): the decoder's FP levels, deepest
# first
FP_LEVELS = [(375, 93, 512), (1500, 375, 256), (6000, 1500, 128),
             (24000, 6000, 64)]
LIMIT, TWO = saeval._SMEM_LIMIT, saeval._SMEM_TWO_BLOCKS


def load_cfg(name):
    cfg = EasyConfig()
    cfg.load(os.path.join(REPO, "cfgs", "s3dis", name), recursive=True)
    return cfg


def model_shapes(cfg, n=N):
    model = build_model_from_cfg(cfg.model, device="cpu", seed=0)
    stages, blocks = [], []
    for stage in model.encoder.encoder:
        for blk in stage:
            if isinstance(blk, SetAbstraction) and blk.use_fused:
                radius, nsample = blk._radius_nsample()
                assert nsample == K
                w1, w2 = (cb.weight_matrix() for cb in
                          (blk.convs[0], blk.convs[-1]))
                stages.append((n, n // blk.stride, w1.shape[1] - 3,
                               w2.shape[0], radius))
                n //= blk.stride
            elif isinstance(blk, InvResMLP):
                g = blk.convs.group_args
                assert g["nsample"] == K
                blocks.append((n, blk.convs.convs[0].conv.out_channels,
                               g["radius"]))
    return model, stages, blocks


def test_the_seg_shapes_are_the_models():
    _, stages, blocks = model_shapes(load_cfg("pointnext-b.yaml"))
    assert [s[:4] for s in stages] == [s[:4] for s in SA_STAGES]
    assert [s[4] for s in stages] == pytest.approx([s[4] for s in SA_STAGES])
    assert [b[:2] for b in blocks] == [b[:2] for b in BLOCKS]
    assert [b[2] for b in blocks] == pytest.approx([b[2] for b in BLOCKS])


# ---------------------------------------------------------------- row 1

@pytest.mark.parametrize("n,want", [(24000, (1024, 0, "pruned")),
                                    (32768, (1024, 0, "pruned")),
                                    (32769, (1024, 0, "pruned")),
                                    (100000, (1024, 0, "pruned"))])
def test_fps_tiling_takes_the_crop(n, want):
    """The crop and past the old ceiling of 32768 points (ROADMAP C.9):
    the pruned kernel, its minima in shared memory while they fit; only
    N < 1 is refused."""
    assert tuple(fpsample.fps_tiling(n)) == want
    assert fpsample.pruned_plan(n).smem_minima == (n < 100000)
    for bad in (0, -1):
        with pytest.raises(ValueError):
            fpsample.fps_tiling(bad)


def test_plain_fps_at_the_crop_equals_jax():
    """24000 -> 1500 (the encoder's first FPS, cut to a quarter of its 6000
    steps), two crops of a 4 x 4 x 3 room: the same indices."""
    x = (np.random.default_rng(0).random((2, N, 3)) * [4, 4, 3]).astype(
        np.float32)
    got = fpsample.furthest_point_sample_plain(torch.from_numpy(x), 1500)
    ref = np.asarray(furthest_point_sample_xla(jnp.asarray(x), 1500))
    np.testing.assert_array_equal(got.numpy(), ref)


# ----------------------------------------------------------- rows 2, 4

@pytest.mark.parametrize("shape", [(n, m, c) for n, m, c, _, _ in SA_STAGES]
                         + [(n, n, c) for n, c, _ in BLOCKS],
                         ids=lambda s: f"{s[0]}-{s[1]}-C{s[2]}")
def test_the_ball_group_tilings_fit(shape):
    n, m, c = shape
    t = ballgroup.fwd_tiling(B, n, m, c, K)
    assert ballgroup.fwd_smem_bytes(t.tm, K, n, t.use_xs, t.cap) <= LIMIT
    assert ballgroup.bwd_smem_bytes(K) <= TWO
    if n == N:  # the crop is too large to stage: the scan reads it from L2
        assert not t.use_xs
    _build.check_int32("ball_group", feats=B * n * c,
                       dpfj=B * K * m * (3 + c))
    assert B * K * m * (3 + c) < 2 ** 31 and B * n * c < 2 ** 31


def test_check_int32_raises_at_two_to_the_31():
    _build.check_int32("x", a=2 ** 31 - 1)
    with pytest.raises(ValueError, match="32-bit"):
        _build.check_int32("x", a=2 ** 31)
    with pytest.raises(ValueError):
        # the first InvResMLP at B = 256: 3.3e9 elements of dpfj
        _build.check_int32("ball_group", dpfj=256 * K * 6000 * 67)


# --------------------------------------------------------------- row 11

@pytest.mark.parametrize("level", FP_LEVELS, ids=lambda lv: f"{lv[0]}-{lv[1]}")
def test_the_knn_takes_the_fp_levels(level):
    nq, ns, _ = level
    assert ns <= knn.knn_max_points(3)
    assert knn.knn_variant(3, ns, 3).kind == "thread"
    _build.check_int32("knn", xyz=B * ns * 3, query=B * nq * 3,
                       idx=B * nq * 3)


# ------------------------------------------- the S model's fused routes

def test_the_s_models_fused_routes_fit():
    """``pointnext-s.yaml`` (sa_layers 2, sa_use_res): row 3 at its four
    stages at B = 8, rows 16-19 at the stage the train-BN gate admits."""
    model, stages, blocks = model_shapes(load_cfg("pointnext-s.yaml"))
    assert not blocks
    assert [s[:2] for s in stages] == [s[:2] for s in SA_STAGES]
    sas = [m for m in model.modules() if isinstance(m, SetAbstraction)
           and m.use_fused]
    model.train()
    admitted = [n for (n, _, _, _, _), sa in zip(stages, sas)
                if sa._fused_trainbn_ok(n)]
    assert admitted == [24000]
    for (n, m, c, cout, _), sa in zip(stages, sas):
        mid = sa.convs[0].conv.out_channels
        Wp, midp, coutp = (saeval._round16(v) for v in (c + 3, mid, cout))
        f = saeval._fwd_tiling(K, Wp, midp, coutp, n, B, m)
        assert saeval._fwd_smem_bytes(f.tm, K, Wp, midp, coutp, f.np, f.kc,
                                      n, f.use_xs) <= LIMIT
        if n not in admitted:
            continue
        for kind in ("STATS", "FWD", "BWD_Y2", "BWD_GH", "BWD_X"):
            k = getattr(satrainbn, kind)
            mid_, cout_ = ((1, 1) if k == satrainbn.STATS else
                           (mid, 1 if k == satrainbn.BWD_X else cout))
            plan = satrainbn.plan_host(k, B, m, K, c, mid_, cout_)
            assert plan.smem <= LIMIT


@pytest.mark.parametrize("n", [24000, 6000, 1500, 375, 96, 64, 24])
def test_the_train_bn_gate_follows_jax(n):
    """JAX ``SetAbstraction.__call__``: ``(p.shape[1] // self.stride) % 8 ==
    0 and self._fused_trainbn_ok(...)``; the port's gate holds both."""
    cfg = load_cfg("pointnext-s.yaml")
    model = build_model_from_cfg(cfg.model, device="cpu", seed=0).train()
    sa = model.encoder.encoder[1][0]
    assert sa.stride == 4
    assert sa._fused_trainbn_ok(n) == ((n // 4) % 8 == 0)
    sa.eval()
    assert not sa._fused_trainbn_ok(n)


def test_a_train_forward_takes_the_routes_the_gate_gives():
    """The S model's form at 320 points (stages of 80, 20, 5 and 1 centers)
    in a fused train-BN forward: the first stage through
    ``ops.sa_trainbn``, the three others through the ball group, as the JAX
    package routes them."""
    cfg = load_cfg("pointnext-s.yaml")
    cfg.model.encoder_args.width = 8
    model = build_model_from_cfg(cfg.model, device="cpu", seed=0).train()
    calls = {"trainbn": [], "ball_group": []}
    orig_t, orig_b = ops.sa_trainbn, ops.ball_group

    def trainbn(radius, nsample, xyz, qidx, *a, **kw):
        calls["trainbn"].append(qidx.shape[1])
        return orig_t(radius, nsample, xyz, qidx, *a, **kw)

    def ball_group(radius, nsample, xyz, qidx, *a, **kw):
        calls["ball_group"].append(qidx.shape[1])
        return orig_b(radius, nsample, xyz, qidx, *a, **kw)

    ops.sa_trainbn, ops.ball_group = trainbn, ball_group
    try:
        rng = np.random.default_rng(3)
        pos = torch.from_numpy((rng.random((2, 320, 3)) * 0.5).astype(
            np.float32))
        x = torch.cat([torch.rand(2, 320, 3), pos[..., 2:]], -1)
        out = model(pos, x, fused_train_bn=True)
    finally:
        ops.sa_trainbn, ops.ball_group = orig_t, orig_b
    assert calls == {"trainbn": [80], "ball_group": [20, 5, 1]}
    assert torch.isfinite(out).all()


# ------------------------------------------- the sphere protocol's shapes

N_SPHERE = 16384
# (N -> M, C in, C out, radius): pointnext-s_sphere.yaml's SA stages
SPHERE_STAGES = [(16384, 4096, 32, 64, 0.1), (4096, 1024, 64, 128, 0.2),
                 (1024, 256, 128, 256, 0.4), (256, 64, 256, 512, 0.8)]
SPHERE_LEVELS = [(256, 64, 512), (1024, 256, 256), (4096, 1024, 128),
                 (16384, 4096, 64)]


def sphere_model():
    model, stages, blocks = model_shapes(load_cfg("pointnext-s_sphere.yaml"),
                                         N_SPHERE)
    sas = [m for m in model.modules() if isinstance(m, SetAbstraction)
           and m.use_fused]
    return model, stages, blocks, sas


def test_the_sphere_shapes_are_the_models():
    _, stages, blocks, _ = sphere_model()
    assert not blocks
    assert [s[:4] for s in stages] == [s[:4] for s in SPHERE_STAGES]
    assert [s[4] for s in stages] == pytest.approx(
        [s[4] for s in SPHERE_STAGES])


@pytest.mark.parametrize("i", range(4), ids=lambda i: f"stage{i + 1}")
def test_the_sphere_stages_fit_every_chooser(i):
    """Stage ``i`` of B = 8 spheres: its FPS, the ball group (the unfused
    route), row 3 (fused eval) and rows 16-19 (fused train-BN: the gate
    passes every stage, ``N // 4`` a multiple of 8)."""
    model, _, _, sas = sphere_model()
    n, m, c, cout, _ = SPHERE_STAGES[i]
    sa = sas[i]
    model.train()
    assert sa._fused_trainbn_ok(n)
    kind = "pruned" if n > 4096 else None
    tiling = fpsample.fps_tiling(n)
    assert (tiling[2] == "pruned") == (kind == "pruned")
    if kind:
        assert fpsample.pruned_plan(n).smem_minima
    t = ballgroup.fwd_tiling(B, n, m, c, K)
    assert ballgroup.fwd_smem_bytes(t.tm, K, n, t.use_xs, t.cap) <= LIMIT
    assert ballgroup.bwd_smem_bytes(K) <= TWO
    _build.check_int32("ball_group", feats=B * n * c,
                       dpfj=B * K * m * (3 + c))
    mid = sa.convs[0].conv.out_channels
    Wp, midp, coutp = (saeval._round16(v) for v in (c + 3, mid, cout))
    f = saeval._fwd_tiling(K, Wp, midp, coutp, n, B, m)
    assert saeval._fwd_smem_bytes(f.tm, K, Wp, midp, coutp, f.np, f.kc, n,
                                  f.use_xs) <= LIMIT
    _build.check_int32("sa_eval", feats=B * n * c,
                       slots=B * m * K * max(Wp, midp, coutp))
    for kind_ in ("STATS", "FWD", "BWD_Y2", "BWD_GH", "BWD_X"):
        k = getattr(satrainbn, kind_)
        mid_, cout_ = ((1, 1) if k == satrainbn.STATS else
                       (mid, 1 if k == satrainbn.BWD_X else cout))
        assert satrainbn.plan_host(k, B, m, K, c, mid_, cout_).smem <= LIMIT
    _build.check_int32("sa_trainbn", feats=B * n * c,
                       rows=B * m * K * max(c + 3, mid, cout))


@pytest.mark.parametrize("level", SPHERE_LEVELS,
                         ids=lambda lv: f"{lv[0]}-{lv[1]}")
def test_the_knn_takes_the_sphere_fp_levels(level):
    nq, ns, c = level
    assert knn.knn_variant(3, ns, 3).kind == "thread"
    _build.check_int32("knn", xyz=B * ns * 3, query=B * nq * 3,
                       idx=B * nq * 3)
    _build.check_int32("gather", rows=B * nq * 3 * c)


# ------------------------------------------ PointNeXt-L and -XL on crops

@pytest.mark.parametrize("name,blocks,width", [
    ("pointnext-l.yaml", [1, 3, 5, 3, 3], 32),
    ("pointnext-xl.yaml", [1, 4, 7, 4, 4], 64)])
def test_l_and_xl_fit_the_choosers_at_the_crop(name, blocks, width):
    """Every ball-group call of the model's B = 8, N = 24000 step (its SA
    stages and InvResMLP blocks, query = support) and its FP levels' kNN."""
    cfg = load_cfg(name)
    assert cfg.model.encoder_args.blocks == blocks
    assert cfg.model.encoder_args.width == width
    _, stages, inv = model_shapes(cfg)
    assert [s[:2] for s in stages] == [s[:2] for s in SA_STAGES]
    assert [s[2] for s in stages] == [width * 2 ** j for j in range(4)]
    assert len(inv) == sum(blocks) - len(blocks)
    for n, m, c in ([(s[0], s[1], s[2]) for s in stages]
                    + [(b[0], b[0], b[1]) for b in inv]):
        t = ballgroup.fwd_tiling(B, n, m, c, K)
        assert ballgroup.fwd_smem_bytes(t.tm, K, n, t.use_xs, t.cap) <= LIMIT
        _build.check_int32("ball_group", feats=B * n * c,
                           dpfj=B * K * m * (3 + c))
    for nq, ns, _ in FP_LEVELS:
        assert knn.knn_variant(3, ns, 3).kind == "thread"
