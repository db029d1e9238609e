"""The launch choosers at PointNeXt-S width 64 (``cfgs/modelnetc/
pointnext-s*.yaml``, ModelNet40: 40 classes, 1024 points, B = 32), pure
Python on the CPU.

The stages come from the model the cfg builds (its four strided SA
stages: C = 64 -> 128, ..., 512 -> 1024, mid = cout / 2, K = 32) and from
the AdaptPoint step at N = 1024 (the augmentor's four groupers, K = 24,
C = 128 .. 1024; its kNN and FPS). At each the chooser must return a
launch shape whose shared memory, by the host's copy of the kernel's
layout, fits the card (232448 bytes a block; 115712 where it promises two
blocks an SM): the fused SA forward (rows 3, 5: ``saeval._fwd_tiling``)
and backward (row 6: ``_bwd_tiling``, with and without weight gradients),
the four fused train-BN passes (rows 16-19: ``satrainbn.plan_host``), the
ball group (rows 2, 4), the max-pooled ball group (rows 7, 8), and the
FPS and kNN choosers (rows 1, 11). ``chip_smoke.py`` holds these host
copies equal to the kernels' own at the same shapes.
"""
import os

import pytest
import torch

from adaptpoint_tpu_torch.models import build_model_from_cfg
from adaptpoint_tpu_torch.models.backbone.pointnext import SetAbstraction
from adaptpoint_tpu_torch.ops import ballgroup, ballgroup_max, fpsample, knn
from adaptpoint_tpu_torch.ops import saeval, satrainbn
from adaptpoint_tpu_torch.utils import EasyConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, N0, K = 32, 1024, 32
# (N -> M, C in, mid, C out, radius): the four strided SA stages at width 64
STAGES_64 = [(1024, 512, 64, 64, 128, 0.15),
             (512, 256, 128, 128, 256, 0.225),
             (256, 128, 256, 256, 512, 0.3375),
             (128, 64, 512, 512, 1024, 0.50625)]
# the augmentor's groupers at N = 1024: (N -> M, C, radius), K = 24
GROUPERS_1024 = [(1024, 512, 128, 0.1), (512, 256, 256, 0.2),
                 (256, 128, 512, 0.4), (128, 64, 1024, 0.8)]
K_GAN = 24
LIMIT, TWO = saeval._SMEM_LIMIT, saeval._SMEM_TWO_BLOCKS
R16 = saeval._round16


@pytest.mark.parametrize("cfg", ["pointnext-s.yaml",
                                 "pointnext-s_adaptpoint.yaml"])
def test_the_width_64_stages_are_the_models(cfg):
    c = EasyConfig()
    c.load(os.path.join(REPO, "cfgs", "modelnetc", cfg), recursive=True)
    assert c.model.encoder_args.width == 64 and c.num_classes == 40
    model = build_model_from_cfg(c.model, device="cpu", seed=0)
    stages, n = [], N0
    for sa in model.modules():
        if isinstance(sa, SetAbstraction) and sa.use_fused:
            radius, nsample = sa._radius_nsample()
            assert nsample == K
            (w1, w2) = (cb.weight_matrix() for cb in sa.convs)
            stages.append((n, n // sa.stride, w1.shape[1] - 3, w1.shape[0],
                           w2.shape[0], radius))
            n //= sa.stride
    assert [s[:5] for s in stages] == [s[:5] for s in STAGES_64]
    for got, want in zip(stages, STAGES_64):
        assert got[5] == pytest.approx(want[5])


@pytest.mark.parametrize("stage", STAGES_64, ids=lambda s: f"C{s[2]}")
def test_the_fused_sa_tilings_fit(stage):
    n, m, c, mid, cout, _ = stage
    Wp, midp, coutp = R16(c + 3), R16(mid), R16(cout)
    f = saeval._fwd_tiling(K, Wp, midp, coutp, n, B, m)
    fwd = saeval._fwd_smem_bytes(f.tm, K, Wp, midp, coutp, f.np, f.kc, n,
                                 f.use_xs)
    assert fwd <= (TWO if f.blocks_per_sm == 2 else LIMIT)
    assert f.tm >= 1 and f.tiles >= 1
    for pg in (False, True):
        t = saeval._bwd_tiling(K, Wp, midp, coutp, c, pg)
        bwd = saeval._bwd_smem_bytes(t.tm, K, Wp, midp, coutp, c, pg, t.np)
        assert bwd <= (TWO if t.blocks_per_sm == 2 else LIMIT), (pg, t)
    if c == 512:  # stage 4: one block an SM each way, GH whole
        assert f.blocks_per_sm == 1 and t.np == 0


@pytest.mark.parametrize("stage", STAGES_64, ids=lambda s: f"C{s[2]}")
@pytest.mark.parametrize("kind", ["stats", "fwd", "bwd_y2", "bwd_gh",
                                  "bwd_x"])
def test_the_train_bn_plans_fit(stage, kind):
    n, m, c, mid, cout, _ = stage
    k = getattr(satrainbn, kind.upper())
    mid_, cout_ = ((1, 1) if k == satrainbn.STATS else
                   (mid, 1 if k == satrainbn.BWD_X else cout))
    plan = satrainbn.plan_host(k, B, m, K, c, mid_, cout_)
    assert plan.tile in (32, 64, 128) and plan.smem <= LIMIT
    assert plan.smem == satrainbn.smem_bytes(k, plan.tile, K, c, mid_, cout_,
                                             plan.ring)
    for rows in (32, 64, 128):  # forced tiles: taken only where they fit
        forced = satrainbn.plan_host(k, B, m, K, c, mid_, cout_, rows)
        assert forced.smem <= LIMIT


def test_the_train_bn_plan_refuses_what_the_kernel_refuses():
    for args in ((0, B, 64, 256, 512, 1, 1), (1, B, 64, 0, 512, 512, 1024),
                 (1, B, 64, 256, 512, 512, 1024, 48)):
        with pytest.raises(ValueError):
            satrainbn.plan_host(*args)


@pytest.mark.parametrize("stage", STAGES_64, ids=lambda s: f"C{s[2]}")
def test_the_ball_group_tilings_fit(stage):
    n, m, c, _, _, _ = stage
    t = ballgroup.fwd_tiling(B, n, m, c, K)
    assert ballgroup.fwd_smem_bytes(t.tm, K, n, t.use_xs, t.cap) <= LIMIT
    assert ballgroup.bwd_smem_bytes(K) <= TWO


@pytest.mark.parametrize("grouper", GROUPERS_1024, ids=lambda g: f"C{g[2]}")
def test_the_gan_step_groupers_fit(grouper):
    n, m, c, _ = grouper
    for dt in (torch.float32, torch.bfloat16):
        t = ballgroup_max.fwd_tiling(B, n, m, c, K_GAN, dt)
        assert ballgroup_max.fwd_smem_bytes(t.tm, K_GAN, n, t.use_xs) <= TWO
    b = ballgroup_max.bwd_tiling(n, c)
    assert ballgroup_max.bwd_smem_bytes(b.s, b.r) <= TWO and b.r == n


def test_the_gan_steps_fps_and_knn_choosers_take_n_1024():
    assert fpsample.fps_tiling(N0) is not None
    for k, n in [(3, m) for _, m, _, _ in GROUPERS_1024] + [(24, 64)]:
        assert knn.knn_variant(k, n, 3) is not None
