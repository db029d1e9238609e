"""The classifier's train step on the fused train-BN route, on the CPU.

``cfgs/synthetic/pointnext-tiny.yaml``'s model (its head's dropout set to 0:
the route concerns the encoder) carries the same numpy weights in the port
and the JAX package and sees the same batch. The port's train forward and
backward with ``fused_train_bn`` (its SA stages through ``ops.sa_trainbn``,
the plain versions of the four kernel passes on the CPU) is held against the port's
own unfused step and against the JAX model's unfused train forward under
``jax.grad``: the logits, the BatchNorm running statistics after the step
and every parameter's gradient.

The tolerance calibrates itself, as the JAX package's
``test_trainbn_module_parity`` does: a tensor's noise is the larger of the
unfused step's distance from itself with every train BatchNorm taking
flax's variance formula ``E[x^2] - E[x]^2`` (the same function in other
roundings) and from the JAX step, floored at 1e-6 of the largest entry of
its kind; the fused step must sit within 8 times that noise of both.
"""
import contextlib
import copy
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaptpoint_tpu.models import build_model_from_cfg as jax_build
from adaptpoint_tpu.utils import EasyConfig as JaxConfig
from adaptpoint_tpu_torch import ops
from adaptpoint_tpu_torch.engine import (TrainState, build_train_tools,
                                         make_train_step)
from adaptpoint_tpu_torch.models import build_model_from_cfg
from adaptpoint_tpu_torch.utils import EasyConfig
from adaptpoint_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_train_step import _grads_by_name, _randomize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from chip_smoke import flax_formula_bn  # noqa: E402  (the smoke's calibration)
CFG = os.path.join(REPO, "cfgs", "synthetic", "pointnext-tiny.yaml")
B, N = 8, 128
NOISE, FLOOR = 8.0, 1e-6


def _cfgs():
    jcfg, pcfg = JaxConfig(), EasyConfig()
    jcfg.load(CFG, recursive=True)
    pcfg.load(CFG, recursive=True)
    for c in (jcfg, pcfg):
        c.model.cls_args.dropout = 0.0
    return jcfg, pcfg


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    pos = (rng.standard_normal((B, N, 3)) * 0.4).astype(np.float32)
    x = np.concatenate([pos, np.abs(pos[..., 1:2])], -1)
    r = rng.standard_normal((B, 5)).astype(np.float32)
    return pos, x, r


@pytest.fixture(scope="module")
def runs():
    """Logits, buffers after the step and gradients by name: JAX unfused,
    port unfused, port unfused under flax's variance formula, port fused."""
    jcfg, pcfg = _cfgs()
    pos, x, r = _batch()
    jmodel = jax_build(jcfg.model)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(pos[:2]),
                            jnp.asarray(x[:2]), training=False)
    variables = _randomize(variables, 1)
    base = build_model_from_cfg(pcfg.model, device="cpu")
    rows = [[k, list(v.shape)] for k, v in base.state_dict().items()]
    base.load_state_dict(state_dict_from_jax(variables, rows))

    def loss_fn(params):
        logits, upd = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(pos), jnp.asarray(x), training=True,
            mutable=["batch_stats"])
        return jnp.sum(logits * r), (logits, upd["batch_stats"])

    (_, (logits, stats)), grads = jax.value_and_grad(
        loss_fn, has_aux=True)(variables["params"])
    buffers = state_dict_from_jax(
        {"params": variables["params"], "batch_stats": jax.tree_util.tree_map(
            np.asarray, stats)}, rows)
    out = {"jax": {"logits": torch.from_numpy(np.asarray(logits)),
                   **{"buffer." + k: v for k, v in buffers.items()
                      if k.endswith(("running_mean", "running_var"))},
                   **{"grad." + k: v for k, v in _grads_by_name(
                       grads, variables, rows).items()
                      if not k.endswith(("running_mean", "running_var",
                                         "num_batches_tracked"))}}}

    def port(fused, flax_formula=False):
        net = copy.deepcopy(base).train()
        net.zero_grad()
        with flax_formula_bn() if flax_formula else contextlib.nullcontext():
            logits = net(torch.from_numpy(pos), torch.from_numpy(x),
                         fused_train_bn=fused)
        (logits * torch.from_numpy(r)).sum().backward()
        got = {"logits": logits.detach()}
        got.update({"buffer." + k: v.clone() for k, v in
                    net.state_dict().items()
                    if k.endswith(("running_mean", "running_var"))})
        got.update({"grad." + k: p.grad.clone()
                    for k, p in net.named_parameters()})
        return got

    out["unfused"] = port(False)
    out["flax_formula"] = port(False, flax_formula=True)
    calls = []
    orig_op = ops.sa_trainbn
    try:
        ops.sa_trainbn = lambda *a, **k: calls.append(1) or orig_op(*a, **k)
        out["fused"] = port(True)
    finally:
        ops.sa_trainbn = orig_op
    out["fused_calls"] = len(calls)
    return out


def _noise(runs, key):
    kind = key.split(".")[0]
    scale = max(float(v.abs().max()) for k, v in runs["unfused"].items()
                if k.split(".")[0] == kind)
    ref = runs["unfused"][key]
    return max(float((runs["flax_formula"][key] - ref).abs().max()),
               float((runs["jax"][key] - ref).abs().max()),
               FLOOR * scale)


def test_the_fused_route_runs_the_two_strided_stages(runs):
    assert runs["fused_calls"] == 2  # strides [1, 2, 2, 1]: two SA stages
    assert set(runs["fused"]) == set(runs["unfused"])
    assert set(runs["jax"]) == set(runs["unfused"])


@pytest.mark.parametrize("kind", ["logits", "buffer", "grad"])
@pytest.mark.parametrize("against", ["unfused", "jax"])
def test_fused_step_within_the_unfused_steps_noise(runs, kind, against):
    keys = [k for k in runs["unfused"] if k.split(".")[0] == kind]
    assert keys
    worst = ("", 0.0)
    for key in keys:
        d = float((runs["fused"][key] - runs[against][key]).abs().max())
        ratio = d / _noise(runs, key)
        worst = max(worst, (key, ratio), key=lambda t: t[1])
        assert ratio <= NOISE, (key, d, _noise(runs, key))
    print(kind, against, "worst ratio to the noise:", worst)


def test_make_train_step_takes_the_fused_route_on_request():
    """``make_train_step(..., fused_train_bn=True)`` calls the fused op once
    a strided stage; the default stays unfused."""
    _, pcfg = _cfgs()
    pcfg.num_points = 64
    calls = []
    orig_op = ops.sa_trainbn
    pos, x, _ = _batch(1)
    batch = {"x": torch.from_numpy(x), "y": torch.arange(B) % 5}
    try:
        ops.sa_trainbn = lambda *a, **k: calls.append(1) or orig_op(*a, **k)
        for fused in (False, True):
            net = build_model_from_cfg(pcfg.model, device="cpu", seed=0)
            crit, opt, _ = build_train_tools(pcfg, net)
            step = make_train_step(net, opt, crit, pcfg,
                                   fused_train_bn=fused)
            _, loss, _ = step(TrainState(net, opt), batch, torch.arange(64),
                              0.002)
            assert np.isfinite(float(loss))
            assert len(calls) == (2 if fused else 0)
    finally:
        ops.sa_trainbn = orig_op


# ---- ROADMAP C.1: the routes as the mean outgrows the spread --------------
# One stage (2 clouds of 96 points, 16 centers, K = 8, C = mid = 16, cout =
# 24, radius 0.6, dp normalised) whose conv1 outputs sit at |mean| / std =
# RATIO times their spread per channel (features offset by a constant, W1
# positive), through the port's fused route (``ops.sa_trainbn``: the plain
# passes on the CPU), the port's unfused route (ball group, conv, the port's
# train-mode batch_norm with its two-pass variance, relu, conv, batch_norm,
# max) and the JAX fused oracle (``sa_trainbn_pallas`` interpreted). Per
# ratio, the stated tolerances (each tensor's max |a - b| over its largest
# entry; the output and all eight cotangents) that the pairs must meet; the
# readings on the CPU were, at 1, 10, 100: fused against the JAX fused
# 1.2e-6, 7.5e-6, 1.9e-3, the unfused route against either 7.0e-7, 1.9e-2,
# 1.8e-2, and the unfused route against its own float64 twin 2.6e-6 (at 10)
# and 1.8e-5 (at 100). Both fused routes compute BN1's variance as flax's
# E[y^2] - E[y]^2 from the row sums (the TPU kernel's form), and their
# backward amplifies its rounding: beyond |mean| / std of about 10 their
# gradients move by ~2e-2 together while the unfused route stays at f32
# grade. Past 100 all three part (scripts/torch_bn_variance_vs_flax.py).
C1_SHAPE = dict(B=2, N=96, M=16, C=16, mid=16, cout=24, K=8, radius=0.6)
# 1.5: PointNeXt-S's S3DIS stage 1 on rooms of surfaces with raw colours
# (ROADMAP C.8, test_the_s3dis_stage1_conv1_spread), held as 1 is; readings
# on the CPU 1.2e-6, 7.8e-7, 1.2e-6 and 1.2e-6 against float64.
C1_TOL = {1: {"fused_jax": 1e-5, "unfused_fused": 1e-5, "unfused_f64": 1e-5},
          1.5: {"fused_jax": 1e-5, "unfused_fused": 1e-5,
                "unfused_f64": 1e-5},
          10: {"fused_jax": 5e-5, "unfused_fused": 5e-2, "unfused_f64": 1e-4},
          100: {"fused_jax": 1e-2, "unfused_fused": 5e-2,
                "unfused_f64": 1e-4}}
C1_NAMES = ("out", "xyz", "feats", "w1", "gamma1", "beta1", "w2", "gamma2",
            "beta2")


def _c1_problem(ratio, seed=0):
    s = C1_SHAPE
    rng = np.random.default_rng(seed)
    xyz = (rng.standard_normal((s["B"], s["N"], 3)) * 0.5).astype(np.float32)
    qidx = np.stack([rng.permutation(s["N"])[:s["M"]]
                     for _ in range(s["B"])]).astype(np.int32)
    w1 = (np.abs(rng.standard_normal((s["C"] + 3, s["mid"]))) * 0.3
          ).astype(np.float32)
    # y1 = v W1: the offset c of every feature gives each channel a mean of
    # about c * 0.8 sqrt(C) times its spread
    feats = (ratio / 3.2 + rng.standard_normal((s["B"], s["N"], s["C"]))
             ).astype(np.float32)
    g1 = (rng.standard_normal(s["mid"]) * 0.5 + 1.0).astype(np.float32)
    b1 = (rng.standard_normal(s["mid"]) * 0.2).astype(np.float32)
    w2 = (rng.standard_normal((s["mid"], s["cout"])) * 0.3).astype(np.float32)
    g2 = (rng.standard_normal(s["cout"]) * 0.5
          + np.sign(rng.standard_normal(s["cout"]))).astype(np.float32)
    b2 = (rng.standard_normal(s["cout"]) * 0.2).astype(np.float32)
    cot = [rng.standard_normal(shape).astype(np.float32) for shape in
           ((s["B"], s["M"], 3), (s["B"], s["M"], s["C"]),
            (s["B"], s["M"], s["cout"]))]
    return xyz, qidx, feats, (w1, g1, b1, w2, g2, b2), cot


def _c1_port(fused, problem, dtype=torch.float32):
    xyz, qidx, feats, params, cot = problem
    s = C1_SHAPE
    leaves = [torch.tensor(a, dtype=dtype, requires_grad=True)
              for a in (xyz, feats) + tuple(params)]
    x, f, w1, g1, b1, w2, g2, b2 = leaves
    q = torch.from_numpy(qidx)
    if fused:
        new, fi, out = ops.sa_trainbn(s["radius"], s["K"], x, q, f, w1, g1,
                                      b1, w2, g2, b2, relative=True,
                                      normalize_dp=True)[:3]
    else:
        new, fi, dpfj, _ = ops.ball_group(s["radius"], s["K"], x, q, f, True,
                                          True)
        y = torch.nn.functional.batch_norm(
            (dpfj @ w1).reshape(-1, s["mid"]), None, None, g1, b1, True, 0.0,
            1e-5)
        y = torch.relu(y).reshape(s["B"], s["K"], s["M"], s["mid"]) @ w2
        y = torch.nn.functional.batch_norm(
            y.reshape(-1, s["cout"]), None, None, g2, b2, True, 0.0, 1e-5)
        out = y.reshape(s["B"], s["K"], s["M"], s["cout"]).amax(dim=1)
    total = sum((a * torch.tensor(r, dtype=dtype)).sum()
                for a, r in zip((new, fi, out), cot))
    return [out.detach().double().numpy()] + [
        g.double().numpy() for g in torch.autograd.grad(total, leaves)]


def _c1_jax(problem, monkeypatch):
    monkeypatch.setenv("ADAPTPOINT_TPU_PALLAS_INTERPRET", "1")
    from adaptpoint_tpu.ops.pallas.satrainbn import sa_trainbn_pallas
    xyz, qidx, feats, params, cot = problem
    s = C1_SHAPE

    def loss(xyz, feats, *p):
        new, fi, out = sa_trainbn_pallas(s["radius"], s["K"], xyz,
                                         jnp.asarray(qidx), feats, *p,
                                         normalize_dp=True)[:3]
        return (jnp.sum(out * cot[2]) + jnp.sum(fi * cot[1])
                + jnp.sum(new * cot[0])), out

    (_, out), g = jax.value_and_grad(loss, argnums=tuple(range(8)),
                                     has_aux=True)(
        jnp.asarray(xyz), jnp.asarray(feats),
        *[jnp.asarray(p) for p in params])
    return [np.asarray(out, np.float64)] + [np.asarray(t, np.float64)
                                            for t in g]


def _c1_worst(a, b):
    return max((float(np.abs(x - y).max() / max(np.abs(y).max(), 1e-30)),
                name) for name, x, y in zip(C1_NAMES, a, b))


@pytest.mark.parametrize("ratio", sorted(C1_TOL))
def test_the_train_routes_as_the_mean_outgrows_the_spread(monkeypatch,
                                                          ratio):
    problem = _c1_problem(ratio)
    # the conv1 outputs sit at the ratio asked for
    from adaptpoint_tpu_torch.ops.geometry import ball_query, index_points
    from adaptpoint_tpu_torch.ops.satrainbn import _rows
    s = C1_SHAPE
    t, q = torch.from_numpy(problem[0]), torch.from_numpy(problem[1])
    idx = ball_query(s["radius"], s["K"], t, index_points(t, q))
    y1 = (_rows(s["radius"], t, q, torch.from_numpy(problem[2]), idx, True,
                True).double()
          @ torch.from_numpy(problem[3][0]).double()).reshape(-1, s["mid"])
    achieved = float((y1.mean(0).abs() / y1.std(0)).median())
    assert 0.5 * ratio <= achieved <= 2.0 * ratio
    fused = _c1_port(True, problem)
    unfused = _c1_port(False, problem)
    unfused64 = _c1_port(False, problem, torch.float64)
    jax_fused = _c1_jax(problem, monkeypatch)
    tol = C1_TOL[ratio]
    for pair, (a, b) in {"fused_jax": (fused, jax_fused),
                         "unfused_fused": (unfused, fused),
                         "unfused_jax": (unfused, jax_fused),
                         "unfused_f64": (unfused, unfused64)}.items():
        worst = _c1_worst(a, b)
        assert worst[0] <= tol[pair if pair in tol else "unfused_fused"], \
            (pair, worst)


# ---- ROADMAP C.8: the spread at S3DIS stage 1 -----------------------------
def _stage1_spread(batch, seed=3):
    """Median, min and max over channels of |mean| / std of PointNeXt-S's
    S3DIS stage-1 conv1 outputs (the conv before BN1, over every row the
    stage's ball group gives) on ``batch``, seeded weights."""
    from adaptpoint_tpu_torch.models import build_model_from_cfg
    model = build_model_from_cfg(_s3dis_s_cfg().model, device="cpu",
                                 seed=seed).train()
    cb = model.encoder.encoder[1][0].convs[0]
    got = []
    hook = cb.register_forward_pre_hook(lambda m, i: got.append(
        i[0].detach().double() @ cb.weight_matrix().detach().double().T))
    with torch.no_grad():
        model(batch["pos"], batch["x"])
    hook.remove()
    y = got[0].reshape(-1, got[0].shape[-1])
    r = (y.mean(0).abs() / y.std(0)).numpy()
    return float(np.median(r)), float(r.min()), float(r.max())


def _s3dis_s_cfg():
    cfg = EasyConfig()
    cfg.load(os.path.join(REPO, "cfgs", "s3dis", "pointnext-s.yaml"),
             recursive=True)
    cfg.model.in_channels = cfg.model.encoder_args.in_channels
    return cfg


def test_the_s3dis_stage1_conv1_spread():
    """ROADMAP C.8: on SyntheticScene crops (one-hot 0 / 255 colours) the
    stage-1 conv1 outputs sit at a median |mean| / std of about 0.5, and on
    rooms of surfaces with a spread of raw 0-255 colours
    (``surface_room``) at about 1.5, no channel past 4: the stem's BN keeps
    the stage far below the ratio of 10 past which the fused train-BN
    routes lose digits (test_the_train_routes_as_the_mean_outgrows_the_
    spread, whose 1.5 case is this stage). B = 2 crops of 4000 points under
    the cfg's train transforms."""
    from adaptpoint_tpu_torch.datasets import NumpyLoader
    from adaptpoint_tpu_torch.datasets.s3dis import SyntheticScene
    from scripts.surface_rooms import surface_room
    from adaptpoint_tpu_torch.engine.seg_main import seg_batch
    from adaptpoint_tpu_torch.transforms import build_transforms_from_cfg
    cfg = _s3dis_s_cfg()
    n, b = 4000, 2
    tr = build_transforms_from_cfg("train", cfg.datatransforms)
    syn = next(iter(NumpyLoader(SyntheticScene("train", n, size=b,
                                               transform=tr), b,
                                num_workers=0, seed=1)))
    rng = np.random.default_rng(5)
    rooms = []
    for _ in range(b):
        pos, rgb = surface_room(n, rng)
        d = tr({"pos": pos, "x": rgb, "y": np.zeros(n, np.int64)}, rng)
        d["heights"] = d["pos"][:, 2:3].astype(np.float32)
        rooms.append(d)
    surf = {k: np.stack([np.asarray(d[k]) for d in rooms])
            for k in ("pos", "x", "y", "heights")}
    med_syn, _, max_syn = _stage1_spread(seg_batch(syn, "cpu", cfg))
    med_surf, _, max_surf = _stage1_spread(seg_batch(surf, "cpu", cfg))
    assert 0.3 <= med_syn <= 0.8 and max_syn < 2.0, (med_syn, max_syn)
    assert 1.0 <= med_surf <= 2.25 and max_surf < 4.0, (med_surf, max_surf)
    assert 0.5 * 1.5 <= med_surf <= 2.0 * 1.5  # the C1_TOL case's band
