"""One and two whole phase-A ``gan_step``s of the port against the JAX package.

The tiny classifier, augmentor and discriminator of
``cfgs/synthetic/pointnext-tiny_adaptpoint.yaml`` on B = 4 clouds of N = 128
points, ``gan_precision: f32``. Both packages start from the same numpy
weights and see the same batch. JAX runs its XLA route with the controller's
default grouping route as its XLA composite (f32 values), and the port's
grouper takes the same f32 formula here (``xla_route_ball_group_max`` of
``test_torch_adapt_models``, for this module's steps); off the TPU the
frozen classifier takes the unfused f32 route for the fake and the real pass,
as the port's step does off the card (one test holds the fused passes to
the unfused ones). ``tests/test_torch_gan_route.py`` holds the step on the
route the card takes (the bf16-rounding grouper, the fused passes) against
the JAX step on its TPU kernels, interpreted.

Randomness. ``gan_step`` splits its key into ``r_wolf, r_gum, r_d1, r_d2``
(``adapt_trainer.py``). The test makes the same split and recovers every draw
with the JAX package's own functions: the augmentor's keys as flax derives
them by module path (``make_rng`` read off the module), from them the
PointWOLF dropout bits, axis codes and projection axis and the gumbel noise;
the discriminator's dropout masks off a standalone ``discriminator.apply``
with ``capture_intermediates`` (``dropout_masks``).

Tolerances:

- ``gen`` 1e-4 (points inside the unit sphere), the six metrics rtol 1e-4;
- the generator's BatchNorm buffers rtol 1e-4 / atol 1e-6 (atol 1e-4 after
  the second step: entries whose first Adam update went the other way are
  2 lr = 2e-4 apart and feed those statistics), those behind an
  attention 2e-3 * (1 + |ref|) (bf16 operands on both sides); the
  discriminator's ``u`` (same atol) and ``sigma`` rtol 1e-5;
- parameters after one step: rtol 1e-4 / atol 1e-6 plus the Adam slack.
  Adam's first update is ``lr * g / (|g| + eps)``: it forgets the gradient's
  size, so the generator's bf16-grade gradient differences (2e-2 in a
  tensor's 2-norm, see ``test_torch_adapt_models``) do not show, except where
  a gradient is as small as its own error and the entry moves by up to lr in
  either direction (``_adam_slack`` with the port's gradients and that
  gradient tolerance);
- after two steps the update is ``lr * m / (sqrt(v) + eps)`` with both
  steps' gradients in m and v, so a relative gradient difference d shows as
  d * lr: entries within 0.05 * lr (+ rtol 1e-4 / atol 1e-6), with at most
  5 % of a tensor's entries outside that (measured 2.3 % at worst, in the
  anchor attention's ``to_qkv``) and none further than 4 lr (two steps of at
  most 2 lr). Tensors whose gradient is noise (a bias or beta that the next
  BatchNorm removes) random-walk by lr a step in either package and are held
  to the 4 lr only. ``gen`` of the second step 2e-4.

The seeds are chosen so that no discrete choice (hard gumbel argmax, FPS on
the fake cloud, ball queries, max-pool winners) flips between the packages.
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaptpoint_tpu.engine import adapt_trainer as jat
from adaptpoint_tpu.engine import cls_trainer as jct
from adaptpoint_tpu.models import build_model_from_cfg as jax_build
from adaptpoint_tpu.utils import EasyConfig as JaxConfig
from adaptpoint_tpu_torch.engine import adapt_trainer
from adaptpoint_tpu_torch.engine import (GanDraws, GanState, build_gan,
                                         make_gan_step, train_gan_epoch)
from adaptpoint_tpu_torch.models import build_model_from_cfg
from adaptpoint_tpu_torch.utils import EasyConfig
from adaptpoint_tpu_torch.utils.convert import (
    discriminator_state_dict_from_jax, discriminator_stats_to_jax,
    generator_state_dict_from_jax, state_dict_from_jax)
from adaptpoint_tpu_torch import ops as pops
from test_torch_adapt_models import (LAYOUT, TOL_BF16, _dis_layout,
                                     augmentor_draws, dropout_masks,
                                     xla_route_ball_group_max, randomize)

B, N, CLASSES = 4, 128, 5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "cfgs", "synthetic",
                   "pointnext-tiny_adaptpoint.yaml")
LR_G, LR_D, ADAM_EPS = 1e-4, 4e-4, 1e-8
HARDRATIO = 2.5


def _batch(seed):
    rng = np.random.default_rng(seed)
    pos = rng.standard_normal((B, N, 3)).astype(np.float32) \
        * np.array([1.0, 0.7, 0.4], np.float32)
    pos = pos / np.linalg.norm(pos, axis=-1).max(axis=1)[:, None, None] * 0.95
    height = pos[..., 1:2] - pos[..., 1:2].min(1, keepdims=True)
    x = np.concatenate([pos, height], -1).astype(np.float32)
    return {"x": x, "y": rng.integers(0, CLASSES, (B,)).astype(np.int32)}


def _adam_slack(grad, lr, rtol, atol):
    """How far an Adam update ``lr * g / (|g| + eps)`` can move when ``g`` is
    only known to ``delta = atol + rtol * |g|``: ``2 lr`` where the gradient
    is smaller than ``delta`` (its sign is then open), first order in
    ``delta`` elsewhere."""
    g = np.abs(np.asarray(grad, np.float64))
    delta = atol + rtol * g
    first_order = np.minimum(2.0, ADAM_EPS * delta / (g + ADAM_EPS) ** 2)
    return lr * np.where(g <= delta, 2.0, first_order)


class _Setup:
    """Both packages' models with the same weights, and both steps."""

    def __init__(self):
        self.jcfg, self.pcfg = JaxConfig(), EasyConfig()
        self.jcfg.load(CFG, recursive=True)
        self.pcfg.load(CFG, recursive=True)
        self.jcfg.gan_precision = self.pcfg.gan_precision = "f32"
        b0 = _batch(0)
        # the frozen classifier
        self.jcls = jax_build(self.jcfg.model)
        cls_vars = self.jcls.init(jax.random.PRNGKey(0),
                                  jnp.asarray(b0["x"][..., :3]),
                                  jnp.asarray(b0["x"]), training=False)
        self.cls_vars = randomize(cls_vars, 1)
        self.cls_state = jct.TrainState(
            params=self.cls_vars["params"],
            batch_stats=self.cls_vars["batch_stats"], opt_state=(),
            step=jnp.zeros((), jnp.int32))
        self.pcls = build_model_from_cfg(self.pcfg.model, device="cpu")
        self.cls_rows = [[k, list(v.shape)]
                         for k, v in self.pcls.state_dict().items()]
        self.pcls.load_state_dict(state_dict_from_jax(self.cls_vars,
                                                      self.cls_rows))
        # generator, discriminator, optimizers, steps
        (self.jgen, self.jdis, tx_g, tx_d, jstate) = jat.build_gan(
            self.jcfg, jnp.asarray(b0["x"][..., :3]), jax.random.PRNGKey(2))
        self.tx = (tx_g, tx_d)
        g_vars = randomize({"params": jstate.g_params,
                            "batch_stats": jstate.g_bs}, 3)
        self.jstate0 = jstate.replace(
            g_params=g_vars["params"], g_bs=g_vars["batch_stats"],
            d_params=jax.tree_util.tree_map(np.asarray, jstate.d_params),
            d_bs=jax.tree_util.tree_map(np.asarray, jstate.d_bs))
        self.jstep = jat.make_gan_step(self.jgen, self.jdis, tx_g, tx_d,
                                       self.jcls, self.jcfg)
        self.dis_layout = _dis_layout()

    def port(self):
        """A fresh port GAN carrying ``jstate0``'s weights, and its step."""
        gen, dis, g_opt, d_opt, state = build_gan(self.pcfg, device="cpu")
        gen.load_state_dict(generator_state_dict_from_jax(
            {"params": self.jstate0.g_params,
             "batch_stats": self.jstate0.g_bs}, LAYOUT["generator"]))
        dis.load_state_dict(discriminator_state_dict_from_jax(
            {"params": self.jstate0.d_params,
             "batch_stats": self.jstate0.d_bs}, self.dis_layout))
        step = make_gan_step(gen, dis, g_opt, d_opt, self.pcls, self.pcfg)
        return state, step

    def draws(self, jstate, key):
        """Every draw the JAX ``gan_step`` makes from ``key``."""
        r_wolf, r_gum, r_d1, r_d2 = jax.random.split(key, 4)
        g_vars = {"params": jstate.g_params, "batch_stats": jstate.g_bs}
        d_vars = {"params": jstate.d_params, "batch_stats": jstate.d_bs}
        wolf, gumbel = augmentor_draws(self.jgen, g_vars, r_wolf, r_gum)
        return GanDraws(wolf, gumbel,
                        dropout_masks(self.jdis, d_vars, (B, N, 3), r_d1),
                        dropout_masks(self.jdis, d_vars, (2 * B, N, 3), r_d2))


@pytest.fixture(scope="module")
def setup():
    """Both packages' models and steps, the port's grouper on the JAX XLA
    route's formula for the whole module (restored after it)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(pops, "ball_group_max", xla_route_ball_group_max)
    yield _Setup()
    mp.undo()


@pytest.fixture(scope="module")
def two_steps(setup):
    """Both packages' first and second step, run once for the module."""
    pstate, pstep = setup.port()
    cls_before = {k: v.clone() for k, v in setup.pcls.state_dict().items()}
    jstate, out = setup.jstate0, []
    for i in range(2):
        batch, key = _batch(10 + i), jax.random.PRNGKey(20 + i)
        draws = setup.draws(jstate, key)
        jstate, ref_gen, ref_metrics = setup.jstep(
            jstate, setup.cls_state,
            {k: jnp.asarray(v) for k, v in batch.items()}, key,
            jnp.float32(HARDRATIO))
        tbatch = {"x": torch.from_numpy(batch["x"]),
                  "y": torch.from_numpy(batch["y"]).long()}
        pstate, gen, metrics = pstep(pstate, tbatch, draws, HARDRATIO)
        grads = {"g": {n: p.grad.clone() for n, p in
                       pstate.generator.named_parameters()},
                 "d": {n: p.grad.clone() for n, p in
                       pstate.discriminator.named_parameters()}}
        out.append(dict(
            jstate=jax.tree_util.tree_map(np.asarray, jstate),
            ref_gen=np.asarray(ref_gen),
            ref_metrics={k: float(v) for k, v in ref_metrics.items()},
            gen=gen.clone(), metrics={k: float(v) for k, v in metrics.items()},
            g_sd={k: v.clone() for k, v in
                  pstate.generator.state_dict().items()},
            d_sd={k: v.clone() for k, v in
                  pstate.discriminator.state_dict().items()},
            d_stats=discriminator_stats_to_jax(pstate.discriminator),
            grads=grads, step=pstate.step))
    return out, cls_before, pstate


def _check_metrics_and_gen(res, gen_tol):
    assert set(res["metrics"]) == {"g_loss", "g_loss_raw", "d_loss",
                                   "feedback", "loss_fake", "loss_real"}
    for k, ref in res["ref_metrics"].items():
        np.testing.assert_allclose(res["metrics"][k], ref, rtol=1e-4,
                                   err_msg=k)
    err = np.abs(res["gen"].numpy() - res["ref_gen"])
    assert err.max() <= gen_tol, float(err.max())
    dropped = (res["gen"].numpy() == 0).all(-1)
    np.testing.assert_array_equal(dropped, (res["ref_gen"] == 0).all(-1))
    assert 0.0 < dropped.mean() < 1.0


def _check_buffers(res, atol=1e-6):
    j = res["jstate"]
    want = generator_state_dict_from_jax(
        {"params": j.g_params, "batch_stats": j.g_bs}, LAYOUT["generator"])
    n = 0
    for key, val in want.items():
        if not key.endswith(("running_mean", "running_var")):
            continue
        got, val = res["g_sd"][key].numpy(), val.numpy()
        if "selfattention.res" in key or "masking" in key \
                or "prob_head" in key:  # behind a bf16 attention
            assert (np.abs(got - val) <= TOL_BF16 * (1 + np.abs(val))).all(), \
                key
        else:
            np.testing.assert_allclose(got, val, rtol=1e-4, atol=atol,
                                       err_msg=key)
        n += 1
    assert n == 36
    flat = {k: v for sub in j.d_bs.values() for k, v in sub.items()}
    for name, st in res["d_stats"].items():
        np.testing.assert_allclose(st["u"], flat[f"{name}/kernel/u"],
                                   rtol=1e-5, atol=atol, err_msg=name)
        np.testing.assert_allclose(st["sigma"], flat[f"{name}/kernel/sigma"],
                                   rtol=1e-5, err_msg=name)


def _param_pairs(res, setup):
    """(name, port value, JAX value, port gradient, lr) of every G and D
    parameter."""
    j = res["jstate"]
    want_g = generator_state_dict_from_jax(
        {"params": j.g_params, "batch_stats": j.g_bs}, LAYOUT["generator"])
    want_d = discriminator_state_dict_from_jax(
        {"params": j.d_params, "batch_stats": j.d_bs}, setup.dis_layout)
    for name, g in res["grads"]["g"].items():
        yield ("G." + name, res["g_sd"][name].numpy(), want_g[name].numpy(),
               g.numpy(), LR_G)
    for name, g in res["grads"]["d"].items():
        yield ("D." + name, res["d_sd"][name].numpy(), want_d[name].numpy(),
               g.numpy(), LR_D)


def test_first_gan_step_matches_jax(two_steps, setup):
    (first, _), cls_before, _ = two_steps
    assert first["step"] == 1 and int(first["jstate"].step) == 1
    _check_metrics_and_gen(first, 1e-4)
    _check_buffers(first)
    start_g = generator_state_dict_from_jax(
        {"params": setup.jstate0.g_params, "batch_stats": setup.jstate0.g_bs},
        LAYOUT["generator"])
    n, small_slack = 0, []
    rms_all = {net: float(np.sqrt(np.mean(np.concatenate(
        [g.numpy().ravel() for g in first["grads"][net].values()]) ** 2)))
        for net in "gd"}
    for name, got, want, grad, lr in _param_pairs(first, setup):
        # a tensor whose gradient is off by rtol_g in its 2-norm has entries
        # off by about rtol_g times its root mean square (three of those);
        # a gradient that cancels to nothing (a bias or beta the next
        # BatchNorm removes) is all noise, of a size the other tensors set:
        # floor the scale at the whole network's root mean square
        rtol_g = 2e-2 if name.startswith("G.") else 1e-3
        atol_g = 3 * rtol_g * max(float(np.sqrt(np.mean(grad ** 2))),
                                  rms_all[name[0].lower()])
        slack = _adam_slack(grad, lr, rtol_g, atol_g)
        small_slack.append((name[0], float((slack < 1e-7).mean())))
        err = np.abs(got - want)
        bound = 1e-6 + 1e-4 * np.abs(want) + slack
        assert (err <= bound).all(), (name, float(err.max()),
                                      float((err - bound).max()))
        if name.startswith("G."):
            assert not np.array_equal(got, start_g[name[2:]].numpy()), name
        n += 1
    assert n == 68 + 14
    # the slack is nothing for most entries of most tensors
    free = {net: np.mean([v for n_, v in small_slack if n_ == net])
            for net in "GD"}
    print("share of entries without Adam slack:", free)
    assert free["G"] > 0.5 and free["D"] > 0.5, free
    # the classifier is frozen: parameters and buffers bit-unchanged
    for k, v in setup.pcls.state_dict().items():
        assert torch.equal(v, cls_before[k]), k
    assert all(p.grad is None for p in setup.pcls.parameters())
    assert all(p.requires_grad for p in setup.pcls.parameters())


def test_second_gan_step_from_the_first_state_matches_jax(two_steps, setup):
    (_, second), _, pstate = two_steps
    assert second["step"] == 2 and pstate.step == 2
    _check_metrics_and_gen(second, 2e-4)
    _check_buffers(second, atol=1e-4)
    rms_all = {net: float(np.sqrt(np.mean(np.concatenate(
        [g.numpy().ravel() for g in second["grads"][net].values()]) ** 2)))
        for net in "gd"}
    noise = []
    for name, got, want, grad, lr in _param_pairs(second, setup):
        err = np.abs(got - want)
        tight = 1e-6 + 1e-4 * np.abs(want) + 0.05 * lr
        assert (err <= tight + 4.04 * lr).all(), (name, float(err.max()))
        # a tensor whose gradient cancels to noise (under a hundredth of the
        # network's root mean square: a bias or beta in front of a
        # BatchNorm) random-walks by lr a step in both packages
        if np.sqrt(np.mean(grad ** 2)) < 1e-2 * rms_all[name[0].lower()]:
            noise.append(name)
            continue
        outside = float((err > tight).mean())
        assert outside <= 0.05, (name, outside, float(err.max()))
    print("tensors with a noise gradient:", noise)
    assert len(noise) <= 20 and all(
        n.endswith(("bias", "affine_beta")) for n in noise), noise
    assert int(pstate.generator.predict_prob_layer.embedding.net[1]
               .num_batches_tracked) == 2


def test_fused_real_pass_changes_only_the_feedback_within_its_tolerance(
        setup, monkeypatch):
    """On the card the step sends both classifier passes through the fused
    SA route (bf16 operands): the gradient-free real pass through the eval
    stage, the differentiated fake pass through the differentiable one. Here
    the route is forced on CPU tensors, where the fused stages' plain
    versions run: ``loss_real`` and ``loss_fake`` move within the fused
    route's tolerance (2e-2 on logits), everything the classifier does not
    feed is unchanged."""
    batch, key = _batch(10), jax.random.PRNGKey(20)
    draws = setup.draws(setup.jstate0, key)
    tbatch = {"x": torch.from_numpy(batch["x"]),
              "y": torch.from_numpy(batch["y"]).long()}
    outs = []
    assert not adapt_trainer._fused_ok(setup.pcls)
    for fused in (False, True):
        monkeypatch.setattr(adapt_trainer, "_fused_ok",
                            lambda _model, fused=fused: fused)
        pstate, pstep = setup.port()
        _, gen, metrics = pstep(pstate, tbatch, draws, HARDRATIO)
        outs.append((gen, {k: float(v) for k, v in metrics.items()}))
    (gen_a, m_a), (gen_b, m_b) = outs
    assert torch.equal(gen_a, gen_b)
    for k in ("g_loss_raw", "d_loss"):
        assert m_a[k] == m_b[k], k
    for k in ("loss_real", "loss_fake"):
        assert abs(m_a[k] - m_b[k]) <= 2e-2, k
        assert m_a[k] != m_b[k], k


def test_gan_precision_bf16_waits_for_its_slice(setup):
    gen, dis, g_opt, d_opt, _ = build_gan(setup.pcfg, device="cpu", seed=0)
    cfg = EasyConfig()
    cfg.load(CFG, recursive=True)
    cfg.gan_precision = "bf16"
    with pytest.raises(NotImplementedError, match="bf16"):
        make_gan_step(gen, dis, g_opt, d_opt, setup.pcls, cfg)
    assert [g["lr"] for g in (g_opt.param_groups[0], d_opt.param_groups[0])] \
        == [LR_G, LR_D]
    assert g_opt.param_groups[0]["betas"] == (0.5, 0.999)
    # seeded builds repeat
    gen2 = build_gan(setup.pcfg, device="cpu", seed=0)[0]
    assert all(torch.equal(a, b) for a, b in zip(gen.state_dict().values(),
                                                 gen2.state_dict().values()))


def test_train_gan_epoch_returns_the_fake_dataset(setup):
    """Draws from a generator; the epoch's fake clouds come back as a
    ``FormDatasetCls`` that phase B's train step takes."""
    pstate, pstep = setup.port()
    loader = [_batch(30), _batch(31), _batch(32)]
    pstate, fake, avg = train_gan_epoch(
        pstep, pstate, loader, torch.Generator().manual_seed(0), HARDRATIO,
        setup.pcfg)
    assert isinstance(pstate, GanState) and pstate.step == 3
    assert len(fake) == 3 * B and fake.pointcloud.shape == (3 * B, N, 3)
    assert fake.x.shape == (3 * B, N, 4) and fake.label.dtype == np.int64
    np.testing.assert_array_equal(fake.x[..., :3], fake.pointcloud)
    np.testing.assert_array_equal(fake.x[:B, :, 3], loader[0]["x"][..., 3])
    np.testing.assert_array_equal(fake.label[B:2 * B], loader[1]["y"])
    assert set(avg) == {"g_loss", "d_loss", "feedback"}
    assert all(np.isfinite(v) for v in avg.values())
    assert np.linalg.norm(fake.pointcloud, axis=-1).max() <= 1.0
    sample = fake.get(5)
    assert sample["pos"].shape == (N, 3) and sample["x"].shape == (N, 4)


def test_feedback_grad_sensitivity_script_runs_at_a_tiny_size(capsys):
    """``scripts/torch_feedback_grad_sensitivity.py`` (f32 against float64
    ``gan_step``s of the port, and the frozen classifier's input gradient
    under perturbation) on the tiny configuration: every number finite, no
    mask flip after the near-ties are removed, and the float64 step taken at
    the f32 step's fake clouds within 1e-2 of it in the whole generator
    gradient (measured 3e-4)."""
    import importlib.util
    import json
    path = os.path.join(REPO, "scripts", "torch_feedback_grad_sensitivity.py")
    spec = importlib.util.spec_from_file_location("_sensitivity", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    threads = torch.get_num_threads()
    try:
        out = mod.main(["--cfg", CFG, "--batch", str(B), "--points", str(N),
                        "--calib-points", str(N), "--threads", "1"])
    finally:
        torch.set_num_threads(threads)
        sys.modules["chip_smoke"].CLASSES = 15
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    step, cls = out["gan_step"], out["classifier"]
    assert step["mask_flips"] == 0 and step["clouds_max_abs_diff"] < 1e-4
    for key in ("own_clouds", "shared_clouds", "no_feedback"):
        assert np.isfinite(step[key]["whole"]), key
    assert step["shared_clouds"]["whole"] < 1e-2
    assert cls["f32_vs_f64"] < 1e-3
    for size in ("1e-06", "1e-05"):
        row = cls["perturbed_" + size]
        assert np.isfinite(row["grad_rel_l2"]) and row["ball_slots"] > 0
