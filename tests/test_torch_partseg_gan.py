"""The port's part-segmentation GAN step (``make_partseg_gan_step``)
against the JAX package's, on the CPU.

The augmentor and the discriminator of
``cfgs/shapenetpart/pointnext-s_adaptpoint.yaml`` on B = 4 clouds of 128
points; the JAX step's five keys split as it splits them, every draw
recovered with ``tests/test_torch_adapt_models.py``'s helpers (the PointWOLF
draws and gumbel noise, the discriminator's dropout masks of its three
passes) and handed over as a ``GanDraws``; the port's grouper on the JAX XLA
route's f32 formula, as ``tests/test_torch_gan_step.py`` runs it. Clouds
1e-4, both losses rtol 1e-4, the generator's BatchNorm statistics rtol 1e-4
/ atol 1e-6, the spectral norms' ``u`` and ``sigma`` rtol 1e-5, parameters
rtol 1e-4 / atol 1e-6 plus the Adam slack of the gradients' tolerance
(generator 2e-2 of a tensor's 2-norm, discriminator 1e-3, as there).
"""
import copy
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaptpoint_tpu.engine import adapt_trainer as jat
from adaptpoint_tpu.engine import partseg_main as jps
from adaptpoint_tpu.utils import EasyConfig as JaxConfig
from adaptpoint_tpu_torch import ops as pops
from adaptpoint_tpu_torch.engine.adapt_trainer import GanDraws, build_gan
from adaptpoint_tpu_torch.engine.partseg_main import (
    make_partseg_gan_step, partseg_batch, train_partseg_gan_epoch)
from adaptpoint_tpu_torch.utils import EasyConfig
from adaptpoint_tpu_torch.utils.convert import (
    discriminator_state_dict_from_jax, discriminator_stats_to_jax,
    generator_state_dict_from_jax)
from test_torch_adapt_models import (LAYOUT, augmentor_draws, dropout_masks,
                                     randomize, xla_route_ball_group_max)

B, PARTS, SHAPES = 4, 8, 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ADAPT_CFG = os.path.join(REPO, "cfgs", "shapenetpart",
                         "pointnext-s_adaptpoint.yaml")
ADAM_EPS = 1e-8


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tensors(batch):
    return partseg_batch(batch, torch.device("cpu"))


GAN_N = 128


@pytest.fixture(scope="module")
def gan_setup():
    mp = pytest.MonkeyPatch()
    mp.setattr(pops, "ball_group_max", xla_route_ball_group_max)
    jcfg, pcfg = JaxConfig(), EasyConfig()
    jcfg.load(ADAPT_CFG, recursive=True)
    pcfg.load(ADAPT_CFG, recursive=True)
    cloud = _gan_batch(0)["pos"]
    jgen, jdis, tx_g, tx_d, jstate = jat.build_gan(jcfg, jnp.asarray(cloud),
                                                   jax.random.PRNGKey(2))
    g_vars = randomize({"params": jstate.g_params,
                        "batch_stats": jstate.g_bs}, 3)
    jstate = jstate.replace(
        g_params=g_vars["params"], g_bs=g_vars["batch_stats"],
        d_params=jax.tree_util.tree_map(np.asarray, jstate.d_params),
        d_bs=jax.tree_util.tree_map(np.asarray, jstate.d_bs))
    dis_layout = [[k, [16 if d == 15 else d for d in s]]
                  for k, s in LAYOUT["discriminator"]]
    yield dict(jcfg=jcfg, pcfg=pcfg, jgen=jgen, jdis=jdis, jstate=jstate,
               jstep=jps.make_partseg_gan_step(jgen, jdis, tx_g, tx_d, jcfg),
               dis_layout=dis_layout)
    mp.undo()


def _gan_batch(seed):
    rng = np.random.default_rng(seed)
    pos = rng.standard_normal((B, GAN_N, 3)).astype(np.float32) \
        * np.array([1.0, 0.7, 0.4], np.float32)
    pos = pos / np.linalg.norm(pos, axis=-1).max(axis=1)[:, None, None] * 0.95
    height = pos[..., 1:2] - pos[..., 1:2].min(1, keepdims=True)
    return {"pos": pos, "x": np.concatenate([pos, height], -1),
            "y": rng.integers(0, PARTS, (B, GAN_N)).astype(np.int32),
            "cls": rng.integers(0, SHAPES, (B,)).astype(np.int32)}


def _port_gan(s):
    gen, dis, g_opt, d_opt, state = build_gan(s["pcfg"], device="cpu")
    gen.load_state_dict(generator_state_dict_from_jax(
        {"params": s["jstate"].g_params, "batch_stats": s["jstate"].g_bs},
        LAYOUT["generator"]))
    dis.load_state_dict(discriminator_state_dict_from_jax(
        {"params": s["jstate"].d_params, "batch_stats": s["jstate"].d_bs},
        s["dis_layout"]))
    return state, make_partseg_gan_step(gen, dis, g_opt, d_opt)


def test_one_gan_step_matches_jax(gan_setup):
    s = gan_setup
    batch, key = _gan_batch(10), jax.random.PRNGKey(20)
    r_wolf, r_gum, r_d1, r_d2, r_d3 = jax.random.split(key, 5)
    js = s["jstate"]
    g_vars = {"params": js.g_params, "batch_stats": js.g_bs}
    d_vars = {"params": js.d_params, "batch_stats": js.d_bs}
    wolf, gumbel = augmentor_draws(s["jgen"], g_vars, r_wolf, r_gum, b=B,
                                   n=GAN_N)
    shape = (B, GAN_N, 3)
    masks_g = dropout_masks(s["jdis"], d_vars, shape, r_d1)
    masks_d = [torch.cat([a, b]) for a, b in zip(
        dropout_masks(s["jdis"], d_vars, shape, r_d2),
        dropout_masks(s["jdis"], d_vars, shape, r_d3))]
    new, ref_gen, ref_metrics = s["jstep"](js, _jax(batch), key)

    pstate, pstep = _port_gan(s)
    pstate, gen, metrics = pstep(pstate, _tensors(batch),
                                 GanDraws(wolf, gumbel, masks_g, masks_d))
    assert pstate.step == 1 and set(metrics) == {"g_loss", "d_loss"}
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(ref_metrics[k]),
                                   rtol=1e-4, err_msg=k)
    ref_gen = np.asarray(ref_gen)
    assert np.abs(gen.numpy() - ref_gen).max() <= 1e-4
    dropped = (gen.numpy() == 0).all(-1)
    np.testing.assert_array_equal(dropped, (ref_gen == 0).all(-1))
    assert 0.0 < dropped.mean() < 1.0

    g_sd = pstate.generator.state_dict()
    want_g = generator_state_dict_from_jax(
        {"params": new.g_params, "batch_stats": new.g_bs},
        LAYOUT["generator"])
    for key_, val in want_g.items():
        if key_.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(g_sd[key_].numpy(), val.numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=key_)
    flat = {k: v for sub in new.d_bs.values() for k, v in sub.items()}
    for name, st in discriminator_stats_to_jax(pstate.discriminator).items():
        np.testing.assert_allclose(st["u"], np.asarray(
            flat[f"{name}/kernel/u"]), rtol=1e-5, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(st["sigma"], np.asarray(
            flat[f"{name}/kernel/sigma"]), rtol=1e-5, err_msg=name)

    want_d = discriminator_state_dict_from_jax(
        {"params": new.d_params, "batch_stats": new.d_bs}, s["dis_layout"])
    d_sd = pstate.discriminator.state_dict()
    lr = {"G": float(s["pcfg"].adaptpoint_params.lr_generator),
          "D": float(s["pcfg"].adaptpoint_params.lr_discriminator)}
    n = 0
    for net, module, sd, want, rtol_g in (
            ("G", pstate.generator, g_sd, want_g, 2e-2),
            ("D", pstate.discriminator, d_sd, want_d, 1e-3)):
        grads = {k: p.grad.numpy() for k, p in module.named_parameters()}
        rms_all = float(np.sqrt(np.mean(np.concatenate(
            [g.ravel() for g in grads.values()]) ** 2)))
        for name, g in grads.items():
            atol_g = 3 * rtol_g * max(float(np.sqrt(np.mean(g ** 2))),
                                      rms_all)
            gg = np.abs(np.asarray(g, np.float64))
            delta = atol_g + rtol_g * gg
            slack = lr[net] * np.where(
                gg <= delta, 2.0,
                np.minimum(2.0, ADAM_EPS * delta / (gg + ADAM_EPS) ** 2))
            err = np.abs(sd[name].numpy() - want[name].numpy())
            bound = 1e-6 + 1e-4 * np.abs(want[name].numpy()) + slack
            assert (err <= bound).all(), (net, name, float(err.max()))
            n += 1
    assert n == 68 + 14


def test_gan_step_stays_f32_and_its_epoch_forms_the_fake_dataset(gan_setup):
    """The step enters no compute policy whatever ``gan_precision`` says;
    the epoch keeps each real batch's labels, heights and categories beside
    its fake clouds."""
    s = gan_setup
    gen, dis, g_opt, d_opt, state = build_gan(s["pcfg"], device="cpu", seed=1)
    cfg = copy.deepcopy(s["pcfg"])
    cfg.gan_precision = "bf16"
    seen = []
    hook = gen.predict_prob_layer.embedding.register_forward_hook(
        lambda _m, _i, out: seen.append(out.dtype))
    step = make_partseg_gan_step(gen, dis, g_opt, d_opt)
    loader = [_gan_batch(30 + i) for i in range(3)]
    state, fake, avg = train_partseg_gan_epoch(
        step, state, loader, torch.Generator().manual_seed(0))
    hook.remove()
    assert seen == [torch.float32] * 3 and state.step == 3
    assert len(fake) == 3 * B and fake.pos.shape == (3 * B, GAN_N, 3)
    np.testing.assert_array_equal(fake.y[B:2 * B], loader[1]["y"])
    np.testing.assert_array_equal(fake.heights[:B], loader[0]["x"][..., 3:])
    np.testing.assert_array_equal(fake.cls[2 * B:], loader[2]["cls"])
    assert not np.array_equal(fake.pos[:B], loader[0]["pos"])
    assert set(avg) == {"g_loss", "d_loss"}
    assert all(np.isfinite(v) for v in avg.values())
