"""The port's AdaptPoint models against the JAX package, on the CPU.

Augmentor, discriminator, PointWOLF, gumbel-softmax, the feedback loss and
both weight converters; B = 4 clouds of N = 128 points, so the augmentor's
deepest level holds 8 points and its k = 24 searches pad. JAX runs its XLA
route with the controller's default grouping route, the max-pooled ball
group, as its XLA composite (``_ball_group_max_xla``: f32 values, ties
splitting the gradient), which one test shows to equal its exact route.
These are comparisons with that XLA route: the port's grouper takes the same
f32 formula here (:func:`xla_route_ball_group_max`, set for every test of
this file), where its own ``ops.ball_group_max`` rounds the values to bf16 as
the JAX package's TPU kernel does. The accelerator route is held elsewhere:
``tests/test_torch_gan_route.py`` holds that op against the interpreted TPU
kernel bit for bit and the step on it, ``tests/test_torch_augmentor_route.py``
the augmentor on it (through :func:`check_augmentor_forward` and
:func:`check_augmentor_gradients`, at tolerances stated there). Both
packages carry the same numpy weights (``generator_state_dict_from_jax`` /
``discriminator_state_dict_from_jax``).

Randomness: the two RNGs cannot match, so every draw is recovered from the
JAX keys with the JAX package's own functions and handed to the port as
tensors; each test says how. Tolerances are f32 sum-order tolerances:

- pointwolf and discriminator forwards rtol 1e-4 / atol 1e-5;
- the augmentor's 9 R/S/T logits 2e-3 * (1 + |ref|): the anchor attention
  rounds q, k, v and P to bf16 in both packages, so inputs that differ in the
  last f32 bit flip single roundings by 2^-9, and the BatchNorm behind it
  normalises over only B * 4 = 16 rows; the clouds those logits deform
  (rotations of at most 10 degrees, points inside the unit sphere) 1e-4
  (measured 8e-6); the hard keep/drop mask exact;
- BN running statistics rtol 1e-4 / atol 1e-6, and 2e-3 * (1 + |ref|) for the
  BatchNorms behind an attention; ``u`` and ``sigma`` rtol 1e-5;
- augmentor parameter gradients: each tensor's relative 2-norm error at most
  2e-2 (measured 1e-2 at worst, 3e-3 typically). Both attentions round to
  bf16 on both sides, so logits differ by up to 1e-3 between the packages,
  and the straight-through gumbel-softmax at tau 0.1 carries its gradient
  through y (1 - y) / tau, which turns a logit difference d into a relative
  gradient difference of about d / tau. The seeds are chosen so that no hard
  gumbel choice, FPS pick or ball query flips between the packages;
- the converters bit-equal.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaptpoint_tpu import adapt as jadapt
from adaptpoint_tpu.adapt import common as jcommon
from adaptpoint_tpu.loss import BCELoss as JaxBCE
from adaptpoint_tpu.utils.torch_convert import (
    export_reference_discriminator, export_reference_generator)
from adaptpoint_tpu_torch import adapt as padapt
from adaptpoint_tpu_torch import ops as pops
from adaptpoint_tpu_torch.adapt import WolfDraws
from adaptpoint_tpu_torch.adapt.discriminator import SpectralNormLinear
from adaptpoint_tpu_torch.loss import BCELoss
from adaptpoint_tpu_torch.utils.convert import (
    discriminator_state_dict_from_jax, discriminator_stats_to_jax,
    generator_state_dict_from_jax)

B, N, ANCHORS, CLASSES = 4, 128, 4, 5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(REPO, "tests", "fixtures",
                       "ref_layout_adaptpoint_gan.json")) as _f:
    LAYOUT = json.load(_f)
WOLF = dict(sigma=0.5, r_range=10.0, s_range=3.0, t_range=0.25)
TOL_BF16 = 2e-3  # anchor-attention logits: |err| <= TOL_BF16 * (1 + |ref|)
TOL_GEN = 1e-4   # the clouds those logits deform (points of norm <= 1)
TOL_GRAD_L2 = 2e-2  # parameter gradients, each tensor's relative 2-norm


def xla_route_ball_group_max(radius, nsample, xyz, query_idx, feats):
    """The max-pooled ball group of the JAX package's XLA route
    (``_ball_group_max_xla``): f32 values, without the TPU kernel's bf16
    rounding, ties splitting the gradient as ``jnp.max``'s does (``amax`` /
    ``amin``). The comparison route of this file's augmentor tests."""
    new_xyz, fi, dpfj, _ = pops.ball_group(radius, nsample, xyz, query_idx,
                                           feats, relative=False)
    fj = dpfj[..., 3:]  # (B, K, M, C)
    return new_xyz, fi, fj.amax(dim=1), fj.amin(dim=1)


@pytest.fixture(autouse=True)
def _on_the_jax_xla_route(monkeypatch):
    monkeypatch.setattr(pops, "ball_group_max", xla_route_ball_group_max)


def cloud(seed, b=B, n=N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, 3)).astype(np.float32) \
        * np.array([1.0, 0.7, 0.4], np.float32)
    return x / np.linalg.norm(x, axis=-1).max(axis=1)[:, None, None] * 0.95


def randomize(variables, seed):
    """Non-trivial BN statistics / affines and biases; numpy leaves."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = walk(v)
                continue
            v = np.array(v, np.float32)
            if k in ("var", "scale", "affine_alpha"):
                v = (rng.random(v.shape) + 0.5).astype(np.float32)
            elif k in ("mean", "bias", "affine_beta"):
                v = (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
            out[k] = v
        return out

    return {c: walk(variables[c]) for c in ("params", "batch_stats")}


def wolf_draws_from_key(key, b=B, m=ANCHORS, values=False):
    """The draws ``pointwolf_transform(key, ...)`` makes, recomputed with the
    JAX package's own calls from the keys it splits (``common.py``:
    ``r_vals, r_rand, r_kr`` then ``r_drop, r_axis``)."""
    r_vals, r_rand, r_kr = jax.random.split(key, 3)
    r_drop, r_axis = jax.random.split(r_rand)
    drop = np.asarray(jax.random.bernoulli(r_drop, 0.5, (b, m, 3)),
                      np.float32)
    axis = np.asarray(jax.random.randint(r_axis, (b, m), 1, 8))
    proj = np.asarray(jax.random.randint(r_kr, (b, 1), 1, 8))
    # the codes give the bits random_axis draws
    np.testing.assert_array_equal(
        np.asarray(jcommon.random_axis(r_axis, b, m)),
        padapt.random_axis(torch.from_numpy(axis)).numpy())
    vals = None
    if values:
        k1, k2, k3 = jax.random.split(r_vals, 3)
        vals = tuple(torch.from_numpy(np.asarray(jax.random.uniform(
            k, (b, m, 3), minval=lo, maxval=hi)).copy()) for k, lo, hi in (
                (k1, -WOLF["r_range"], WOLF["r_range"]),
                (k2, 1.0, WOLF["s_range"]),
                (k3, -WOLF["t_range"], WOLF["t_range"])))
    return WolfDraws(torch.from_numpy(drop), torch.from_numpy(axis),
                     torch.from_numpy(proj), vals)


# ---------------------------------------------------------------- pointwolf

@pytest.mark.parametrize("with_probs", [True, False])
def test_pointwolf_transform_matches_jax(with_probs):
    """Draws recovered from the key (``wolf_draws_from_key``); without
    ``probs`` also the three uniform draws of the random variant."""
    x = cloud(0)
    anchors = x[:, :ANCHORS].copy()
    probs = np.random.default_rng(1).standard_normal(
        (B, ANCHORS, 9)).astype(np.float32) if with_probs else None
    key = jax.random.PRNGKey(7)
    ref = jcommon.pointwolf_transform(
        key, jnp.asarray(x), jnp.asarray(anchors),
        probs=None if probs is None else jnp.asarray(probs), **WOLF)
    draws = wolf_draws_from_key(key, values=not with_probs)
    got = padapt.pointwolf_transform(
        draws, torch.from_numpy(x), torch.from_numpy(anchors),
        probs=None if probs is None else torch.from_numpy(probs), **WOLF)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)
    assert np.linalg.norm(got.numpy(), axis=-1).max() <= 1.0
    assert np.abs(got.numpy() - x).max() > 1e-2  # it did deform


def test_pointwolf_draws_come_from_the_generator():
    x = torch.from_numpy(cloud(2))
    a, b = (padapt.pointwolf(torch.Generator().manual_seed(s), x)[1]
            for s in (3, 3))
    c = padapt.PointWOLF()(torch.Generator().manual_seed(4), x)[1]
    assert torch.equal(a, b) and not torch.equal(a, c)
    d = padapt.draw_wolf(torch.Generator().manual_seed(5), 64, 4, "cpu",
                         r_range=10.0, s_range=3.0, t_range=0.25,
                         with_values=True)
    assert set(d.axis_code.unique().tolist()) == set(range(1, 8))
    assert set(d.drop.unique().tolist()) == {0.0, 1.0}
    deg, scale, trl = d.values
    assert -10 <= deg.min() and deg.max() <= 10 and 1 <= scale.min() \
        and scale.max() <= 3 and -0.25 <= trl.min() and trl.max() <= 0.25
    with pytest.raises(ValueError):  # the random variant needs its values
        padapt.pointwolf_transform(
            WolfDraws(d.drop[:4], d.axis_code[:4], d.proj_code[:4]), x,
            x[:, :4], probs=None, **WOLF)


# ----------------------------------------------------------- gumbel softmax

@pytest.mark.parametrize("hard", [True, False])
def test_gumbel_softmax_forward_and_straight_through_gradient(hard):
    """The noise is ``jax.random.gumbel`` of the same key and shape."""
    logits = np.random.default_rng(3).standard_normal(
        (B, N, 2)).astype(np.float32)
    w = np.random.default_rng(4).standard_normal((B, N, 2)).astype(np.float32)
    key = jax.random.PRNGKey(9)

    def f(z):
        return jnp.sum(jadapt.gumbel_softmax(key, z, tau=0.1, hard=hard)
                       * jnp.asarray(w))

    ref = jadapt.gumbel_softmax(key, jnp.asarray(logits), tau=0.1, hard=hard)
    ref_g = jax.grad(f)(jnp.asarray(logits))
    noise = torch.from_numpy(np.asarray(jax.random.gumbel(
        key, logits.shape, jnp.float32)).copy())
    z = torch.from_numpy(logits).requires_grad_()
    got = padapt.gumbel_softmax(noise, z, tau=0.1, hard=hard)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)
    # y (1 - y) / tau cancels where the softmax saturates: entries of up to
    # |w| / tau = 30 carry f32 noise of a few 1e-6
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(ref_g), rtol=1e-4,
                               atol=1e-5)
    if hard:
        assert set(np.unique(got.detach().numpy())) <= {0.0, 1.0}
        assert np.abs(z.grad.numpy()).max() > 0  # straight through
    # from a generator: one-hot rows, reproducible
    a, b = (padapt.gumbel_softmax(torch.Generator().manual_seed(1),
                                  z.detach(), 0.1, True) for _ in range(2))
    assert torch.equal(a, b) and torch.equal(a.sum(-1), torch.ones(B, N))


# ----------------------------------------------------------------- augmentor

@pytest.fixture(scope="module")
def gen_pair():
    jgen = jadapt.build_adaptpointmodels_from_cfg(
        {"NAME": "AdaptPoint_Augmentor"})
    k = jax.random.PRNGKey(0)
    variables = jgen.init({"params": k, "wolf": k, "gumbel": k},
                          jnp.asarray(cloud(10)), training=False)
    variables = randomize(variables, 11)
    port = padapt.build_adaptpointmodels_from_cfg(
        {"NAME": "AdaptPoint_Augmentor"}, device="cpu")
    return jgen, variables, port


def augmentor_draws(jgen, variables, r_wolf, r_gum, b=B, n=N):
    """The keys flax derives by module path (``make_rng`` at the augmentor's
    top level), read off the module itself, then the draws from those keys."""
    k_wolf, k_gum = jgen.apply(
        variables, rngs={"wolf": r_wolf, "gumbel": r_gum},
        method=lambda m: (m.make_rng("wolf"), m.make_rng("gumbel")))
    gumbel = np.asarray(jax.random.gumbel(k_gum, (b, n, 2), jnp.float32))
    return (wolf_draws_from_key(k_wolf, b=b),
            torch.from_numpy(gumbel.copy()))


def _load_generator(port, variables):
    port.load_state_dict(generator_state_dict_from_jax(variables,
                                                       LAYOUT["generator"]))


# the augmentor's tolerances on the XLA route's grouper: prob, the
# anchor-attention logits, and the BN statistics behind that bf16 attention
# |err| <= bf16 * (1 + |ref|); the clouds |err| <= gen; the other BN
# statistics (rtol, atol); loss (rtol, atol); grad_l2 each parameter
# gradient's relative 2-norm error
TOL_AUGMENTOR = {"prob": TOL_BF16, "gen": TOL_GEN, "bn": (1e-4, 1e-6),
                 "bn_bf16": TOL_BF16, "loss": (1e-4, 1e-4),
                 "grad_l2": TOL_GRAD_L2}


def check_augmentor_forward(gen_pair, tol, seed=12, key=13):
    """One training-mode augmentor call of each package on the same cloud
    and draws: the R/S/T logits, the keep/drop mask (exact), the clouds and
    the BN statistics after it, within ``tol`` (``TOL_AUGMENTOR``'s keys).
    Returns the worst errors."""
    jgen, variables, port = gen_pair
    _load_generator(port, variables)
    x = cloud(seed)
    r_wolf, r_gum = jax.random.split(jax.random.PRNGKey(key))
    ((_, ref_gen), upd) = jgen.apply(
        variables, jnp.asarray(x), training=True,
        rngs={"wolf": r_wolf, "gumbel": r_gum},
        mutable=["batch_stats", "intermediates"],
        capture_intermediates=lambda m, _: m.name == "predict_prob_layer")
    ref_prob, ref_mask = upd["intermediates"]["predict_prob_layer"][
        "__call__"][0]
    wolf, gumbel = augmentor_draws(jgen, variables, r_wolf, r_gum)
    seen = {}
    hook = port.predict_prob_layer.register_forward_hook(
        lambda _m, _i, out: seen.update(prob=out[0], mask=out[1]))
    port.train()
    same, gen = port(torch.from_numpy(x), wolf, gumbel)
    hook.remove()
    assert torch.equal(same, torch.from_numpy(x))
    ref_prob = np.asarray(ref_prob)
    prob_err = np.abs(seen["prob"].detach().numpy() - ref_prob)
    worst = {"prob": float((prob_err / (1 + np.abs(ref_prob))).max())}
    assert worst["prob"] <= tol["prob"], worst
    np.testing.assert_array_equal(seen["mask"].detach().numpy(),
                                  np.asarray(ref_mask))
    worst["gen"] = float(np.abs(gen.detach().numpy()
                                - np.asarray(ref_gen)).max())
    assert worst["gen"] <= tol["gen"], worst
    # masked rows are exactly zero, and the mask is neither empty nor full
    dropped = (gen.detach().numpy() == 0).all(-1)
    np.testing.assert_array_equal(dropped, np.asarray(ref_mask)[..., 0] == 0)
    assert 0.05 < dropped.mean() < 0.95
    # BN statistics after this one training call
    after = {"params": variables["params"],
             "batch_stats": jax.tree_util.tree_map(np.asarray,
                                                   upd["batch_stats"])}
    want = generator_state_dict_from_jax(after, LAYOUT["generator"])
    got = port.state_dict()
    n_stats = 0
    worst.update(bn=0.0, bn_bf16=0.0)
    for key_, val in want.items():
        if key_.endswith(("running_mean", "running_var")):
            err = np.abs(got[key_].numpy() - val.numpy())
            if "selfattention.res" in key_ or "masking" in key_ \
                    or "prob_head" in key_:  # behind a bf16 attention
                scaled = float((err / (1 + np.abs(val.numpy()))).max())
                worst["bn_bf16"] = max(worst["bn_bf16"], scaled)
                assert scaled <= tol["bn_bf16"], (key_, scaled)
            else:
                rtol, atol = tol["bn"]
                # as np.testing.assert_allclose: |err| <= atol + rtol |ref|;
                # the reading is the error in units of that bound
                scaled = float((err / (atol + rtol * np.abs(
                    val.numpy()))).max())
                worst["bn"] = max(worst["bn"], scaled)
                assert scaled <= 1.0, (key_, scaled)
            n_stats += 1
        elif key_.endswith("num_batches_tracked"):
            assert int(got[key_]) == 1
    assert n_stats == 2 * 18
    return worst


def test_augmentor_forward_and_bn_statistics_match_flax(gen_pair):
    print("augmentor forward:", check_augmentor_forward(gen_pair,
                                                        TOL_AUGMENTOR))
    # eval: nothing is stored, and a generator gives the draws
    _, _, port = gen_pair
    x = cloud(12)
    port.eval()
    before = {k: v.clone() for k, v in port.state_dict().items()}
    with torch.no_grad():
        port(torch.from_numpy(x), torch.Generator().manual_seed(0),
             torch.Generator().manual_seed(1))
    assert all(torch.equal(v, before[k])
               for k, v in port.state_dict().items())


def test_augmentor_default_route_equals_the_exact_route_in_jax(gen_pair,
                                                               monkeypatch):
    """The JAX package's default grouper (fused max/min-pooled ball group;
    its XLA composite on the CPU) gives the exact route's clouds."""
    jgen, variables, _ = gen_pair
    x = cloud(14)
    rngs = dict(zip(("wolf", "gumbel"),
                    jax.random.split(jax.random.PRNGKey(15))))
    outs = []
    for exact in ("1", "0"):
        monkeypatch.setenv("ADAPTPOINT_TPU_CONTROLLER_EXACT", exact)
        (_, gen), _ = jgen.apply(variables, jnp.asarray(x), training=True,
                                 rngs=rngs, mutable=["batch_stats"])
        outs.append(np.asarray(gen))
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-4, atol=1e-5)


def check_augmentor_gradients(gen_pair, tol, seed=16, wseed=17, key=18):
    """The gradients of a weighted sum of the clouds for the augmentor's 68
    parameter tensors, each package's, within ``tol`` (``loss``,
    ``grad_l2``). Returns the worst errors."""
    jgen, variables, port = gen_pair
    _load_generator(port, variables)
    x = cloud(seed)
    w = np.random.default_rng(wseed).standard_normal((B, N, 3)).astype(
        np.float32)
    r_wolf, r_gum = jax.random.split(jax.random.PRNGKey(key))

    def loss_fn(params):
        (_, gen), _ = jgen.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), training=True,
            rngs={"wolf": r_wolf, "gumbel": r_gum}, mutable=["batch_stats"])
        return jnp.sum(gen * jnp.asarray(w))

    ref_loss, grads = jax.value_and_grad(loss_fn)(variables["params"])
    zeros = jax.tree_util.tree_map(np.zeros_like, variables["batch_stats"])
    ref = generator_state_dict_from_jax(
        {"params": jax.tree_util.tree_map(np.asarray, grads),
         "batch_stats": zeros}, LAYOUT["generator"])
    wolf, gumbel = augmentor_draws(jgen, variables, r_wolf, r_gum)
    port.train()
    port.zero_grad()
    loss = (port(torch.from_numpy(x), wolf, gumbel)[1]
            * torch.from_numpy(w)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss),
                               rtol=tol["loss"][0], atol=tol["loss"][1])
    named = dict(port.named_parameters())
    assert len(named) == 68  # the layout's 122 rows less 3 x 18 BN buffers
    total = float(np.sqrt(sum(float((v.numpy() ** 2).sum())
                              for k, v in ref.items() if k in named)))
    worst = ("", 0.0)
    for name, p in named.items():
        want = ref[name].numpy()
        assert p.grad is not None, name
        # a gradient that cancels to nothing (a bias or beta the next
        # BatchNorm removes) has no scale of its own: floor each tensor's
        # scale at a thousandth of the whole gradient's
        rel = float(np.linalg.norm(p.grad.numpy() - want)
                    / max(float(np.linalg.norm(want)), 1e-3 * total))
        worst = max(worst, (name, rel), key=lambda t: t[1])
        assert rel <= tol["grad_l2"], (name, rel)
    return {"loss": abs(loss.item() - float(ref_loss)), "grad_l2": worst}


def test_augmentor_parameter_gradients_match_jax(gen_pair):
    print("augmentor gradients: worst",
          check_augmentor_gradients(gen_pair, TOL_AUGMENTOR))


def test_augmentor_takes_a_precomputed_first_fps(gen_pair):
    """``first_fps_idx``: the anchors and the first grouper take prefixes of
    FPS indices the caller already has, with the same result."""
    from adaptpoint_tpu_torch import ops
    _, variables, port = gen_pair
    _load_generator(port, variables)
    port.eval()
    x = torch.from_numpy(cloud(19))
    fps = ops.furthest_point_sample(x, N // 2)
    gum = torch.zeros(B, N, 2)
    draws = padapt.draw_wolf(torch.Generator().manual_seed(0), B, ANCHORS,
                             "cpu")
    with torch.no_grad():
        a = port(x, draws, gum)[1]
        b = port(x, draws, gum, first_fps_idx=fps)[1]
    assert torch.equal(a, b)


# ------------------------------------------------------------- discriminator

@pytest.fixture(scope="module")
def dis_pair():
    jdis = jadapt.build_adaptpointmodels_from_cfg(
        {"NAME": "PointDiscriminator1", "num_classes": CLASSES})
    k = jax.random.PRNGKey(1)
    variables = jdis.init({"params": k, "dropout": k},
                          jnp.asarray(cloud(20)), training=False)
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    rng = np.random.default_rng(21)
    for name, sub in variables["params"].items():
        sub["bias"] = (rng.standard_normal(sub["bias"].shape) * 0.1
                       ).astype(np.float32)
    port = padapt.build_adaptpointmodels_from_cfg(
        {"NAME": "PointDiscriminator1", "num_classes": CLASSES},
        device="cpu")
    return jdis, variables, port


def _dis_layout():
    return [[k, [CLASSES if d == 15 else d for d in s]]
            for k, s in LAYOUT["discriminator"]]


def _load_discriminator(port, variables):
    port.load_state_dict(discriminator_state_dict_from_jax(variables,
                                                           _dis_layout()))


def dropout_masks(jdis, variables, shape, key):
    """D's dropout keep-masks for ``key`` and an input of ``shape``, read off
    a standalone ``discriminator.apply`` with ``capture_intermediates``: what
    left each Dropout against what entered it. The masks depend on the key
    and the shape only, so the probe runs on a copy of the weights whose two
    FC layers have a zero kernel and a bias of 1: every unit entering a
    Dropout is then 1, and a zero leaving it was dropped."""
    probe = {"params": {k: dict(v) for k, v in variables["params"].items()},
             "batch_stats": variables["batch_stats"]}
    for name in ("fc0", "fc1"):
        probe["params"][name]["bias"] = np.ones_like(
            np.asarray(variables["params"][name]["bias"]))
        probe["params"][name]["kernel"] = np.zeros_like(
            np.asarray(variables["params"][name]["kernel"]))
    _, st = jdis.apply(probe, jnp.zeros(shape, jnp.float32), training=True,
                       rngs={"dropout": key},
                       mutable=["batch_stats", "intermediates"],
                       capture_intermediates=True)
    inter = st["intermediates"]
    masks = []
    for sn, drop in (("SpectralNorm_3", "Dropout_0"),
                     ("SpectralNorm_4", "Dropout_1")):
        entered = np.asarray(inter[sn]["__call__"][0])
        left = np.asarray(inter[drop]["__call__"][0])
        assert (entered > 0).all()
        np.testing.assert_allclose(left[left != 0],
                                   (entered / 0.6)[left != 0], rtol=1e-5)
        masks.append(torch.from_numpy(left != 0))
    return masks


def _assert_power_iteration_state(port, batch_stats):
    got = discriminator_stats_to_jax(port)
    flat = {k: v for sub in batch_stats.values() for k, v in sub.items()}
    for name, st in got.items():
        np.testing.assert_allclose(st["u"], np.asarray(
            flat[f"{name}/kernel/u"]), rtol=1e-5, atol=1e-7, err_msg=name)
        np.testing.assert_allclose(st["sigma"], np.asarray(
            flat[f"{name}/kernel/sigma"]), rtol=1e-5, err_msg=name)
    assert len(got) == 7


def test_discriminator_forward_and_power_iteration_match_flax(dis_pair):
    """Eval, then two training calls: flax iterates on every call but
    stores ``u`` and ``sigma`` only when ``update_stats``."""
    jdis, variables, port = dis_pair
    _load_discriminator(port, variables)
    x = cloud(22)
    ref = jdis.apply(variables, jnp.asarray(x), training=False)
    port.eval()
    before = {k: v.clone() for k, v in port.state_dict().items()}
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-6)
    assert got.shape == (B, 1) and 0 < got.min() and got.max() < 1
    assert all(torch.equal(v, before[k])
               for k, v in port.state_dict().items())

    port.train()
    cur = variables
    for call, seed in enumerate((23, 24)):
        key = jax.random.PRNGKey(seed)
        masks = dropout_masks(jdis, cur, x.shape, key)
        ref, upd = jdis.apply(cur, jnp.asarray(x), training=True,
                              rngs={"dropout": key}, mutable=["batch_stats"])
        cur = {"params": cur["params"], "batch_stats": upd["batch_stats"]}
        got = port(torch.from_numpy(x), dropout_mask=masks)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=1e-6)
        _assert_power_iteration_state(port, cur["batch_stats"])
        assert 0.3 < float(masks[0].float().mean()) < 0.9
    # u moved off its initial value, and v is the iterate that made u
    u0 = variables["batch_stats"]["SpectralNorm_2"]["sa_conv2/kernel/u"]
    assert np.abs(discriminator_stats_to_jax(port)["sa_conv2"]["u"]
                  - u0).max() > 1e-3
    layer = port.fc1
    w = layer.weight_original.detach().flatten(1)
    v = layer.state._v
    np.testing.assert_allclose(float(v.norm()), 1.0, rtol=1e-5)
    np.testing.assert_allclose(
        torch.nn.functional.normalize(v @ w.t(), dim=0).numpy(),
        layer.state._u.numpy(), rtol=1e-4, atol=1e-6)


def test_discriminator_gradients_match_jax(dis_pair):
    """Gradients of BCE(D(x), 0.9) in the weights (through sigma) and the
    input cloud; the dropout masks as in ``dropout_masks``."""
    jdis, variables, port = dis_pair
    _load_discriminator(port, variables)
    x = cloud(25)
    key = jax.random.PRNGKey(26)
    masks = dropout_masks(jdis, variables, x.shape, key)

    def loss_fn(params, pts):
        prob, _ = jdis.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, pts,
            training=True, rngs={"dropout": key}, mutable=["batch_stats"])
        return JaxBCE()(prob, jnp.full_like(prob, 0.9))

    ref_loss, (g_params, g_x) = jax.value_and_grad(loss_fn, argnums=(0, 1))(
        variables["params"], jnp.asarray(x))
    port.train()
    port.zero_grad()
    pts = torch.from_numpy(x).requires_grad_()
    prob = port(pts, dropout_mask=masks)
    loss = BCELoss()(prob, torch.full_like(prob, 0.9))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    np.testing.assert_allclose(pts.grad.numpy(), np.asarray(g_x), rtol=1e-3,
                               atol=1e-7)
    from adaptpoint_tpu_torch.utils.convert import DIS_MODULES
    for src, name in DIS_MODULES.items():
        layer = port.get_submodule(src)
        want_w = np.asarray(g_params[name]["kernel"]).T
        got_w = layer.weight_original.grad.flatten(1).numpy()
        np.testing.assert_allclose(
            got_w, want_w, rtol=1e-3,
            atol=1e-4 * float(np.abs(want_w).max()), err_msg=name)
        np.testing.assert_allclose(
            layer.bias.grad.numpy(), np.asarray(g_params[name]["bias"]),
            rtol=1e-3, atol=1e-7, err_msg=name)


def test_spectral_norm_follows_flax_not_torch():
    """One layer against the formulas: the iteration runs in eval too (only
    the storing waits), vectors normalise with rsqrt(sum + 1e-12), sigma is
    differentiated through W with u, v held constant, the bias is left
    alone."""
    torch.manual_seed(0)
    layer = SpectralNormLinear(6, 4)
    with torch.no_grad():
        layer.bias.normal_()
    w = layer.weight_original.detach().double()
    u = layer.state._u.double()[None]
    v = u @ w
    v = v * torch.rsqrt((v * v).sum() + 1e-12)
    u1 = v @ w.t()
    u1 = u1 * torch.rsqrt((u1 * u1).sum() + 1e-12)
    sigma = (v @ w.t() @ u1.t())[0, 0]
    x = torch.randn(5, 6)
    u_before = layer.state._u.clone()
    out = layer(x, update_stats=False)
    want = x.double() @ (w / sigma).t() + layer.bias.detach().double()
    torch.testing.assert_close(out.double(), want, rtol=1e-5, atol=1e-6)
    assert torch.equal(layer.state._u, u_before)  # nothing stored
    layer(x, update_stats=True)
    torch.testing.assert_close(layer.state._u.double(), u1[0], rtol=1e-5,
                               atol=1e-7)
    torch.testing.assert_close(layer.state._sigma.double(), sigma, rtol=1e-5,
                               atol=0)
    # d(w / sigma)/dw with u, v constant: sigma's gradient is v^T u
    layer.state._u.copy_(u_before)
    layer.zero_grad()
    layer.normed_weight(False).sum().backward()
    w_req = w.clone().requires_grad_()
    (w_req / (v @ w_req.t() @ u1.t())[0, 0]).sum().backward()
    torch.testing.assert_close(layer.weight_original.grad.double(),
                               w_req.grad, rtol=1e-4, atol=1e-6)
    assert sorted(layer.state_dict()) == [
        "bias", "parametrizations.weight.0._u", "parametrizations.weight.0._v",
        "parametrizations.weight.original"]


# ---------------------------------------------------------------- converters

def test_generator_converter_is_bit_equal_to_the_reference_export(gen_pair):
    _, variables, port = gen_pair
    ref, _ = export_reference_generator(variables, LAYOUT["generator"])
    got = generator_state_dict_from_jax(variables, LAYOUT["generator"])
    assert list(got) == [k for k, _ in LAYOUT["generator"]] == list(
        port.state_dict())
    for key, shape in LAYOUT["generator"]:
        assert tuple(got[key].shape) == tuple(shape), key
        np.testing.assert_array_equal(got[key].numpy(), ref[key], err_msg=key)
    port.load_state_dict(got, strict=True)
    with pytest.raises(ValueError):  # a leaf no key consumes
        generator_state_dict_from_jax(
            {"params": dict(variables["params"], stray={"kernel": np.ones(2)}),
             "batch_stats": variables["batch_stats"]}, LAYOUT["generator"])


def test_discriminator_converter_is_bit_equal_to_the_reference_export(
        dis_pair):
    _, variables, port = dis_pair
    ref, _ = export_reference_discriminator(variables, _dis_layout())
    got = discriminator_state_dict_from_jax(variables, _dis_layout())
    assert list(got) == [k for k, _ in _dis_layout()] == list(
        port.state_dict())
    for key, shape in _dis_layout():
        assert tuple(got[key].shape) == tuple(shape), key
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)
    port.load_state_dict(got, strict=True)
    # and the way back for the power-iteration state
    back = discriminator_stats_to_jax(port)
    np.testing.assert_array_equal(
        back["fc0"]["u"],
        variables["batch_stats"]["SpectralNorm_3"]["fc0/kernel/u"])


# ------------------------------------------------------- losses and dataset

def test_feedback_loss_bce_and_hardratio_match_jax():
    rng = np.random.default_rng(27)
    for lf, lr_, h in rng.uniform(0.5, 3.0, (5, 3)).astype(np.float32):
        np.testing.assert_allclose(
            padapt.feedback_loss(torch.tensor(lf), torch.tensor(lr_),
                                 float(h)).item(),
            float(jadapt.feedback_loss(jnp.float32(lf), jnp.float32(lr_),
                                       float(h))), rtol=1e-6)
    assert padapt.update_hardratio(3.0, 1.0, 5, 20) == \
        jadapt.update_hardratio(3.0, 1.0, 5, 20)
    probs = rng.uniform(0, 1, (6, 1)).astype(np.float32)
    probs[0], probs[1] = 0.0, 1.0  # clipped to [1e-7, 1 - 1e-7]
    for target in (0.9, 0.1):
        ref, ref_g = jax.value_and_grad(
            lambda p: JaxBCE()(p, jnp.full_like(p, target)))(
                jnp.asarray(probs))
        p = torch.from_numpy(probs).requires_grad_()
        got = BCELoss()(p, torch.full_like(p, target))
        got.backward()
        np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref_g),
                                   rtol=1e-5, atol=1e-7)


def test_form_dataset_holds_the_epoch_on_the_host():
    from adaptpoint_tpu.adapt.form_dataset import FormDatasetCls as JaxForm
    rng = np.random.default_rng(28)
    clouds = [rng.standard_normal((3, 8, 3)).astype(np.float32)
              for _ in range(2)]
    labels = [rng.integers(0, 5, (3,)) for _ in range(2)]
    full = [rng.standard_normal((3, 8, 4)).astype(np.float32)
            for _ in range(2)]
    got, ref = (cls(clouds, labels, full)
                for cls in (padapt.FormDatasetCls, JaxForm))
    assert len(got) == len(ref) == 6
    for i in (0, 5):
        a, b = got.get(i), ref.get(i)
        assert set(a) == set(b) == {"pos", "y", "x"}
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError):
        padapt.FormDatasetCls(clouds, labels[:1])
