"""The phase-A step on the route the card takes, against the JAX package's TPU kernels interpreted on the CPU.

On its accelerator the JAX ``gan_step`` runs four TPU kernels that the
port's tests elsewhere hold only through the XLA composites: the augmentor's
max-pooled ball group (``ball_group_maxpool_pallas``, forward and backward)
and the frozen classifier's differentiable fused SA stage
(``sa_train_pallas``, forward and recompute backward). Here:

- the port's ``ops.ball_group_max`` (its plain version, which the CUDA kernel
  equals on the card) against ``ball_group_maxpool_pallas`` in TPU interpret
  mode (:func:`pallas_ball_group_max`): forward outputs and winning slots bit
  for bit, gradients within 1e-6 * (1 + |ref|) (the scatter's sum order);
  also through ``PointsetGrouper`` with mixed-sign ``alpha``;
- the port's ``ops.sa_train`` against ``sa_train_pallas`` interpreted
  (``ADAPTPOINT_TPU_PALLAS_INTERPRET=1``), with and without the weight
  gradients: ``new_xyz`` and ``fi`` exact, ``out`` within 2e-2 * (1 + |ref|)
  (the fused eval stage's tolerance: one bf16 rounding of h may fall the
  other way with the sum order), each gradient tensor within 1e-3 of its
  largest entry (bf16 roundings of single addends);
- one whole ``gan_step`` of each package on the tiny configuration: (a) with
  the port's fused routes off, as on the CPU by default, against the JAX
  step on its XLA route with the interpreted grouper kernel; (b) with both
  fused routes on, as on the card, against the JAX step with the interpreted
  grouper and the interpreted fused SA kernels; tolerances at ``TOL_STEP``.

The seeds are chosen so that no discrete choice (hard gumbel argmax, FPS,
ball queries, max-pool winners) flips between the packages.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.experimental.pallas import tpu as pltpu

import adaptpoint_tpu.ops as jops
from adaptpoint_tpu.adapt.augmentor import PointsetGrouper as JaxGrouper
from adaptpoint_tpu.engine import adapt_trainer as jat
from adaptpoint_tpu.ops.pallas import ballgroup as jballgroup
from adaptpoint_tpu.ops.pallas import saeval as jsaeval
from adaptpoint_tpu.ops.pallas.saeval import sa_train_pallas
from adaptpoint_tpu_torch import ops
from adaptpoint_tpu_torch.adapt.augmentor import PointsetGrouper
from adaptpoint_tpu_torch.engine import adapt_trainer
from adaptpoint_tpu_torch.ops import ballgroup_max
from adaptpoint_tpu_torch.utils.convert import (
    discriminator_state_dict_from_jax, discriminator_stats_to_jax,
    generator_state_dict_from_jax)
from test_torch_adapt_models import LAYOUT, TOL_BF16, TOL_GRAD_L2
from test_torch_gan_step import HARDRATIO, _batch, _Setup


# --------------------------------------------------- the interpreted kernels

@functools.partial(jax.custom_vjp, nondiff_argnums=(0, 1))
def _interpreted_bg_max(radius, nsample, xyz, query_idx, feats):
    return _interpreted_bg_max_fwd(radius, nsample, xyz, query_idx, feats)[0]


def _interpreted_bg_max_fwd(radius, nsample, xyz, query_idx, feats):
    with pltpu.force_tpu_interpret_mode():
        return jballgroup._bg_max_fwd(radius, nsample, xyz, query_idx, feats,
                                      1, 1)


def _interpreted_bg_max_bwd(radius, nsample, res, grads):
    with pltpu.force_tpu_interpret_mode():
        return jballgroup._bg_max_bwd(radius, nsample, 1, 1, res, grads)


_interpreted_bg_max.defvjp(_interpreted_bg_max_fwd, _interpreted_bg_max_bwd)


def pallas_ball_group_max(radius, nsample, xyz, query_idx, feats, splits=1,
                          grad_splits=1):
    """``ball_group_maxpool_pallas`` (both kernels) in TPU interpret mode,
    standing in for ``adaptpoint_tpu.ops.ball_group_max``. The interpret mode
    is taken where each kernel is traced, so the rest of a jitted step keeps
    its own dispatch (``force_tpu_interpret_mode`` around a whole step fails
    on its ``lax.platform_dependent`` branches)."""
    assert splits == grad_splits == 1
    return _interpreted_bg_max(float(radius), int(nsample), xyz,
                               query_idx.astype(jnp.int32), feats)


@pytest.fixture
def interpreted_grouper(monkeypatch):
    """The JAX augmentor's default grouping route on its TPU kernel: the
    grouper calls ``ops.ball_group_max`` when it traces."""
    monkeypatch.delenv("ADAPTPOINT_TPU_CONTROLLER_EXACT", raising=False)
    monkeypatch.setattr(jops, "ball_group_max", pallas_ball_group_max)


# ------------------------------------------------------- rows 7 and 8

def _clouds(seed, b, n, c, dropped=0.0):
    """Seeded clouds in the unit ball, ``dropped`` of their points moved to
    the origin (as the augmentor's learned dropout leaves them: identical
    rows and exact ties), point 5 of cloud 1 far outside (an empty ball for a
    center there), and features."""
    rng = np.random.default_rng(seed)
    xyz = rng.standard_normal((b, n, 3)).astype(np.float32)
    xyz /= np.linalg.norm(xyz, axis=-1).max(1)[:, None, None]
    xyz *= (rng.random((b, n)) >= dropped)[..., None]
    xyz[1, 5] = 5.0
    feats = rng.standard_normal((b, n, c)).astype(np.float32)
    return rng, xyz, feats


BG_CASES = {  # (N, M, C, K, radius, dropped share)
    "partial_and_empty_balls": (256, 64, 16, 8, 0.3, 0.0),
    "half_at_the_origin": (256, 64, 16, 24, 0.2, 0.5),
    "k_above_n": (16, 8, 16, 24, 0.8, 0.0),
}


@pytest.mark.parametrize("case", sorted(BG_CASES))
def test_ball_group_max_matches_the_interpreted_kernel(case):
    n, m, c, k, r, dropped = BG_CASES[case]
    rng, xyz, feats = _clouds(1, 2, n, c, dropped)
    q = np.stack([rng.permutation(n)[:m] for _ in range(2)]).astype(np.int32)
    q[1, 0] = 5  # the far point: an empty ball
    gs = [rng.standard_normal(s).astype(np.float32)
          for s in [(2, m, 3)] + [(2, m, c)] * 3]
    # the kernel's outputs and, among its residuals, the winning slots
    ref, res = _interpreted_bg_max_fwd(r, k, jnp.asarray(xyz), jnp.asarray(q),
                                       jnp.asarray(feats))

    def loss(x, f):
        out = pallas_ball_group_max(r, k, x, jnp.asarray(q), f)
        return sum(jnp.sum(o * g) for o, g in zip(out, gs))

    ref_gx, ref_gf = jax.grad(loss, argnums=(0, 1))(jnp.asarray(xyz),
                                                    jnp.asarray(feats))
    # the plain version's outputs and winning slots, bit for bit
    got = ballgroup_max.ball_group_max_plain(
        r, k, torch.from_numpy(xyz), torch.from_numpy(q),
        torch.from_numpy(feats))
    for name, a, b in zip(("new_xyz", "fi", "fmax", "fmin"), got[:4], ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(res[3]))
    np.testing.assert_array_equal(got[5].numpy(), np.asarray(res[4]))
    assert (got[4] != got[5]).any()
    full = (got[6][..., -1] != got[6][..., 0]).float().mean()
    assert 0.0 < full < 1.0 or case == "k_above_n"  # partial balls present
    # through the op and autograd
    xt = torch.from_numpy(xyz).requires_grad_()
    ft = torch.from_numpy(feats).requires_grad_()
    out = ops.ball_group_max(r, k, xt, torch.from_numpy(q), ft)
    for a, b in zip(out, got[:4]):
        assert torch.equal(a.detach(), b)
    gx, gf = torch.autograd.grad(
        sum((o * torch.from_numpy(g)).sum() for o, g in zip(out, gs)),
        (xt, ft))
    for name, a, b in (("xyz", gx, ref_gx), ("feats", gf, ref_gf)):
        b = np.asarray(b)
        err = np.abs(a.numpy() - b)
        assert (err <= 1e-6 * (1 + np.abs(b))).all(), (name, float(err.max()))
    assert float(np.abs(np.asarray(ref_gf)).max()) > 0


def test_pointset_grouper_matches_jax_with_negative_alpha(
        interpreted_grouper):
    """The affine picks the max where ``alpha >= 0`` and the min where it is
    negative; the gradient reaches ``alpha`` through both branches."""
    b, n, c = 2, 128, 32
    rng, xyz, pts = _clouds(2, b, n, c, 0.25)
    xyz[1, 5] = 0.0  # no empty ball: the grouper's centers come from FPS
    alpha = rng.uniform(-1.5, 1.5, (1, 1, 1, c)).astype(np.float32)
    alpha[..., :3] = [0.0, -0.5, 0.5]
    beta = rng.standard_normal((1, 1, 1, c)).astype(np.float32) * 0.1
    w = rng.standard_normal((b, n // 2, c)).astype(np.float32)
    wx = rng.standard_normal((b, n // 2, 3)).astype(np.float32)
    jg = JaxGrouper(channels=c, reduce=2, kneighbors=24, radius=0.2)
    params = {"affine_alpha": jnp.asarray(alpha),
              "affine_beta": jnp.asarray(beta)}

    def loss(params, x, p):
        nx, pooled = jg.apply({"params": params}, x, p)
        return jnp.sum(pooled * w) + jnp.sum(nx * wx), pooled

    (_, ref), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(
        params, jnp.asarray(xyz), jnp.asarray(pts))
    port = PointsetGrouper(c, 2, 24, 0.2)
    with torch.no_grad():
        port.affine_alpha.copy_(torch.from_numpy(alpha))
        port.affine_beta.copy_(torch.from_numpy(beta))
    xt = torch.from_numpy(xyz).requires_grad_()
    pt = torch.from_numpy(pts).requires_grad_()
    nx, pooled = port(xt, pt)
    np.testing.assert_array_equal(pooled.detach().numpy(), np.asarray(ref))
    ((pooled * torch.from_numpy(w)).sum()
     + (nx * torch.from_numpy(wx)).sum()).backward()
    g_params, g_x, g_p = grads
    for name, got, want in (
            ("points", pt.grad, g_p), ("xyz", xt.grad, g_x),
            ("alpha", port.affine_alpha.grad, g_params["affine_alpha"]),
            ("beta", port.affine_beta.grad, g_params["affine_beta"])):
        want = np.asarray(want)
        err = np.abs(got.numpy() - want)
        # alpha and beta sum B * M terms: 1e-5 of their scale
        tol = 1e-6 if name in ("points", "xyz") else 1e-5
        assert (err <= tol * (1 + np.abs(want))).all(), (name,
                                                         float(err.max()))
    neg = alpha[0, 0, 0] < 0
    assert neg.any() and (~neg).any()
    assert np.abs(np.asarray(g_params["affine_alpha"])[..., neg]).max() > 0


# ------------------------------------------------------- rows 5 and 6

@pytest.mark.parametrize("param_grads", [False, True])
def test_sa_train_matches_the_interpreted_kernel(param_grads, monkeypatch):
    monkeypatch.setenv("ADAPTPOINT_TPU_PALLAS_INTERPRET", "1")
    n, m, c, k, mid, cout, r = 256, 64, 16, 24, 32, 48, 0.3
    rng, xyz, feats = _clouds(3, 2, n, c, 0.5)
    q = np.stack([rng.permutation(n)[:m] for _ in range(2)]).astype(np.int32)
    q[1, 0] = 5
    w1 = (rng.standard_normal((3 + c, mid)) / np.sqrt(3 + c)).astype(
        np.float32)
    b1 = (rng.standard_normal(mid) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((mid, cout)) / np.sqrt(mid)).astype(np.float32)
    b2 = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    gs = [rng.standard_normal(s).astype(np.float32)
          for s in [(2, m, 3), (2, m, c), (2, m, cout)]]
    arrays = (xyz, feats, w1, b1, w2, b2)

    def loss(x, f, a, bb, cc, d):
        out = sa_train_pallas(r, k, x, jnp.asarray(q), f, a, bb, cc, d, True,
                              True, 1, param_grads)
        return sum(jnp.sum(o * g) for o, g in zip(out, gs)), out

    (_, ref), ref_g = jax.value_and_grad(loss, argnums=tuple(range(6)),
                                         has_aux=True)(
        *[jnp.asarray(v) for v in arrays])
    ts = [torch.from_numpy(v.copy()).requires_grad_(i < 2 or param_grads)
          for i, v in enumerate(arrays)]
    out = ops.sa_train(r, k, ts[0], torch.from_numpy(q), ts[1], *ts[2:],
                       relative=True, normalize_dp=True)
    np.testing.assert_array_equal(out[0].detach().numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(out[1].detach().numpy(), np.asarray(ref[1]))
    want = np.asarray(ref[2])
    err = np.abs(out[2].detach().numpy() - want)
    assert (err <= 2e-2 * (1 + np.abs(want))).all(), float(err.max())
    # the forward equals the fused eval stage's
    evl = ops.sa_eval(r, k, *[t.detach() for t in ts[:1]], torch.from_numpy(q),
                      ts[1].detach(), *[t.detach() for t in ts[2:]], True,
                      True)
    assert torch.equal(evl[2], out[2].detach())
    grads = torch.autograd.grad(
        sum((o * torch.from_numpy(g)).sum() for o, g in zip(out, gs)),
        [t for t in ts if t.requires_grad])
    names = ("xyz", "feats", "w1", "b1", "w2", "b2")
    assert len(grads) == (6 if param_grads else 2)
    for name, got, want in zip(names, grads, ref_g):
        want = np.asarray(want)
        scale = float(np.abs(want).max())
        assert scale > 0, name
        err = float(np.abs(got.numpy() - want).max())
        assert err <= 1e-3 * scale, (name, err, scale)


# ------------------------------------------------------- the whole step

# One gan_step on the route the card takes against the JAX step on its
# interpreted kernels. Both JAX optimizers are SGD at lr 1 here, so the JAX
# step's parameter change is its gradient, held to the port's directly: each
# tensor's relative 2-norm error (floored at a thousandth of the network's
# norm) and the whole network's. The port's step takes the JAX step's fake
# clouds forward (its gradient still reaching its own generator), as the
# float64 copy in chip_smoke.py does: the discriminator's and the frozen
# classifier's input gradients jump with their input cloud (ball
# memberships, max-pool winners), so only on a shared cloud are two
# gradients comparable; the port's own clouds are held on their own. Measured
# worst in brackets. The grouper's bf16 rounding turns f32 sum-order
# differences of a few ulps into single pooled values 2^-8 of themselves
# apart where the XLA route keeps f32: the clouds then sit 5.6e-4 apart (not
# 1e-4, test_torch_gan_step), the BatchNorm statistics 2.0e-4 * (1 + |ref|)
# (not rtol 1e-4), and the mask logits move enough that the straight-through
# gumbel-softmax (a logit difference d becomes a relative gradient
# difference of about d / tau, tau = 0.1) leaves the generator's gradient
# 6.6e-2 apart as a whole, worst tensor 9.2e-2 (2e-2 on the XLA route).
TOL_STEP = {"gen": 2e-3, "metrics": 1e-4, "bn": TOL_BF16,
            "grad_l2": {"G": 1.5e-1, "D": 1e-3},
            "grad_l2_whole": {"G": 1e-1, "D": 1e-4}}


@pytest.fixture(scope="module")
def setup():
    return _Setup()


def _one_step(setup, fused: bool, monkeypatch):
    """The first step of each package from ``setup``'s weights on one batch:
    the port with both fused routes ``fused``, the JAX step on its
    interpreted kernels (the fused SA stages too when ``fused``). Returns
    both steps' outputs and gradients, named as the port names them."""
    monkeypatch.delenv("ADAPTPOINT_TPU_CONTROLLER_EXACT", raising=False)
    monkeypatch.setattr(jops, "ball_group_max", pallas_ball_group_max)
    if fused:
        monkeypatch.delenv("ADAPTPOINT_TPU_KERNELS", raising=False)
        monkeypatch.setenv("ADAPTPOINT_TPU_PALLAS_INTERPRET", "1")
    else:
        monkeypatch.setenv("ADAPTPOINT_TPU_KERNELS", "xla")
    monkeypatch.setattr(adapt_trainer, "_fused_ok", lambda _model: fused)
    # which routes each step takes: the port's ops called, the JAX
    # package's kernels traced
    calls = {}

    def counted(module, name, tag):
        own = getattr(module, name)

        def wrapped(*args, **kwargs):
            calls[tag] = calls.get(tag, 0) + 1
            return own(*args, **kwargs)
        monkeypatch.setattr(module, name, wrapped)

    for name in ("ball_group", "ball_group_max", "sa_eval", "sa_train"):
        counted(ops, name, name)
    counted(jops, "ball_group_max", "jax_ball_group_max_kernel")
    for name in ("sa_eval_pallas", "sa_train_pallas"):
        counted(jsaeval, name, "jax_" + name)
    sgd = optax.sgd(1.0)
    js0 = setup.jstate0
    js0 = js0.replace(g_opt=sgd.init(js0.g_params),
                      d_opt=sgd.init(js0.d_params))
    jstep = jat.make_gan_step(setup.jgen, setup.jdis, sgd, sgd, setup.jcls,
                              setup.jcfg)
    batch, key = _batch(40), jax.random.PRNGKey(41)
    draws = setup.draws(js0, key)
    js1, ref_gen, ref_metrics = jstep(
        js0, setup.cls_state, {k: jnp.asarray(v) for k, v in batch.items()},
        key, jnp.float32(HARDRATIO))
    js1 = jax.tree_util.tree_map(np.asarray, js1)

    def change(before, after):
        return jax.tree_util.tree_map(
            lambda a, b: np.asarray(a, np.float32) - b, before, after)

    zeros = jax.tree_util.tree_map(np.zeros_like, js0.g_bs)
    ref_grads = {"G": generator_state_dict_from_jax(
        {"params": change(js0.g_params, js1.g_params), "batch_stats": zeros},
        LAYOUT["generator"]), "D": discriminator_state_dict_from_jax(
        {"params": change(js0.d_params, js1.d_params),
         "batch_stats": js1.d_bs}, setup.dis_layout)}
    pstate, pstep = setup.port()
    # the port's step sees the JAX step's fake clouds on the way forward
    # while its gradient still flows to its own generator: the
    # discriminator's and the frozen classifier's input gradients jump with
    # their input (ball memberships and max-pool winners), so the gradients
    # are compared on the same branch; the port's own clouds are held apart
    own = {}

    def substitute(_module, _inputs, out):
        own["gen"] = out[1].detach().clone()
        shared = torch.from_numpy(np.asarray(ref_gen).copy())
        return out[0], out[1] + (shared - out[1]).detach()

    hook = pstate.generator.register_forward_hook(substitute)
    before = ops.launch_counts()
    pstate, _, metrics = pstep(
        pstate, {"x": torch.from_numpy(batch["x"]),
                 "y": torch.from_numpy(batch["y"]).long()}, draws, HARDRATIO)
    hook.remove()
    gen = own["gen"]
    assert ops.launch_counts() == before  # CPU tensors: plain versions
    nets = {"G": pstate.generator, "D": pstate.discriminator}
    return dict(
        calls=calls,
        jstate=js1, ref_gen=np.asarray(ref_gen),
        ref_metrics={k: float(v) for k, v in ref_metrics.items()},
        gen=gen.numpy(), metrics={k: float(v) for k, v in metrics.items()},
        g_sd=pstate.generator.state_dict(),
        d_stats=discriminator_stats_to_jax(pstate.discriminator),
        grads={t: {n: p.grad.numpy() for n, p in net.named_parameters()}
               for t, net in nets.items()},
        ref_grads=ref_grads)


@pytest.mark.parametrize("fused", [False, True], ids=["xla_route",
                                                      "fused_route"])
def test_gan_step_on_the_kernel_route_matches_jax(setup, fused, monkeypatch):
    res = _one_step(setup, fused, monkeypatch)
    # per step: 4 groupers; 2 fused SA stages a classifier pass on the fused
    # route, 2 ball groups a pass on the XLA route; the JAX step traced once
    assert res["calls"] == ({"ball_group_max": 4, "sa_train": 2, "sa_eval": 2,
                             "jax_ball_group_max_kernel": 4,
                             "jax_sa_train_pallas": 2, "jax_sa_eval_pallas": 2}
                            if fused else
                            {"ball_group_max": 4, "ball_group": 4,
                             "jax_ball_group_max_kernel": 4}), res["calls"]
    worst = {}
    for k, ref in res["ref_metrics"].items():
        worst[k] = abs(res["metrics"][k] - ref) / abs(ref)
    assert max(worst.values()) <= TOL_STEP["metrics"], worst
    dropped = (res["gen"] == 0).all(-1)
    np.testing.assert_array_equal(dropped, (res["ref_gen"] == 0).all(-1))
    assert 0.0 < dropped.mean() < 1.0
    gen_err = float(np.abs(res["gen"] - res["ref_gen"]).max())
    assert gen_err <= TOL_STEP["gen"], gen_err
    # BatchNorm statistics and the power iteration
    j = res["jstate"]
    want = generator_state_dict_from_jax(
        {"params": j.g_params, "batch_stats": j.g_bs}, LAYOUT["generator"])
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 36
    worst_bn = 0.0
    for key in stats:
        got, val = res["g_sd"][key].numpy(), want[key].numpy()
        scaled = float((np.abs(got - val) / (1 + np.abs(val))).max())
        worst_bn = max(worst_bn, scaled)
        assert scaled <= TOL_STEP["bn"], (key, scaled)
    flat = {k: v for sub in j.d_bs.values() for k, v in sub.items()}
    for name, st in res["d_stats"].items():
        np.testing.assert_allclose(st["u"], flat[f"{name}/kernel/u"],
                                   rtol=1e-5, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(st["sigma"], flat[f"{name}/kernel/sigma"],
                                   rtol=1e-5, err_msg=name)
    # the gradients, tensor by tensor and whole
    worst = {"gen": gen_err, "bn": worst_bn}
    for net, count in (("G", 68), ("D", 14)):
        got, ref = res["grads"][net], res["ref_grads"][net]
        assert len(got) == count
        total = float(np.sqrt(sum(float((ref[n].numpy() ** 2).sum())
                                  for n in got)))
        diff = float(np.sqrt(sum(float(((got[n] - ref[n].numpy()) ** 2).sum())
                                 for n in got)))
        worst[net + "_whole"] = diff / total
        assert diff / total <= TOL_STEP["grad_l2_whole"][net], (net, diff)
        for name, g in got.items():
            want_g = ref[name].numpy()
            rel = float(np.linalg.norm(g - want_g)
                        / max(float(np.linalg.norm(want_g)), 1e-3 * total))
            worst[net] = max(worst.get(net, 0.0), rel)
            assert rel <= TOL_STEP["grad_l2"][net], (net, name, rel)
    print("worst", worst)
