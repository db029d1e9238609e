"""Phase A under the bf16 compute policy: the port against the JAX package, on the CPU.

The JAX package runs its ``gan_step`` under ``dtype_override("bfloat16")`` on
its accelerator by default (``adapt_trainer.py`` ``default_prec``); the port
under its own ``utils.precision.dtype_override`` on the card. Every JAX call
here runs inside the JAX package's ``dtype_override("bfloat16")``, every port
call inside the port's.

- The policy's blocks, where flax rounds: ``nn.Dense(dtype=bf16)`` (operands
  and product in bf16, the bias added in bf16 after it), a ``Dense`` without
  a dtype (f32 from a bf16 input), ``nn.BatchNorm(dtype=bf16)`` in training
  and in eval (f32 statistics and normalisation, one rounding), the
  ``ConvBlock`` and ``LinearBlock`` built from them and a spectral-normed
  ``Dense``. Where one rounding decides, the outputs are within one bf16 ulp
  (the f32 sums before it are taken in another order: the share that is bit
  for bit equal is asserted too); the ``LinearBlock``'s Dense bias, which
  the reference layout folds into the BatchNorm's mean, moves where its
  sum rounds, by at most one bf16 ulp of the pre-BN value and of the bias,
  times the BN's scale.
- The augmentor on the route the card takes (the port's ``ops.ball_group_max``,
  the JAX package's grouper kernel interpreted), and the discriminator.
- One whole ``gan_step`` of each package on the tiny configuration, with the
  port's fused routes off (as on the CPU) and on (against the JAX package's
  interpreted kernels), as ``tests/test_torch_gan_route.py`` holds the f32
  step.

The bf16 roundings make inputs that differ in their last f32 bits differ by
2^-8 of themselves wherever a rounding falls the other way, and the
straight-through gumbel-softmax at tau 0.1 turns a logit difference d into a
relative gradient difference of about d / tau, so the tolerances below are
bf16-grade and set from readings (in brackets, about twice each is held).
The seeds are chosen so that no discrete choice (hard gumbel argmax, FPS,
ball queries) flips between the packages.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from adaptpoint_tpu.loss import BCELoss as JaxBCE
from adaptpoint_tpu.models.layers import blocks as jblocks
from adaptpoint_tpu.utils.precision import dtype_override as jax_bf16
from adaptpoint_tpu_torch.adapt.discriminator import SpectralNormLinear
from adaptpoint_tpu_torch.loss import BCELoss
from adaptpoint_tpu_torch.models.layers import blocks
from adaptpoint_tpu_torch.utils.convert import DIS_MODULES
from adaptpoint_tpu_torch.utils.precision import (compute_dtype,
                                                  dtype_override)
from test_torch_adapt_models import (TOL_AUGMENTOR, _load_discriminator,
                                     check_augmentor_forward,
                                     check_augmentor_gradients, cloud,
                                     dis_pair, dropout_masks, gen_pair)
from test_torch_gan_route import _one_step, check_one_step, \
    interpreted_grouper
from test_torch_gan_step import _Setup

__all__ = ["gen_pair", "dis_pair", "interpreted_grouper"]  # fixtures used

BF16 = "bfloat16"


def _both_bf16():
    """Both packages' bf16 policy, as one context."""
    import contextlib
    stack = contextlib.ExitStack()
    stack.enter_context(jax_bf16(BF16))
    stack.enter_context(dtype_override(BF16))
    return stack


def _bf16_ulp(x):
    x = np.maximum(np.abs(np.asarray(x, np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def _within_one_ulp(got, ref, bit_equal_share):
    """``got`` (a bf16 tensor) within one bf16 ulp of ``ref`` (a bf16 JAX
    array), and at least ``bit_equal_share`` of the entries bit for bit
    equal. Returns the share."""
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    a = got.float().numpy()
    b = np.asarray(ref.astype(jnp.float32))
    ulp = _bf16_ulp(np.maximum(np.abs(a), np.abs(b)))
    assert (np.abs(a - b) <= ulp).all(), float((np.abs(a - b) / ulp).max())
    share = float((a == b).mean())
    assert share >= bit_equal_share, share
    return share


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ----------------------------------------------------------- policy blocks

def test_the_policy_is_scoped():
    assert compute_dtype() is None
    with dtype_override("bf16"):
        assert compute_dtype() == torch.bfloat16
        with dtype_override("f32"):
            assert compute_dtype() is None
        assert compute_dtype() == torch.bfloat16
    assert compute_dtype() is None
    x, w = torch.randn(4, 3), torch.randn(5, 3)
    assert blocks.dense(x, w).dtype == torch.float32


def _dense_case(rng, use_dtype):
    x = _randn(rng, 64, 24)
    w, b = _randn(rng, 24, 16, scale=0.3), _randn(rng, 16, scale=0.5)
    with jax_bf16(BF16):
        dt = jblocks.compute_dtype() if use_dtype else None
        ref = nn.Dense(16, dtype=dt).apply(
            {"params": {"kernel": w, "bias": b}},
            jnp.asarray(x, jnp.bfloat16 if not use_dtype else jnp.float32))
    return x, w, b, ref


def test_dense_rounds_as_flax_bf16_dense():
    rng = np.random.default_rng(0)
    x, w, b, ref = _dense_case(rng, use_dtype=True)
    with dtype_override(BF16):
        got = blocks.dense(torch.from_numpy(x), torch.from_numpy(w.T.copy()),
                           torch.from_numpy(b))
    # one rounding of the product, one of the bias sum: reading 1.0 equal
    _within_one_ulp(got, ref, 0.99)
    # the bias is added after the product's rounding, in bf16
    prod = torch.from_numpy(x).bfloat16().float() @ torch.from_numpy(
        w).bfloat16().float()
    assert torch.equal(got, prod.bfloat16() + torch.from_numpy(b).bfloat16())


def test_a_dense_without_dtype_computes_f32_from_bf16():
    """The SA stage's skip conv and the head's last layer (flax ``Dense``
    without a dtype): f32 from a bf16 input under the policy."""
    rng = np.random.default_rng(1)
    x, w, b, ref = _dense_case(rng, use_dtype=False)
    assert ref.dtype == jnp.float32
    cb = blocks.ConvBlock(24, 16, kind="conv1d", policy=False)
    with torch.no_grad():
        cb.conv.weight.copy_(torch.from_numpy(w.T.copy())[..., None])
        cb.conv.bias.copy_(torch.from_numpy(b))
    with dtype_override(BF16), torch.no_grad():
        got = cb(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def _bn_pair(rng, c):
    params = {"scale": (rng.random(c) + 0.5).astype(np.float32),
              "bias": _randn(rng, c, scale=0.1)}
    stats = {"mean": _randn(rng, c, scale=0.1),
             "var": (rng.random(c) + 0.5).astype(np.float32)}
    bn = blocks.BatchNorm(c, eps=1e-5, momentum=0.1)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(params["scale"]))
        bn.bias.copy_(torch.from_numpy(params["bias"]))
        bn.running_mean.copy_(torch.from_numpy(stats["mean"]))
        bn.running_var.copy_(torch.from_numpy(stats["var"]))
    return params, stats, bn


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_batchnorm_follows_flax_bf16_batchnorm(training):
    rng = np.random.default_rng(2)
    c = 32
    x = jnp.asarray(_randn(rng, 256, c, scale=2.0) + 0.5, jnp.bfloat16)
    params, stats, bn = _bn_pair(rng, c)
    with jax_bf16(BF16):
        mod = nn.BatchNorm(use_running_average=not training, momentum=0.9,
                           epsilon=1e-5, dtype=jblocks.compute_dtype())
        ref, upd = mod.apply({"params": params, "batch_stats": stats}, x,
                             mutable=["batch_stats"])
    bn.train(training)
    with dtype_override(BF16), torch.no_grad():
        got = bn(torch.from_numpy(np.array(x.astype(jnp.float32)))
                 .bfloat16())
    # one rounding of an f32 normalisation: reading 1.0 equal in training
    # and in eval
    _within_one_ulp(got, ref, 0.99)
    new = upd["batch_stats"]
    np.testing.assert_allclose(bn.running_mean.numpy(), new["mean"],
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(), new["var"],
                               rtol=1e-5, atol=1e-7)
    assert int(bn.num_batches_tracked) == int(training)


def _load_conv_block(cb, w, params, stats):
    with torch.no_grad():
        cb.conv.weight.copy_(torch.from_numpy(w.T.copy()).reshape(
            cb.conv.weight.shape))
    bn = cb.bn
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(params["scale"]))
        bn.bias.copy_(torch.from_numpy(params["bias"]))
        bn.running_mean.copy_(torch.from_numpy(stats["mean"]))
        bn.running_var.copy_(torch.from_numpy(stats["var"]))


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_conv_block_follows_the_policy(training):
    """Dense (no bias) + BatchNorm + relu over a grouped (B, K, M, C) input,
    as an SA stage applies it."""
    rng = np.random.default_rng(3)
    x = _randn(rng, 4, 8, 16, 19)
    w = _randn(rng, 19, 32, scale=0.4)
    params, stats, _ = _bn_pair(rng, 32)
    norm, act = {"norm": "bn"}, {"act": "relu"}
    with jax_bf16(BF16):
        ref, upd = jblocks.ConvBlock(32, norm_args=norm, act_args=act).apply(
            {"params": {"Dense_0": {"kernel": w},
                        "NormAct_0": {"BatchNorm_0": params}},
             "batch_stats": {"NormAct_0": {"BatchNorm_0": stats}}},
            jnp.asarray(x), training, mutable=["batch_stats"])
    cb = blocks.ConvBlock(19, 32, norm_args=norm, act_args=act,
                          kind="conv2d").train(training)
    _load_conv_block(cb, w, params, stats)
    with dtype_override(BF16), torch.no_grad():
        got = cb(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    # a product that rounds the other way moves the normalised value by
    # one ulp of the product times the BN's scale: reading 0.99994 equal in
    # training, 1.0 in eval
    x2 = x.reshape(-1, 19).astype(np.float64)
    pre = np.abs(x2) @ np.abs(w)
    var = (x2 @ w).var(0) if training else stats["var"]
    s = params["scale"] / np.sqrt(var + 1e-5)
    a = got.float().numpy().reshape(-1, 32)
    b = np.asarray(ref.astype(jnp.float32)).reshape(-1, 32)
    tol = _bf16_ulp(np.maximum(np.abs(a), np.abs(b))) \
        + 2.0 ** -8 * pre * np.abs(s)
    assert (np.abs(a - b) <= tol).all()
    assert float((a == b).mean()) >= 0.98
    if training:
        new = upd["batch_stats"]["NormAct_0"]["BatchNorm_0"]
        np.testing.assert_allclose(cb.bn.running_mean.numpy(), new["mean"],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(cb.bn.running_var.numpy(), new["var"],
                                   rtol=1e-4, atol=1e-5)


def test_linear_block_follows_the_policy():
    """The head's eval-mode LinearBlock (Dense with a bias + BatchNorm +
    relu) against the port's ``ConvBlock(kind="linear")`` carrying the bias
    folded into the BatchNorm's mean, as ``utils.convert`` loads it."""
    rng = np.random.default_rng(4)
    x = _randn(rng, 32, 64)
    w, b = _randn(rng, 64, 48, scale=0.2), _randn(rng, 48, scale=0.5)
    params, stats, _ = _bn_pair(rng, 48)
    norm, act = {"norm": "bn1d"}, {"act": "relu"}
    with jax_bf16(BF16):
        ref = jblocks.LinearBlock(48, norm_args=norm, act_args=act).apply(
            {"params": {"Dense_0": {"kernel": w, "bias": b},
                        "NormAct_0": {"BatchNorm_0": params}},
             "batch_stats": {"NormAct_0": {"BatchNorm_0": stats}}},
            jnp.asarray(x), False)
    cb = blocks.ConvBlock(64, 48, norm_args=norm, act_args=act,
                          kind="linear").eval()
    _load_conv_block(cb, w, params, dict(stats, mean=stats["mean"] - b))
    with dtype_override(BF16), torch.no_grad():
        got = cb(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    a = got.float().numpy()
    ref = np.asarray(ref.astype(jnp.float32))
    pre = np.abs(x.astype(np.float64) @ w) + np.abs(b)
    s = params["scale"] / np.sqrt(stats["var"] + 1e-5)
    tol = _bf16_ulp(np.maximum(np.abs(a), np.abs(ref))) \
        + 2.0 ** -8 * pre * s
    assert (np.abs(a - ref) <= tol).all()
    assert float((a == ref).mean()) >= 0.75  # reading 0.82


def test_spectral_norm_dense_follows_flax_bf16():
    """The normalised weight in f32, rounded to bf16 with the input; the
    power iteration and sigma stay f32."""
    rng = np.random.default_rng(5)
    x = _randn(rng, 4, 64, 3)
    w, b = _randn(rng, 3, 64, scale=0.5), _randn(rng, 64, scale=0.1)
    u = _randn(rng, 1, 64)
    u = u / np.linalg.norm(u)

    class SN(nn.Module):
        @nn.compact
        def __call__(self, x):
            return nn.SpectralNorm(nn.Dense(
                64, dtype=jblocks.compute_dtype(), name="d"))(
                x, update_stats=True)

    with jax_bf16(BF16):
        ref, upd = SN().apply(
            {"params": {"d": {"kernel": w, "bias": b}},
             "batch_stats": {"SpectralNorm_0": {
                 "d/kernel/u": u, "d/kernel/sigma": np.float32(1.0)}}},
            jnp.asarray(x), mutable=["batch_stats"])
    layer = SpectralNormLinear(3, 64, conv2d=True)
    with torch.no_grad():
        layer.weight_original.copy_(torch.from_numpy(w.T.copy())[..., None,
                                                                   None])
        layer.bias.copy_(torch.from_numpy(b))
        layer.state._u.copy_(torch.from_numpy(u[0]))
    with dtype_override(BF16), torch.no_grad():
        got = layer(torch.from_numpy(x), update_stats=True)
    _within_one_ulp(got, ref, 0.99)  # reading 1.0
    st = upd["batch_stats"]["SpectralNorm_0"]
    np.testing.assert_allclose(layer.state._u.numpy(), st["d/kernel/u"][0],
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(layer.state._sigma),
                               float(st["d/kernel/sigma"]), rtol=1e-5)


# ---------------------------------------------------- augmentor, discriminator

# the augmentor on the kernel route under bf16, readings in brackets: R/S/T
# logits 3e-2 * (1 + |ref|) (1.6e-2); clouds 1e-3 (4.8e-4); BN statistics
# (rtol, atol) (1e-4, 1e-4) (4.9e-5 * (1 + |ref|)) and, behind an attention,
# 1e-3 * (1 + |ref|) (2.6e-4); loss (rtol, atol) (5e-3, 1e-2) (1.4e-3
# absolute); each parameter gradient 0.2 in relative 2-norm (8.4e-2), its
# scale floored at 1e-2 of the whole gradient's (a beta or bias that the
# next BatchNorm removes has a gradient of bf16 noise, 0.57 of its own size
# under the f32 tests' floor of 1e-3), and the whole gradient 0.15 (7.2e-2)
TOL_AUGMENTOR_BF16 = dict(TOL_AUGMENTOR, prob=3e-2, gen=1e-3,
                          bn=(1e-4, 1e-4), bn_bf16=1e-3, loss=(5e-3, 1e-2),
                          grad_l2=0.2, grad_floor=1e-2)


@pytest.mark.usefixtures("interpreted_grouper")
def test_augmentor_under_bf16_matches_jax(gen_pair):
    with _both_bf16():
        fwd = check_augmentor_forward(gen_pair, TOL_AUGMENTOR_BF16, seed=17,
                                      key=117)
        grads = check_augmentor_gradients(gen_pair, TOL_AUGMENTOR_BF16,
                                          seed=17, wseed=18, key=117)
    print("augmentor under bf16:", fwd, grads)
    assert grads["whole"] <= 0.15, grads


def test_discriminator_under_bf16_matches_jax(dis_pair):
    """D's probabilities (eval, and training with dropout) and the gradients
    of BCE(D(x), 0.9) in its weights and the input cloud."""
    jdis, variables, port = dis_pair
    _load_discriminator(port, variables)
    x = cloud(27)
    key = jax.random.PRNGKey(28)
    masks = dropout_masks(jdis, variables, x.shape, key)  # f32 probe

    def loss_fn(params, pts):
        prob, _ = jdis.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, pts,
            training=True, rngs={"dropout": key}, mutable=["batch_stats"])
        return JaxBCE()(prob, jnp.full_like(prob, 0.9)), prob

    with jax_bf16(BF16):
        ref_eval = jdis.apply(variables, jnp.asarray(x), training=False)
        (ref_loss, ref_prob), (g_params, g_x) = jax.value_and_grad(
            loss_fn, argnums=(0, 1), has_aux=True)(variables["params"],
                                                   jnp.asarray(x))
    assert ref_eval.dtype == jnp.float32
    with dtype_override(BF16):
        port.eval()
        with torch.no_grad():
            got_eval = port(torch.from_numpy(x))
        port.train()
        port.zero_grad()
        pts = torch.from_numpy(x).requires_grad_()
        prob = port(pts, dropout_mask=masks)
        loss = BCELoss()(prob, torch.full_like(prob, 0.9))
    loss.backward()
    assert got_eval.dtype == prob.dtype == torch.float32
    # the probabilities and the loss: readings 0 (eval), 6e-8 (training), 0
    np.testing.assert_allclose(got_eval.numpy(), np.asarray(ref_eval),
                               atol=1e-6)
    np.testing.assert_allclose(prob.detach().numpy(), np.asarray(ref_prob),
                               atol=1e-6)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-6)
    # the gradients in relative 2-norm, the input cloud's and each layer's
    # weight and bias: reading 6.7e-3 at worst (sa_conv1: a bf16 max-pool
    # over the points ties often, and which values tie follows the sums'
    # order), held at 1.5e-2
    worst = {"x": float(np.linalg.norm(pts.grad.numpy() - np.asarray(g_x))
                        / np.linalg.norm(np.asarray(g_x)))}
    for src, name in DIS_MODULES.items():
        layer = port.get_submodule(src)
        for got_g, want in (
                (layer.weight_original.grad.flatten(1).numpy(),
                 np.asarray(g_params[name]["kernel"]).T),
                (layer.bias.grad.numpy(),
                 np.asarray(g_params[name]["bias"]))):
            rel = float(np.linalg.norm(got_g - want)
                        / max(float(np.linalg.norm(want)), 1e-12))
            worst[name] = max(worst.get(name, 0.0), rel)
    print("discriminator under bf16, relative 2-norm errors:", worst)
    assert max(worst.values()) <= 1.5e-2, worst


# ------------------------------------------------------------- the gan_step

# the step under bf16 against the JAX bf16 step on the XLA route / the fused
# route, readings in brackets: the six metrics relative 1e-4 (2.8e-5 /
# 1.3e-5); the clouds 2e-2 (8.1e-3: the bf16 R/S/T logits rotate them by up
# to 10 degrees); BN statistics 2e-3 * (1 + |ref|) (6.6e-4); the whole
# gradient in relative 2-norm, G 0.3 (0.157 / 0.156: the mask's
# straight-through gumbel at tau 0.1, as in f32) and D 1.5e-2 (5.3e-3); each
# tensor's, its scale floored at 5e-2 of its network's whole gradient (a
# bias whose gradient is a sum that cancels, D's fc3 bias summed in bf16
# over real and fake rows, or one a BatchNorm removes, is noise: 0.85 of its
# own size), G 0.4 (0.20) and D 0.2 (0.08)
TOL_STEP_BF16 = {"gen": 2e-2, "metrics": 1e-4, "bn": 2e-3,
                 "grad_l2": {"G": 0.4, "D": 0.2},
                 "grad_l2_whole": {"G": 0.3, "D": 1.5e-2},
                 "grad_floor": 5e-2}


@pytest.fixture(scope="module")
def setup_bf16():
    setup = _Setup()
    setup.jcfg.gan_precision = setup.pcfg.gan_precision = "bf16"
    return setup


@pytest.mark.parametrize("fused", [False, True], ids=["xla_route",
                                                      "fused_route"])
def test_bf16_gan_step_matches_jax(setup_bf16, fused, monkeypatch):
    res = _one_step(setup_bf16, fused, monkeypatch, seed=41)
    print("bf16 gan_step, worst:", check_one_step(res, fused, TOL_STEP_BF16))
