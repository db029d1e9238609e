"""The port's train-mode BatchNorm against flax's when the mean dwarfs the
spread, on the CPU.

Flax's ``nn.BatchNorm`` takes the batch variance as ``max(0, E[x^2] -
E[x]^2)`` in f32. Once |mean| / std reaches 100, that difference of two
large sums keeps only a few bits: flax's own sums lie 1-3 ulps from the
exactly rounded ones, so its variance is off by up to ~0.4 % of itself at
100 and by tens of percent at 1000 (``scripts/torch_bn_variance_vs_flax.py``).
No other summation order reproduces those roundings, whichever variance
formula it evaluates; the port keeps the two-pass variance.

So the port is held to what f32 allows: at |mean| / std = 10, 100 and 1000,
under the f32 and the bf16 compute policy, its output, running statistics
and the gradients of the input, scale and bias lie no further from flax's
than twice flax's own distance from the exact function (float64) plus a
floor (1e-5 of the tensor's scale; one bf16 ulp of the output under the
bf16 policy).

And it is held to the exact function directly, which flax is not: within
4 * 2^-24 * (1 + |mean| / std) of each tensor's scale, the rounding of
``x - mean`` that any f32 evaluation makes, for what the port computes in
f32; within 2 * 2^-8 of scale for what the bf16 policy rounds to bf16 (the
output and, through its bf16 cotangent, the three gradients). Readings:
at most 0.97 and 1.09 of those units; flax's f32 output reads 2124 at
1000.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as fnn

from adaptpoint_tpu.utils.precision import dtype_override as jax_policy
from adaptpoint_tpu_torch.models.layers.blocks import BatchNorm
from adaptpoint_tpu_torch.utils.precision import dtype_override

ROWS, C, EPS = 256, 16, 1e-5


def _inputs(ratio, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((ROWS, C)) * rng.uniform(0.5, 2.0, C)
         + ratio * rng.choice([-1.0, 1.0], C)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = rng.standard_normal(C).astype(np.float32)
    r = rng.standard_normal((ROWS, C)).astype(np.float32)
    return x, scale, bias, r


def _flax(x, scale, bias, r, policy):
    dt = jnp.bfloat16 if policy == "bf16" else None
    xin = jnp.asarray(x, jnp.bfloat16) if dt else jnp.asarray(x)

    def f(xin, scale, bias):
        with jax_policy("bfloat16" if dt else None):
            bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                               epsilon=EPS, dtype=dt)
            variables = {"params": {"scale": scale, "bias": bias},
                         "batch_stats": {"mean": jnp.zeros(C),
                                         "var": jnp.ones(C)}}
            y, upd = bn.apply(variables, xin, mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * r), (y, upd["batch_stats"])

    (_, (y, stats)), grads = jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True)(xin, jnp.asarray(scale),
                                            jnp.asarray(bias))
    return {"out": np.asarray(y.astype(jnp.float32)),
            "running_mean": np.asarray(stats["mean"]),
            "running_var": np.asarray(stats["var"]),
            "grad_x": np.asarray(grads[0].astype(jnp.float32)),
            "grad_scale": np.asarray(grads[1]),
            "grad_bias": np.asarray(grads[2])}


def _torch(x, scale, bias, r, policy, exact=False):
    dt = torch.float64 if exact else torch.float32
    xin = torch.tensor(x, dtype=torch.bfloat16) if policy == "bf16" \
        else torch.tensor(x)
    if exact:
        xin = xin.to(dt)
    xin.requires_grad_()
    bn = BatchNorm(C, eps=EPS, momentum=0.1).to(dt)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    if exact:
        # the function itself, in float64 (flax's formula there is exact)
        mean = xin.mean(0)
        var = (xin * xin).mean(0) - mean * mean
        y = (xin - mean) * torch.rsqrt(var + EPS) * bn.weight + bn.bias
        with torch.no_grad():
            bn.running_mean.lerp_(mean, 0.1)
            bn.running_var.lerp_(var, 0.1)
    else:
        with dtype_override("bfloat16" if policy == "bf16" else None):
            y = bn(xin)
    gx, gs, gb = torch.autograd.grad((y.to(dt) * torch.from_numpy(r)).sum(),
                                     (xin, bn.weight, bn.bias))
    return {"out": y.detach().double().numpy(),
            "running_mean": bn.running_mean.double().numpy(),
            "running_var": bn.running_var.double().numpy(),
            "grad_x": gx.double().numpy(), "grad_scale": gs.double().numpy(),
            "grad_bias": gb.double().numpy()}


@pytest.mark.parametrize("policy", ["f32", "bf16"])
@pytest.mark.parametrize("ratio", [10, 100, 1000])
def test_batchnorm_is_within_flaxs_own_f32_error(ratio, policy):
    args = _inputs(ratio)
    flax_ = _flax(*args, policy)
    port = _torch(*args, policy)
    exact = _torch(*args, policy, exact=True)
    for key, ref in flax_.items():
        ref = ref.astype(np.float64)
        own = float(np.abs(ref - exact[key]).max())
        floor = 1e-5 * float(np.abs(exact[key]).max())
        if policy == "bf16" and key == "out":
            floor += 2.0 ** -8 * float(np.abs(exact[key]).max())
        got = float(np.abs(port[key] - ref).max())
        assert got <= 2.0 * own + floor, (key, got, own, floor)


@pytest.mark.parametrize("policy", ["f32", "bf16"])
@pytest.mark.parametrize("ratio", [10, 100, 1000])
def test_batchnorm_is_within_a_few_ulps_of_the_exact_function(ratio,
                                                               policy):
    args = _inputs(ratio)
    port = _torch(*args, policy)
    exact = _torch(*args, policy, exact=True)
    for key, ref in exact.items():
        scale = float(np.abs(ref).max())
        if policy == "bf16" and not key.startswith("running"):
            tol = 2.0 * 2.0 ** -8 * scale
        else:
            tol = 4.0 * 2.0 ** -24 * (1 + ratio) * scale
        got = float(np.abs(port[key] - ref).max())
        assert got <= tol, (key, got, tol)
