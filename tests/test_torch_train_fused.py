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
