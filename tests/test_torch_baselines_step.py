"""One classifier train step of DGCNN and PointNet++ against the JAX
package's, on the CPU, and the fused switches on encoders without fused
stages.

Small models (DGCNN channels 16, embed 64, 4 blocks, k 8; PointNet++ at
widths 16-128, K 8 and 16) carry the same numpy weights in both packages and
see the same batch (B = 8 clouds of 128 points resampled to 64) and
resampling columns. JAX runs its XLA route, the port its plain versions.
DGCNN's feature-space graphs are shared: the port records them
(``dgcnn.graph_tape``) and the JAX step takes them through its
``knn_point``. Tolerances, f32 sums in another order: loss rtol 1e-4 /
atol 1e-6, predictions equal, gradients by name (scaled by the clip at 10
as both steps scale them) rtol 1e-4 / atol the larger of 1e-5 and 2e-4
of the tensor's largest entry (a grouped conv's weight gradient sums
B * M * K products of both signs through a training BatchNorm: 2.3e-5
apart on entries of 0.16 in PointNet++'s first stage) and
updated parameters rtol 1e-4 / atol 1e-6 plus the first-order effect of the
gradient tolerance on Adam's update (``_adam_slack``, as
``tests/test_torch_train_step.py`` bounds it), BatchNorm buffers rtol 1e-4
/ atol 1e-6.

``ADAPTPOINT_TPU_TRAIN_FUSED=1`` and the fused eval route are PointNeXt's:
the JAX package's other encoders ignore the switches, and so do the port's
(a step and an eval forward with them on equal the ones without, bit for
bit; ``BaseCls`` hands ``fused_train_bn``, ``fused_eval`` and the shared
FPS indices to PointNeXt alone).
"""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import adaptpoint_tpu.models.backbone.dgcnn as jax_dgcnn
from adaptpoint_tpu.engine import cls_trainer as jt
from adaptpoint_tpu.models import build_model_from_cfg as jax_build
from adaptpoint_tpu.utils import EasyConfig as JaxConfig
from adaptpoint_tpu.utils.fastpath import fused_train_bn as jax_fused_train_bn
from adaptpoint_tpu_torch.engine import (TrainState, build_train_tools,
                                         make_eval_step, make_train_step)
from adaptpoint_tpu_torch.models import build_model_from_cfg
from adaptpoint_tpu_torch.models.backbone.dgcnn import graph_tape
from adaptpoint_tpu_torch.utils import EasyConfig
from adaptpoint_tpu_torch.utils.convert import state_dict_from_jax

B, N, NPOINTS, CLASSES, LR = 8, 128, 64, 5, 0.002

ENCODERS = {
    "dgcnn": {"NAME": "DGCNN", "in_channels": 4, "channels": 16,
              "embed_dim": 64, "n_blocks": 4, "k": 8,
              "norm_args": {"norm": "bn"},
              "act_args": {"act": "leakyrelu", "negative_slope": 0.2},
              "conv_args": {"order": "conv-norm-act"}},
    "pointnet2": {"NAME": "PointNet2Encoder", "in_channels": 4,
                  "mlps": [[[16, 16, 32]], [[32, 32, 64]], [[64, 64, 128]]],
                  "radius": [0.3, 0.5, None], "num_samples": [8, 16, None],
                  "strides": [4, 4, 1], "group_args": {"NAME": "ballquery"},
                  "norm_args": {"norm": "bn"}}}


def _as(cls, node):
    if isinstance(node, dict):
        return cls({k: _as(cls, v) for k, v in node.items()})
    return node


def _cfg(name):
    return {"num_points": NPOINTS, "num_classes": CLASSES,
            "criterion_args": {"NAME": "SmoothCrossEntropy",
                               "label_smoothing": 0.3},
            "lr": LR, "optimizer": {"NAME": "adamw", "weight_decay": 0.05},
            "grad_norm_clip": 10.0, "sched": "cosine", "epochs": 10,
            "warmup_epochs": 0, "min_lr": 1.0e-4, "t_max": 8,
            "model": {"NAME": "BaseCls", "encoder_args": ENCODERS[name],
                      "cls_args": {"NAME": "ClsHead", "num_classes": CLASSES,
                                   "mlps": [32, 16], "dropout": 0.0,
                                   "norm_args": {"norm": "bn1d"}}}}


def _batch(seed):
    rng = np.random.default_rng(seed)
    pos = (rng.standard_normal((B, N, 3)) * 0.4).astype(np.float32)
    x = np.concatenate([pos, np.abs(pos[..., 1:2])], -1)
    return {"x": x, "y": rng.integers(0, CLASSES, (B,)).astype(np.int32)}


def _randomize(tree, rng):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _randomize(v, rng)
            continue
        v = np.asarray(v, np.float32)
        if k in ("var", "scale"):
            v = (rng.random(v.shape) + 0.5).astype(np.float32)
        elif k in ("mean", "bias"):
            v = (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
        out[k] = v
    return out


def _pair(name, seed):
    d = _cfg(name)
    jcfg, pcfg = _as(JaxConfig, d), _as(EasyConfig, d)
    jmodel = jax_build(jcfg.model)
    b = _batch(seed)
    init = jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(b["x"][:2, :, :3]),
                       jnp.asarray(b["x"][:2]), training=False)
    rng = np.random.default_rng(seed + 1)
    variables = {c: _randomize(jax.tree_util.tree_map(np.asarray, init[c]),
                               rng) for c in ("params", "batch_stats")}
    port = build_model_from_cfg(pcfg.model, device="cpu")
    rows = [[k, list(v.shape)] for k, v in port.state_dict().items()]
    port.load_state_dict(state_dict_from_jax(variables, rows))
    return jmodel, variables, port, jcfg, pcfg, rows


def _columns(key):
    """The resampling columns the JAX step draws from ``key``."""
    rng_fps = jax.random.split(key, 3)[0]
    return np.asarray(jax.random.choice(rng_fps, NPOINTS, (NPOINTS,),
                                        replace=False)).copy()


def _jax_knn_from(graphs):
    calls = [0]

    def knn_point(k, x, q):
        idx = graphs[calls[0] % len(graphs)]
        calls[0] += 1
        return None, jnp.asarray(idx.numpy())
    return knn_point


def _adam_slack(grad, rtol, atol, eps=1e-8):
    g = np.abs(np.asarray(grad, np.float64))
    return LR * np.minimum(2.0, eps * (atol + rtol * g) / (g + eps) ** 2)


def _pin_head_bias(params, old_params):
    """The head's pre-BatchNorm Dense biases put back (the port has no such
    parameter; see ``tests/test_torch_train_step.py``)."""
    params = jax.tree_util.tree_map(lambda v: v, params)
    for blk, sub in params["prediction"].items():
        if blk.startswith("LinearBlock"):
            sub["Dense_0"]["bias"] = \
                old_params["prediction"][blk]["Dense_0"]["bias"]
    return params


def _port_step(port, pcfg, batch, cols, fused=False):
    crit, optimizer, _ = build_train_tools(pcfg, port)
    step = make_train_step(port, optimizer, crit, pcfg, fused_train_bn=fused)
    state = TrainState(port, optimizer)
    with graph_tape(port) as tape:
        state, loss, preds = step(
            state, {k: torch.from_numpy(np.array(v)) for k, v in batch.items()},
            torch.from_numpy(cols), LR)
    return loss, preds, tape.graphs


@pytest.mark.parametrize("name", ["dgcnn", "pointnet2"])
def test_one_train_step_matches_jax(name, monkeypatch):
    jmodel, variables, port, jcfg, pcfg, rows = _pair(name, 3)
    batch, key = _batch(20), jax.random.PRNGKey(5)
    loss, preds, graphs = _port_step(port, pcfg, batch, _columns(key))
    assert len(graphs) == (3 if name == "dgcnn" else 0)
    monkeypatch.setattr(jax_dgcnn, "knn_point", _jax_knn_from(graphs))

    criterion, tx, _ = jt.build_train_tools(jcfg, jmodel,
                                            variables["params"])
    state = jt.TrainState(params=variables["params"],
                          batch_stats=variables["batch_stats"],
                          opt_state=tx.init(variables["params"]),
                          step=jnp.zeros((), jnp.int32))
    jstep = jt.make_train_step(jmodel, tx, criterion, jcfg)
    new_state, ref_loss, ref_preds = jstep(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, key,
        jnp.float32(LR))
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_array_equal(preds.numpy(), np.asarray(ref_preds))

    # the gradients: JAX's of the same loss on the same resampled clouds
    rng_fps = jax.random.split(key, 3)[0]
    points = jt.resample_points(rng_fps, jnp.asarray(batch["x"]), NPOINTS)

    def loss_fn(params):
        logits, _ = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            points[..., :3], points, training=True, mutable=["batch_stats"])
        return criterion(logits, jnp.asarray(batch["y"]))

    grads = jax.jit(jax.grad(loss_fn))(variables["params"])
    zeros = jax.tree_util.tree_map(np.zeros_like, variables["batch_stats"])
    ref_grads = state_dict_from_jax(
        {"params": jax.tree_util.tree_map(np.asarray, grads),
         "batch_stats": zeros}, rows)
    # as the clip at 10 scales them
    norm = float(np.sqrt(sum(float((np.asarray(g, np.float64) ** 2).sum())
                             for g in jax.tree_util.tree_leaves(grads))))
    scale = min(1.0, 10.0 / norm)
    named = dict(port.named_parameters())
    atol = {}
    for pname, p in named.items():
        ref_grads[pname] = ref_grads[pname] * scale
        atol[pname] = max(1e-5, 2e-4 * float(ref_grads[pname].abs().max()))
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[pname].numpy(),
                                   rtol=1e-4, atol=atol[pname],
                                   err_msg=pname)

    after = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, {
        "params": _pin_head_bias(new_state.params, variables["params"]),
        "batch_stats": new_state.batch_stats}), rows)
    got = port.state_dict()
    moved = 0
    for key_, val in after.items():
        if key_.endswith("num_batches_tracked"):
            continue
        bound = 1e-6 + 1e-4 * np.abs(val.numpy())
        if key_ in named:
            bound = bound + _adam_slack(ref_grads[key_].numpy(), 1e-4,
                                        atol[key_])
        err = np.abs(got[key_].numpy() - val.numpy())
        assert (err <= bound).all(), (key_, float(err.max()))
        moved += 1
    assert moved == len(after) - sum(k.endswith("num_batches_tracked")
                                     for k in after)


@pytest.mark.parametrize("name", ["dgcnn", "pointnet2"])
def test_the_fused_switches_leave_these_encoders_alone(name):
    """The port: a step with ``fused_train_bn`` and an eval forward with
    ``fused_eval`` equal the ones without, bit for bit. JAX: the step traced
    under its fused train-BN switch is the same program as the step traced
    without it."""
    _, _, port, jcfg, pcfg, _ = _pair(name, 7)
    twin = copy.deepcopy(port)
    batch, key = _batch(21), jax.random.PRNGKey(9)
    cols = _columns(key)
    loss_a, preds_a, graphs = _port_step(port, pcfg, batch, cols)
    loss_b, preds_b, graphs_b = _port_step(twin, pcfg, batch, cols,
                                           fused=True)
    assert torch.equal(loss_a, loss_b) and torch.equal(preds_a, preds_b)
    for g, h in zip(graphs, graphs_b):
        assert torch.equal(g, h)
    for (k, a), (_, b) in zip(port.state_dict().items(),
                              twin.state_dict().items()):
        assert torch.equal(a, b), k
    eval_batch = {"x": torch.from_numpy(batch["x"])}
    plain = make_eval_step(port, pcfg)(None, eval_batch)
    fused = make_eval_step(port, pcfg, fused_eval=True)(None, eval_batch)
    assert torch.equal(plain, fused)

    jmodel, variables, _, jcfg, _, _ = _pair(name, 7)
    criterion, tx, _ = jt.build_train_tools(jcfg, jmodel,
                                            variables["params"])
    state = jt.TrainState(params=variables["params"],
                          batch_stats=variables["batch_stats"],
                          opt_state=tx.init(variables["params"]),
                          step=jnp.zeros((), jnp.int32))
    programs = []
    for on in (False, True):
        with jax_fused_train_bn(on):
            jstep = jt.make_train_step(jmodel, tx, criterion, jcfg)
            programs.append(str(jax.make_jaxpr(jstep)(
                state, {k: jnp.asarray(v) for k, v in batch.items()}, key,
                jnp.float32(LR))))
    assert programs[0] == programs[1]
