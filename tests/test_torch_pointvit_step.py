"""PointViT's weights and one classifier train step of the port against the
JAX package, on the CPU.

- ``state_dict_from_jax`` equals the JAX package's
  ``export_reference_state_dict`` bit for bit on the reference layout
  ``tests/fixtures/ref_layout_pointvit_cls.json`` (embed 48, depth 2) and at
  the full width of ``cfgs/scanobjectnn/pointvit.yaml`` (embed 384, depth
  12, 6 heads, 256 groups of 32, ``in_channels`` 4) from a JAX init, and
  the port's models hold exactly those layouts' keys and shapes (the
  ``in2d`` norm has no parameters on either side);
- the port's own initialisation draws JAX's distributions: xavier-uniform
  ``qkv`` / ``proj`` / ``fc1`` / ``fc2`` with zero biases, normal(0.02)
  tokens, U(+-1/sqrt(fan_in)) elsewhere, from ``init_weights_``'s generator
  too;
- one train step (B = 8 clouds of 128 points resampled to 64; embed 48,
  depth 2, 3 heads, 16 groups of 8, the cfg's SmoothCE, AdamW and clip at
  10) carries the same numpy weights and sees the same batch and
  resampling columns in both packages; JAX runs its XLA route, the port its
  plain versions. The kNN graph is not shared: both compute it from the
  same centers (FPS and the gathers are exact), index for index.
  Tolerances, f32 sums in another order: loss rtol 1e-4 / atol 1e-6,
  predictions equal, gradients by name rtol 1e-4 / atol the larger of 1e-5
  and 2e-4 of the tensor's largest entry, updated parameters rtol 1e-4 /
  atol 1e-6 plus the first-order effect of the gradient tolerance on Adam's
  update, BatchNorm buffers rtol 1e-4 / atol 1e-6 (as
  ``tests/test_torch_baselines_step.py``).
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaptpoint_tpu.engine import cls_trainer as jt
from adaptpoint_tpu.models import build_model_from_cfg as jax_build
from adaptpoint_tpu.utils import EasyConfig as JaxConfig
from adaptpoint_tpu.utils.torch_convert import export_reference_state_dict
from adaptpoint_tpu_torch.engine import (TrainState, build_train_tools,
                                         make_train_step)
from adaptpoint_tpu_torch.models import build_model_from_cfg
from adaptpoint_tpu_torch.models.build import init_weights_
from adaptpoint_tpu_torch.utils import EasyConfig
from adaptpoint_tpu_torch.utils.convert import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures",
                       "ref_layout_pointvit_cls.json")
B, N, NPOINTS, CLASSES, LR = 8, 128, 64, 5, 0.002
SMALL = {"NAME": "PointViT", "in_channels": 4, "embed_dim": 48, "depth": 2,
         "num_heads": 3, "num_groups": 16, "group_size": 8}


def _as(cls, node):
    if isinstance(node, dict):
        return cls({k: _as(cls, v) for k, v in node.items()})
    return node


def _cloud(seed, b=B, n=N):
    rng = np.random.default_rng(seed)
    pos = (rng.standard_normal((b, n, 3)) * 0.4).astype(np.float32)
    return pos, np.concatenate([pos, np.abs(pos[..., 1:2])], -1)


def _full_width_model():
    cfg = EasyConfig()
    cfg.load(os.path.join(REPO, "cfgs", "scanobjectnn", "pointvit.yaml"),
             recursive=True)
    return json.loads(json.dumps(cfg.model))


@pytest.mark.parametrize("which", ["fixture", "full_width"])
def test_converter_equals_the_jax_export(which):
    """Random JAX variables of the fixture's model (the reference spec: 16
    groups of 8 at N = 256) or of the cfg's full width: the port's
    conversion equals the JAX export bit for bit, the port's model holds
    the layout, and loads it."""
    if which == "fixture":
        rows = json.load(open(FIXTURE))
        model = {"NAME": "BaseCls", "encoder_args": dict(SMALL),
                 "cls_args": {"NAME": "ClsHead", "num_classes": 15,
                              "mlps": [512, 256],
                              "norm_args": {"norm": "bn1d"}}}
    else:
        model = _full_width_model()
        rows = None
    jmodel = jax_build(_as(JaxConfig, model))
    pos, x = _cloud(1, b=2, n=512)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(pos), jnp.asarray(x),
        training=False))
    rng = np.random.default_rng(7)
    variables = {c: jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes[c])
        for c in ("params", "batch_stats")}
    port = build_model_from_cfg(_as(EasyConfig, model), device="cpu")
    have = [[k, list(v.shape)] for k, v in port.state_dict().items()]
    if rows is None:  # full width: the reference layout is the port's own
        rows = have
        assert sum(p.numel() for p in port.parameters()) == 22_895_503
    else:
        assert have == [[k, list(s)] for k, s in rows]
    ref, report = export_reference_state_dict(variables, rows)
    assert not report.unhandled and not report.missing
    got = state_dict_from_jax(variables, rows)
    assert list(got) == [k for k, _ in rows]
    for key, val in ref.items():
        assert got[key].dtype == (torch.int64 if key.endswith(
            "num_batches_tracked") else torch.float32), key
        np.testing.assert_array_equal(got[key].numpy(), val, err_msg=key)
    port.load_state_dict(got)


def test_own_init_draws_the_jax_distributions():
    """Full width: xavier-uniform bounds and zero biases on the block
    Linears, std 0.02 tokens, U(+-1/sqrt(fan_in)) on the embed and the
    positional MLP; ``init_weights_`` draws the same from a seed."""
    port = build_model_from_cfg(_as(EasyConfig, _full_width_model()),
                                device="cpu")
    seeded = build_model_from_cfg(_as(EasyConfig, _full_width_model()),
                                  device="cpu", seed=3)
    again = init_weights_(build_model_from_cfg(
        _as(EasyConfig, _full_width_model()), device="cpu"),
        torch.Generator().manual_seed(3))
    for a, b in zip(seeded.state_dict().values(), again.state_dict().values()):
        assert torch.equal(a, b)
    for net in (port, seeded):
        enc = net.encoder
        for blk in enc.blocks:
            for lin in (blk.attn.qkv, blk.attn.proj, blk.mlp.fc1,
                        blk.mlp.fc2):
                fan_out, fan_in = lin.weight.shape
                bound = (6.0 / (fan_in + fan_out)) ** 0.5
                w = lin.weight.detach()
                assert w.abs().max() <= bound
                assert w.abs().max() > 0.9 * bound
                if lin.bias is not None:
                    assert not lin.bias.detach().any()
        for tok in (enc.cls_token, enc.cls_pos):
            assert 0.01 < float(tok.detach().std()) < 0.03
        w = enc.patch_embed.conv2[0][0].weight.detach()
        bound = 1.0 / w[0].numel() ** 0.5
        assert bound * 0.9 < w.abs().max() <= bound
    assert not torch.equal(port.encoder.blocks[0].attn.qkv.weight,
                           seeded.encoder.blocks[0].attn.qkv.weight)


def _cfg():
    return {"num_points": NPOINTS, "num_classes": CLASSES,
            "criterion_args": {"NAME": "SmoothCrossEntropy",
                               "label_smoothing": 0.3},
            "lr": LR, "optimizer": {"NAME": "adamw", "weight_decay": 0.05},
            "grad_norm_clip": 10.0, "sched": "cosine", "epochs": 10,
            "warmup_epochs": 0, "min_lr": 1.0e-4, "t_max": 8,
            "model": {"NAME": "BaseCls", "encoder_args": dict(SMALL),
                      "cls_args": {"NAME": "ClsHead", "num_classes": CLASSES,
                                   "mlps": [32, 16], "dropout": 0.0,
                                   "norm_args": {"norm": "bn1d"}}}}


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


def _adam_slack(grad, rtol, atol, eps=1e-8):
    g = np.abs(np.asarray(grad, np.float64))
    return LR * np.minimum(2.0, eps * (atol + rtol * g) / (g + eps) ** 2)


def test_one_train_step_matches_jax():
    d = _cfg()
    jcfg, pcfg = _as(JaxConfig, d), _as(EasyConfig, d)
    jmodel = jax_build(jcfg.model)
    pos, x = _cloud(20)
    batch = {"x": x, "y": np.random.default_rng(21).integers(
        0, CLASSES, (B,)).astype(np.int32)}
    init = jmodel.init(jax.random.PRNGKey(3), jnp.asarray(pos[:2]),
                       jnp.asarray(x[:2]), training=False)
    rng = np.random.default_rng(4)
    variables = {c: _randomize(jax.tree_util.tree_map(np.asarray, init[c]),
                               rng) for c in ("params", "batch_stats")}
    port = build_model_from_cfg(pcfg.model, device="cpu")
    rows = [[k, list(v.shape)] for k, v in port.state_dict().items()]
    port.load_state_dict(state_dict_from_jax(variables, rows))

    key = jax.random.PRNGKey(5)
    rng_fps = jax.random.split(key, 3)[0]
    cols = np.asarray(jax.random.choice(rng_fps, NPOINTS, (NPOINTS,),
                                        replace=False)).copy()
    crit, optimizer, _ = build_train_tools(pcfg, port)
    step = make_train_step(port, optimizer, crit, pcfg)
    _, loss, preds = step(
        TrainState(port, optimizer),
        {k: torch.from_numpy(np.array(v)) for k, v in batch.items()},
        torch.from_numpy(cols), LR)

    criterion, tx, _ = jt.build_train_tools(jcfg, jmodel,
                                            variables["params"])
    state = jt.TrainState(params=variables["params"],
                          batch_stats=variables["batch_stats"],
                          opt_state=tx.init(variables["params"]),
                          step=jnp.zeros((), jnp.int32))
    new_state, ref_loss, ref_preds = jt.make_train_step(
        jmodel, tx, criterion, jcfg)(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, key,
        jnp.float32(LR))
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_array_equal(preds.numpy(), np.asarray(ref_preds))

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

    # the head's pre-BatchNorm Dense biases put back: the port has none
    params = jax.tree_util.tree_map(lambda v: v, new_state.params)
    for blk, sub in params["prediction"].items():
        if blk.startswith("LinearBlock"):
            sub["Dense_0"]["bias"] = \
                variables["params"]["prediction"][blk]["Dense_0"]["bias"]
    after = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, {
        "params": params, "batch_stats": new_state.batch_stats}), rows)
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
