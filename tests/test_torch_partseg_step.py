"""The port's part-segmentation train and eval steps against the JAX
package's ``engine/partseg_main.py``, on the CPU (the GAN step:
``tests/test_torch_partseg_gan.py``).

``tests/test_partseg.py``'s ``PARTSEG_CFG`` (width 16, three stages,
``cls_map`` pointnet2 and curvenet) on B = 4 clouds of N = 64 points, 8
part labels over 4 shape categories, the same numpy weights in both
packages. JAX runs its XLA route, the port its plain versions. The head's
dropout mask is read off flax for the step's key and handed to the port.
Tolerances and slack rules are those of ``tests/test_torch_train_step.py``:

- loss rtol 1e-4 / atol 1e-6, predictions equal;
- gradients by name rtol 1e-4 / atol 1e-5; after one step every parameter
  within rtol 1e-4 / atol 1e-6 plus ``_adam_slack``, the first-order effect
  of the gradient tolerance on Adam's update (nothing for ordinary
  gradients, at most 2 lr); BatchNorm buffers rtol 1e-4 / atol 1e-6;
- three steps with Adam's eps at 1e-3 (so that an entry whose gradient is
  rounding noise does not move by lr in either direction): parameters and
  buffers rtol 1e-4 / atol 1e-5.

The reference gradient is JAX's eager ``jax.grad`` of the step's loss, as
in the classifier's test (a jitted one sums in other orders: it sits up to
9e-4 of a tensor's 2-norm from the eager one here).
"""
import copy
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import linen as fnn

from adaptpoint_tpu.engine import cls_trainer as jt
from adaptpoint_tpu.engine import partseg_main as jps
from adaptpoint_tpu.parallel import get_mesh
from adaptpoint_tpu.utils import EasyConfig as JaxConfig
from adaptpoint_tpu_torch.engine import TrainState, build_train_tools
from adaptpoint_tpu_torch.engine.partseg_main import (
    make_partseg_eval_step, make_partseg_train_step, partseg_batch,
    train_partseg_epoch, validate_partseg)
from adaptpoint_tpu_torch.utils import EasyConfig
from adaptpoint_tpu_torch.utils.convert import state_dict_from_jax
from test_partseg import PARTSEG_CFG
from test_torch_partseg import _as, model_pair

B, N, PARTS, SHAPES, LR = 4, 64, 8, 4, 0.002
ADAM_EPS = 1e-8


def _model(cls_map):
    d = json.loads(json.dumps(PARTSEG_CFG))
    d["decoder_args"]["cls_map"] = cls_map
    return d


def _cfgs(cls_map, clip=10.0):
    d = {"num_points": N, "num_classes": PARTS,
         "criterion_args": {"NAME": "SmoothCrossEntropy",
                            "label_smoothing": 0.2},
         "lr": LR, "optimizer": {"NAME": "adamw", "weight_decay": 0.05},
         "grad_norm_clip": clip, "sched": "multistep", "epochs": 10,
         "decay_epochs": [2, 5], "decay_rate": 0.1, "warmup_epochs": 0,
         "min_lr": 1e-5, "model": _model(cls_map)}
    return _as(JaxConfig, d), _as(EasyConfig, d)


def _batch(seed, b=B):
    rng = np.random.default_rng(seed)
    pos = (rng.standard_normal((b, N, 3)) * 0.4).astype(np.float32)
    height = pos[..., 1:2] - pos[..., 1:2].min(1, keepdims=True)
    return {"pos": pos, "x": np.concatenate([pos, height], -1),
            "y": rng.integers(0, PARTS, (b, N)).astype(np.int32),
            "cls": rng.integers(0, SHAPES, (b,)).astype(np.int32)}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _dropout_mask(jmodel, variables, batch, key):
    """The head's keep-mask the JAX step draws from ``key``: what left the
    Dropout against what entered it, on a standalone train-mode apply."""
    _, st = jmodel.apply(
        variables, jnp.asarray(batch["pos"]), jnp.asarray(batch["x"]),
        jnp.asarray(batch["cls"]), training=True, rngs={"dropout": key},
        mutable=["batch_stats", "intermediates"],
        capture_intermediates=lambda m, _: isinstance(m, fnn.Dropout)
        or type(m).__name__ == "ConvBlock")
    inter = st["intermediates"]["head"]
    entered = np.asarray(inter["ConvBlock_0"]["__call__"][0])
    left = np.asarray(inter["Dropout_0"]["__call__"][0])
    return torch.from_numpy((left != 0) | (entered == 0))


def _adam_slack(grad, lr, rtol, atol):
    g = np.abs(np.asarray(grad, np.float64))
    delta = atol + rtol * g
    return lr * np.minimum(2.0, ADAM_EPS * delta / (g + ADAM_EPS) ** 2)


def _assert_state(port, variables, rows, rtol, atol, slack=None):
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, variables),
                              rows)
    got = port.state_dict()
    for key, val in ref.items():
        if key.endswith("num_batches_tracked"):
            continue
        bound = atol + rtol * np.abs(val.numpy())
        if slack is not None and key in slack:
            bound = bound + slack[key]
        err = np.abs(got[key].numpy() - val.numpy())
        assert (err <= bound).all(), (key, float(err.max()))


def _jax_state(jmodel, variables, jcfg):
    criterion, tx, _ = jt.build_train_tools(jcfg, jmodel, variables["params"])
    return criterion, tx, jt.TrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]),
        step=jnp.zeros((), jnp.int32))


def _tensors(batch):
    return partseg_batch(batch, torch.device("cpu"))


@pytest.mark.parametrize("cls_map,clip_factor", [("pointnet2", 0.5),
                                                 ("curvenet", 2.0)])
def test_one_train_step_matches_jax(cls_map, clip_factor):
    """``clip_factor`` times the measured gradient norm is the clip: 0.5
    makes the clip scale the gradients, 2.0 leaves them as they are."""
    jcfg, pcfg = _cfgs(cls_map)
    jmodel, variables, port, rows, _ = model_pair(_model(cls_map), N, SHAPES,
                                                  3, b=B)
    batch, key = _batch(20), jax.random.PRNGKey(5)
    criterion, _, state = _jax_state(jmodel, variables, jcfg)

    def loss_fn(params):
        logits, _ = jmodel.apply(
            {"params": params, "batch_stats": state.batch_stats},
            jnp.asarray(batch["pos"]), jnp.asarray(batch["x"]),
            jnp.asarray(batch["cls"]), training=True, rngs={"dropout": key},
            mutable=["batch_stats"])
        return criterion(logits, jnp.asarray(batch["y"]))

    grads = jax.grad(loss_fn)(state.params)
    norm = float(optax.global_norm(grads))
    clip = clip_factor * norm
    jcfg.grad_norm_clip = pcfg.grad_norm_clip = clip
    criterion, tx, state = _jax_state(jmodel, variables, jcfg)
    jstep = jps.make_partseg_train_step(jmodel, tx, criterion, jcfg)
    new_state, ref_loss, ref_preds = jstep(state, _jax(batch), key,
                                           jnp.float32(LR))

    pcrit, optimizer, _ = build_train_tools(pcfg, port)
    pstep = make_partseg_train_step(port, optimizer, pcrit, pcfg)
    mask = _dropout_mask(jmodel, variables, batch, key)
    pstate, loss, preds = pstep(TrainState(port, optimizer), _tensors(batch),
                                LR, dropout_mask=mask)
    assert pstate.step == 1 and loss.dim() == 0 and not loss.requires_grad
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-4,
                               atol=1e-6)
    assert preds.shape == (B, N)
    np.testing.assert_array_equal(preds.numpy(), np.asarray(ref_preds))

    scale = clip / norm if norm >= clip else 1.0
    zeros = jax.tree_util.tree_map(np.zeros_like, variables["batch_stats"])
    ref_grads = state_dict_from_jax(
        {"params": jax.tree_util.tree_map(np.asarray, grads),
         "batch_stats": zeros}, rows)
    named = dict(port.named_parameters())
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(),
                                   ref_grads[name].numpy() * scale,
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    slack = {k: _adam_slack(ref_grads[k].numpy() * scale, LR, 1e-4, 1e-5)
             for k in named}
    # the slack is nothing for most entries; it is everything for the stem
    # conv's bias (a constant the next stage's BatchNorm removes: its
    # gradient is rounding noise) and most of the curvenet global convs'
    # biases (a per-shape constant over FP0's BatchNorm rows)
    assert np.mean([(v < 1e-6).mean() for v in slack.values()]) > 0.85
    _assert_state(port, {"params": new_state.params,
                         "batch_stats": new_state.batch_stats}, rows, 1e-4,
                  1e-6, slack)
    moved = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, variables),
                                rows)
    for name, p in named.items():
        assert not torch.equal(p.detach(), moved[name]), name


def test_three_train_steps_match_jax():
    jcfg, pcfg = _cfgs("curvenet")
    jcfg.optimizer.eps = pcfg.optimizer.eps = 1e-3
    jmodel, variables, port, rows, _ = model_pair(_model("curvenet"), N,
                                                  SHAPES, 6, b=B)
    criterion, tx, state = _jax_state(jmodel, variables, jcfg)
    jstep = jps.make_partseg_train_step(jmodel, tx, criterion, jcfg)
    pcrit, optimizer, lr_fn = build_train_tools(pcfg, port)
    pstep = make_partseg_train_step(port, optimizer, pcrit, pcfg)
    pstate = TrainState(port, optimizer)
    for i in range(3):
        batch, key = _batch(30 + i), jax.random.PRNGKey(40 + i)
        mask = _dropout_mask(jmodel, {"params": state.params,
                                      "batch_stats": state.batch_stats},
                             batch, key)
        lr = lr_fn(i)
        state, ref_loss, _ = jstep(state, _jax(batch), key, jnp.float32(lr))
        pstate, loss, _ = pstep(pstate, _tensors(batch), lr,
                                dropout_mask=mask)
        np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-4,
                                   atol=1e-5)
    assert lr_fn(0) == LR and lr_fn(2) < LR  # the schedule's decay
    assert pstate.step == 3 and int(state.step) == 3
    _assert_state(port, {"params": state.params,
                         "batch_stats": state.batch_stats}, rows, 1e-4, 1e-5)


def _loader():
    """Three eval batches; the last is padded from 3 real rows to 4."""
    out = []
    for i in range(3):
        b = _batch(50 + i)
        if i == 2:
            for k in b:
                b[k][3:] = b[k][:1]
            b["n_valid"] = np.asarray(3, np.int32)
        out.append(b)
    return out


@pytest.mark.parametrize("refine", [False, True])
def test_validate_partseg_with_a_padded_last_batch_matches_jax(refine):
    jcfg, pcfg = _cfgs("pointnet2")
    jmodel, variables, port, _, _ = model_pair(_model("pointnet2"), N,
                                               SHAPES, 7, b=B)
    _, _, state = _jax_state(jmodel, variables, jcfg)
    ref = jps.validate_partseg(jps.make_partseg_eval_step(jmodel, jcfg),
                               state, copy.deepcopy(_loader()),
                               get_mesh(jax.devices()[:1]), jcfg,
                               refine=refine)
    _, optimizer, _ = build_train_tools(pcfg, port)
    pstate = TrainState(port, optimizer)
    for fused in (False, True):
        got = validate_partseg(make_partseg_eval_step(port, pcfg, fused),
                               pstate, _loader(), refine=refine)
        assert set(got) == {"acc", "ins_miou", "cls_miou"}
        if not fused:  # sa_layers 1: no stage of this model can fuse
            assert got == ref
    assert not port.training
    # the padding is cut: a loader of the real rows alone gives the same
    rows3 = _loader()
    rows3[2] = {k: v[:3] for k, v in rows3[2].items() if k != "n_valid"}
    assert validate_partseg(make_partseg_eval_step(port, pcfg), pstate,
                            rows3, refine=refine) == got


def test_train_partseg_epoch_runs_the_steps():
    _, pcfg = _cfgs("pointnet2")
    _, _, port, _, _ = model_pair(_model("pointnet2"), N, SHAPES, 8, b=B)
    pcrit, optimizer, lr_fn = build_train_tools(pcfg, port)
    pstep = make_partseg_train_step(port, optimizer, pcrit, pcfg)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    loader = [_batch(60 + i) for i in range(3)]
    del loader[1]["x"]  # the fake loader serves pos and heights
    loader[1]["heights"] = loader[0]["x"][..., 3:]
    state, loss = train_partseg_epoch(pstep, TrainState(port, optimizer),
                                      loader, torch.Generator().manual_seed(0),
                                      lr_fn(0))
    assert state.step == 3 and port.training and np.isfinite(loss)
    assert optimizer.param_groups[0]["lr"] == lr_fn(0)
    assert any(not torch.equal(v, before[k])
               for k, v in port.state_dict().items())
    x = partseg_batch(loader[1], torch.device("cpu"))["x"]
    assert torch.equal(x, torch.from_numpy(np.concatenate(
        [loader[1]["pos"], loader[1]["heights"]], -1)))
