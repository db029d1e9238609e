"""The port's scene-segmentation train and eval steps against the JAX
package's ``engine/seg_main.py``, on the CPU.

``BaseSeg`` cut from the S3DIS cfgs (``tests/test_torch_seg.py``
``SMALL_SEG``: blocks [1, 2, 2], strides [1, 4, 4], width 16, K = 8, 13
classes) on B = 4 crops of N = 256 points, features ``x,heights`` (colour
and height, ``in_channels: 4``), the same numpy weights in both packages.
JAX runs its XLA route, the port its plain versions. The head's dropout
mask is read off flax for the step's key and handed to the port. The S3DIS
cfg's criterion (cross entropy, label smoothing 0.2; with
``cls_weighed_loss`` the class weights of ``get_class_weights``), optax's
clip and AdamW. Tolerances and slack rules are those of
``tests/test_torch_partseg_step.py``:

- loss rtol 1e-4 / atol 1e-6, predictions equal;
- gradients by name rtol 1e-4 / atol 1e-5, against JAX's eager
  ``jax.grad`` of the step's loss; after the AdamW update every parameter
  within rtol 1e-4 / atol 1e-6 plus ``_adam_slack`` (the first-order effect
  of the gradient tolerance on Adam's update), BatchNorm buffers rtol 1e-4 /
  atol 1e-6;
- ``validate_seg`` over a padded last batch: the same mIoU, mAcc, OA and
  per-class IoUs as JAX's (the same predictions, float64 sums).
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
from adaptpoint_tpu.engine import seg_main as jsm
from adaptpoint_tpu.parallel import get_mesh
from adaptpoint_tpu.utils import EasyConfig as JaxConfig
from adaptpoint_tpu_torch.datasets.data_util import get_class_weights
from adaptpoint_tpu_torch.datasets.s3dis import S3DIS_NUM_PER_CLASS
from adaptpoint_tpu_torch.engine import TrainState, build_train_tools
from adaptpoint_tpu_torch.engine.seg_main import (make_seg_eval_step,
                                                  make_seg_train_step,
                                                  seg_batch, train_seg_epoch,
                                                  validate_seg)
from adaptpoint_tpu_torch.utils import EasyConfig
from adaptpoint_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_seg import SMALL_SEG, as_cfg, seg_pair

B, N, CLASSES, LR = 4, 256, 13, 0.01
ADAM_EPS = 1e-8


def cfgs(clip=10.0, weighted=False):
    d = {"num_classes": CLASSES, "feature_keys": "x,heights",
         "criterion_args": {"NAME": "CrossEntropy", "label_smoothing": 0.2},
         "lr": LR, "optimizer": {"NAME": "adamw", "weight_decay": 1e-4},
         "grad_norm_clip": clip, "sched": "cosine", "epochs": 10,
         "t_max": 10, "warmup_epochs": 0, "min_lr": 1e-5,
         "cls_weighed_loss": weighted,
         "model": json.loads(json.dumps(SMALL_SEG))}
    return as_cfg(JaxConfig, d), as_cfg(EasyConfig, d)


def seg_inputs(seed, b=B):
    rng = np.random.default_rng(seed)
    pos = (rng.random((b, N, 3)) * [1.2, 1.2, 0.9]).astype(np.float32)
    return {"pos": pos, "x": rng.random((b, N, 3)).astype(np.float32),
            "heights": pos[..., 2:3].copy(),
            "y": rng.integers(0, CLASSES, (b, N)).astype(np.int64)}


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items() if k != "n_valid"}


def dropout_mask(jmodel, variables, batch, key):
    """The head's keep-mask the JAX step draws from ``key``: what left the
    Dropout against what entered it, on a standalone train-mode apply."""
    x = np.concatenate([batch["x"], batch["heights"]], -1)
    _, st = jmodel.apply(
        variables, jnp.asarray(batch["pos"]), jnp.asarray(x), training=True,
        rngs={"dropout": key}, mutable=["batch_stats", "intermediates"],
        capture_intermediates=lambda m, _: isinstance(m, fnn.Dropout)
        or type(m).__name__ == "ConvBlock")
    inter = st["intermediates"]["head"]
    entered = np.asarray(inter["ConvBlock_0"]["__call__"][0])
    left = np.asarray(inter["Dropout_0"]["__call__"][0])
    return torch.from_numpy((left != 0) | (entered == 0))


def adam_slack(grad, lr, rtol, atol):
    g = np.abs(np.asarray(grad, np.float64))
    delta = atol + rtol * g
    return lr * np.minimum(2.0, ADAM_EPS * delta / (g + ADAM_EPS) ** 2)


def jax_state(jmodel, variables, jcfg, weights=None):
    criterion, tx, _ = jt.build_train_tools(jcfg, jmodel, variables["params"])
    if weights is not None:
        criterion.weight = jnp.asarray(weights)
    return criterion, tx, jt.TrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]),
        step=jnp.zeros((), jnp.int32))


def tensors(batch, cfg):
    return seg_batch(batch, torch.device("cpu"), cfg)


@pytest.mark.parametrize("clip_factor,weighted", [(0.5, False), (2.0, True)])
def test_one_train_step_matches_jax(clip_factor, weighted):
    """``clip_factor`` times the measured gradient norm is the clip: 0.5
    makes the clip scale the gradients, 2.0 leaves them as they are."""
    jcfg, pcfg = cfgs(weighted=weighted)
    jmodel, variables, port, rows, _ = seg_pair(SMALL_SEG, N, 3, b=B)
    weights = (get_class_weights(S3DIS_NUM_PER_CLASS, normalize=True)
               if weighted else None)
    batch, key = seg_inputs(20), jax.random.PRNGKey(5)
    criterion, _, state = jax_state(jmodel, variables, jcfg, weights)
    x = jnp.asarray(np.concatenate([batch["x"], batch["heights"]], -1))

    def loss_fn(params):
        logits, _ = jmodel.apply(
            {"params": params, "batch_stats": state.batch_stats},
            jnp.asarray(batch["pos"]), x, training=True,
            rngs={"dropout": key}, mutable=["batch_stats"])
        return criterion(logits, jnp.asarray(batch["y"]))

    grads = jax.grad(loss_fn)(state.params)
    norm = float(optax.global_norm(grads))
    clip = clip_factor * norm
    jcfg.grad_norm_clip = pcfg.grad_norm_clip = clip
    criterion, tx, state = jax_state(jmodel, variables, jcfg, weights)
    jstep, _ = jsm.make_seg_steps(jmodel, tx, criterion, jcfg)
    new_state, ref_loss, ref_preds = jstep(state, jax_batch(batch), key,
                                           jnp.float32(LR))

    pcrit, optimizer, _ = build_train_tools(pcfg, port)
    if weighted:
        pcrit.weight = torch.as_tensor(weights)
    pstep = make_seg_train_step(port, optimizer, pcrit, pcfg)
    mask = dropout_mask(jmodel, variables, batch, key)
    pstate, loss, preds = pstep(TrainState(port, optimizer),
                                tensors(batch, pcfg), LR, dropout_mask=mask)
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
    assert any(".pwconv." in k for k in named)
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(),
                                   ref_grads[name].numpy() * scale,
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    slack = {k: adam_slack(ref_grads[k].numpy() * scale, LR, 1e-4, 1e-5)
             for k in named}
    assert np.mean([(v < 1e-6).mean() for v in slack.values()]) > 0.85
    ref = state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": new_state.params,
                     "batch_stats": new_state.batch_stats}), rows)
    got = port.state_dict()
    for k, val in ref.items():
        if k.endswith("num_batches_tracked"):
            continue
        bound = 1e-6 + 1e-4 * np.abs(val.numpy()) + slack.get(k, 0.0)
        err = np.abs(got[k].numpy() - val.numpy())
        assert (err <= bound).all(), (k, float(err.max()))
    moved = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, variables),
                                rows)
    for name, p in named.items():
        assert not torch.equal(p.detach(), moved[name]), name


def loader():
    """Three eval batches; the last is padded from 3 real rows to 4."""
    out = []
    for i in range(3):
        b = seg_inputs(50 + i)
        if i == 2:
            for k in b:
                b[k][3:] = b[k][:1]
            b["n_valid"] = np.asarray(3, np.int32)
        out.append(b)
    return out


def test_validate_seg_with_a_padded_last_batch_matches_jax():
    jcfg, pcfg = cfgs()
    jmodel, variables, port, _, _ = seg_pair(SMALL_SEG, N, 7, b=B)
    _, _, state = jax_state(jmodel, variables, jcfg)
    _, jeval = jsm.make_seg_steps(jmodel, None, None, jcfg)
    ref = jsm.validate_seg(jeval, state, copy.deepcopy(loader()),
                           get_mesh(jax.devices()[:1]), jcfg)
    _, optimizer, _ = build_train_tools(pcfg, port)
    pstate = TrainState(port, optimizer)
    got = validate_seg(make_seg_eval_step(port), pstate, loader(), pcfg)
    assert set(got) == {"miou", "macc", "oa", "ious", "accs"}
    assert (got["miou"], got["macc"], got["oa"]) == ref[:3]
    np.testing.assert_array_equal(got["ious"], ref[3])
    np.testing.assert_array_equal(got["accs"], ref[4])
    assert not port.training
    # the padding is cut: a loader of the real rows alone gives the same
    rows3 = loader()
    rows3[2] = {k: v[:3] for k, v in rows3[2].items() if k != "n_valid"}
    assert validate_seg(make_seg_eval_step(port), pstate, rows3,
                        pcfg) == got


@pytest.mark.parametrize("keys,width", [("x,heights", 4), ("pos,heights", 4),
                                        ("pos,x,heights", 7), ("x", 3)])
def test_seg_batch_takes_the_feature_keys_in_order(keys, width):
    batch = seg_inputs(9)
    got = seg_batch(batch, torch.device("cpu"),
                    EasyConfig({"feature_keys": keys}))
    want = np.concatenate([batch[k] for k in keys.split(",")], -1)
    assert got["x"].shape == (B, N, width)
    np.testing.assert_array_equal(got["x"].numpy(), want)
    assert got["y"].dtype == torch.int64 and got["pos"].is_contiguous()
    with pytest.raises(ValueError):
        seg_batch(batch, torch.device("cpu"),
                  EasyConfig({"feature_keys": "x,normals"}))


def test_train_seg_epoch_runs_the_steps():
    _, pcfg = cfgs()
    _, _, port, _, _ = seg_pair(SMALL_SEG, N, 8, b=B)
    pcrit, optimizer, lr_fn = build_train_tools(pcfg, port)
    pstep = make_seg_train_step(port, optimizer, pcrit, pcfg)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    state, loss = train_seg_epoch(pstep, TrainState(port, optimizer),
                                  [seg_inputs(60 + i) for i in range(3)],
                                  torch.Generator().manual_seed(0), lr_fn(0),
                                  pcfg)
    assert state.step == 3 and port.training and np.isfinite(loss)
    assert optimizer.param_groups[0]["lr"] == lr_fn(0)
    assert all(not torch.equal(v, before[k])
               for k, v in port.state_dict().items()
               if k.endswith(("weight", "running_mean")))
