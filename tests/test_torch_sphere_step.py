"""The sphere protocol's steps against the JAX package's
``engine/seg_main.py``, on the CPU.

- One masked train step (``MaskedCrossEntropy``, label smoothing 0.2) of
  the sphere cfg's model cut to size (``SPHERE_SEG``) on a batch of four
  ``S3DISSphere`` spheres of 256 points, padded by resampling (so the
  copies reach the ball query and the 3-NN interpolation), with the JAX
  head's dropout mask handed over: loss and predictions against JAX's
  step; gradients, the AdamW update and BatchNorm buffers within the
  tolerances of ``tests/test_torch_seg_step.py`` once the two roundings
  the spheres expose are taken out of both packages (the test's
  docstring); the padding's labels leave the loss.
- ``validate_sphere`` over a loader whose last batch is padded, with the
  same oracle logits in both packages (a class from each point's height,
  so overlapping spheres disagree near class bounds): the same mIoU, mAcc,
  OA and per-class IoUs and accuracies, bit for bit, and the same OBJ
  files with ``visualize``.
- ``main_6fold`` over six areas of voxel crops with an oracle eval step and
  the checkpoint loads recorded: the same per-area and overall metrics as
  JAX's ``main_6fold``, each area's checkpoint path formatted from
  ``pretrained_path``.
"""
import copy
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import linen as fnn
from flax.linen import normalization as flax_norm

from adaptpoint_tpu.datasets.loader import NumpyLoader as JaxLoader
from adaptpoint_tpu.datasets.s3dis import S3DISSphere as JaxSphere
import adaptpoint_tpu.ops as jops
from adaptpoint_tpu.engine import seg_main as jsm
from adaptpoint_tpu.engine.cls_trainer import set_lr as optax_set_lr
from adaptpoint_tpu.models import build_model_from_cfg as jax_build
from adaptpoint_tpu.ops.geometry import index_points as jax_index
from adaptpoint_tpu.parallel import get_mesh
from adaptpoint_tpu.utils import EasyConfig as JaxConfig
from adaptpoint_tpu_torch import ops as pops
from adaptpoint_tpu_torch.datasets import NumpyLoader, S3DISSphere
from adaptpoint_tpu_torch.engine import TrainState, build_train_tools
from adaptpoint_tpu_torch.engine import seg_main as psm
from adaptpoint_tpu_torch.engine.seg_main import (make_seg_train_step,
                                                  seg_batch, validate_sphere)
from adaptpoint_tpu_torch.models import build_model_from_cfg
from adaptpoint_tpu_torch.utils import EasyConfig
from adaptpoint_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_seg import SMALL_SEG, as_cfg, randomize, scene_inputs
from test_torch_seg_step import (LR, adam_slack, dropout_mask, jax_batch,
                                 jax_state)
from test_torch_sphere_data import SPHERE, sphere_transforms, write_areas

B, N = 4, 256
# the sphere cfg's model (PointNeXt-S: sa_layers 2, residual SA stages, one
# block a stage) cut to blocks [1, 1, 1], strides [1, 4, 4], width 16, K = 8
SPHERE_SEG = json.loads(json.dumps(SMALL_SEG))
SPHERE_SEG["encoder_args"].update(blocks=[1, 1, 1], sa_layers=2,
                                  sa_use_res=True)


def optax_lr(opt_state):
    return optax_set_lr(opt_state, jnp.float32(LR))


def sphere_cfgs(**extra):
    d = {"num_classes": 13, "feature_keys": "x,heights",
         "criterion_args": {"NAME": "MaskedCrossEntropy",
                            "label_smoothing": 0.2},
         "lr": LR, "optimizer": {"NAME": "adamw", "weight_decay": 1e-4},
         "grad_norm_clip": 10.0, "sched": "cosine", "epochs": 10,
         "t_max": 10, "warmup_epochs": 0, "min_lr": 1e-5,
         "ignore_index": None, "model": json.loads(json.dumps(SPHERE_SEG)),
         **extra}
    return as_cfg(JaxConfig, d), as_cfg(EasyConfig, d)


def sphere_batch(root):
    port_t, _ = sphere_transforms("train")
    ds = S3DISSphere(data_root=root, split="train", transform=port_t,
                     **SPHERE)
    batch = next(iter(NumpyLoader(ds, B, shuffle=True, drop_last=True,
                                  seed=3)))
    return {k: batch[k] for k in ("pos", "x", "heights", "y", "mask")}


def sphere_pair(seed):
    """SPHERE_SEG in both packages with the same randomised weights (the
    JAX init jitted)."""
    jmodel = jax_build(as_cfg(JaxConfig, SPHERE_SEG))
    pos, x = scene_inputs(seed, 2, N)
    variables = randomize(jax.jit(jmodel.init, static_argnames="training")(
        jax.random.PRNGKey(seed), jnp.asarray(pos), jnp.asarray(x),
        training=False), seed + 1)
    port = build_model_from_cfg(as_cfg(EasyConfig, SPHERE_SEG), device="cpu")
    rows = [[k, list(v.shape)] for k, v in port.state_dict().items()]
    port.load_state_dict(state_dict_from_jax(variables, rows))
    return jmodel, variables, port, rows


def test_one_masked_train_step_matches_jax(tmp_path, monkeypatch):
    """The port's step against JAX's ``make_seg_steps`` step (loss and
    predictions), then its gradients, AdamW update and BatchNorm buffers
    against the same JAX step with two roundings taken out of both
    packages, each a rounding the spheres bring to light:

    - the FP levels' 3-NN distances in the difference form, sqrt(sum((q -
      p)^2)), in place of the expanded form |q|^2 + |p|^2 - 2 q.p: a padded
      sphere's copies sit within the jitter (~5 mm) of their originals, so
      the expanded form's rounding (~1e-7 m^2) moves their reciprocal
      weights by tens of percent, differently in each package;
    - flax's BatchNorm statistics in two passes (``use_fast_variance=
      False``): the heights are absolute (0-3 m), so the stem's outputs sit
      far from zero, where flax's default E[x^2] - E[x]^2 loses digits that
      the port's two-pass variance keeps (ROADMAP "Kept on purpose").
    """
    batch = sphere_batch(write_areas(tmp_path))
    real = batch["mask"].sum(1)
    assert (real < N).all() and (real > 0).all()  # every sphere padded
    jcfg, pcfg = sphere_cfgs()
    jmodel, variables, port, rows = sphere_pair(11)
    key = jax.random.PRNGKey(9)
    criterion, tx, state = jax_state(jmodel, variables, jcfg)
    jstep, _ = jsm.make_seg_steps(jmodel, tx, criterion, jcfg)
    _, ref_loss, ref_preds = jstep(state, jax_batch(batch), key,
                                   jnp.float32(LR))

    def loss_fn(params):
        x = np.concatenate([batch["x"], batch["heights"]], -1)
        logits, upd = jmodel.apply(
            {"params": params, "batch_stats": state.batch_stats},
            jnp.asarray(batch["pos"]), jnp.asarray(x), training=True,
            rngs={"dropout": key}, mutable=["batch_stats"])
        loss = criterion(logits, jnp.asarray(batch["y"]),
                         jnp.asarray(batch["mask"]))
        return loss, upd["batch_stats"]

    def grad_fn():  # a new function a call: jit traces it afresh
        return jax.jit(jax.value_and_grad(lambda p: loss_fn(p),
                                          has_aux=True))

    tensors = seg_batch(batch, torch.device("cpu"), pcfg)
    assert tensors["mask"].dtype == torch.int32
    mask = dropout_mask(jmodel, variables, batch, key)
    twin = copy.deepcopy(port)
    crit, opt, _ = build_train_tools(pcfg, twin)
    _, loss, preds = make_seg_train_step(twin, opt, crit, pcfg)(
        TrainState(twin, opt), tensors, LR, dropout_mask=mask)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_array_equal(preds.numpy(), np.asarray(ref_preds))

    stats = flax_norm._compute_stats
    monkeypatch.setattr(flax_norm, "_compute_stats", lambda *a, **kw: stats(
        *a, **dict(kw, use_fast_variance=False)))
    jnn, pnn = jops.three_nn, pops.three_nn

    def jax_nn(unknown, known):
        idx = jnn(unknown, known)[1]
        diff = unknown[:, :, None] - jax_index(known, idx)
        return jnp.sqrt((diff ** 2).sum(-1)), idx

    def port_nn(unknown, known):
        idx = pnn(unknown, known)[1]
        diff = unknown[:, :, None] - pops.index_points(known, idx)
        return torch.sqrt((diff ** 2).sum(-1)), idx

    monkeypatch.setattr(jops, "three_nn", jax_nn)
    monkeypatch.setattr(pops, "three_nn", port_nn)
    (loss2, stats2), grads = grad_fn()(state.params)
    assert float(optax.global_norm(grads)) < 10.0  # the clip leaves them
    pcrit, optimizer, _ = build_train_tools(pcfg, port)
    _, loss, _ = make_seg_train_step(port, optimizer, pcrit, pcfg)(
        TrainState(port, optimizer), tensors, LR, dropout_mask=mask)
    np.testing.assert_allclose(loss.item(), float(loss2), rtol=1e-4,
                               atol=1e-6)

    def by_name(params, bn):
        return state_dict_from_jax(jax.tree_util.tree_map(
            np.asarray, {"params": params, "batch_stats": bn}), rows)

    zeros = jax.tree_util.tree_map(np.zeros_like, variables["batch_stats"])
    ref = by_name(grads, zeros)
    named = dict(port.named_parameters())
    as_is = dict(twin.named_parameters())
    parted = 0
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
        parted += int((~np.isclose(as_is[name].grad.numpy(),
                                   p.grad.numpy(), rtol=1e-4,
                                   atol=1e-5)).sum())
    assert parted > 0  # the roundings taken out move the step

    @jax.jit
    def adamw(grads, opt_state, params):
        upd, _ = tx.update(grads, optax_lr(opt_state), params)
        return optax.apply_updates(params, upd)

    want = by_name(adamw(grads, state.opt_state, state.params), stats2)
    slack = {k: adam_slack(ref[k].numpy(), LR, 1e-4, 1e-5) for k in named}
    got = port.state_dict()
    for k, val in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        bound = 1e-6 + 1e-4 * np.abs(val.numpy()) + slack.get(k, 0.0)
        err = np.abs(got[k].numpy() - val.numpy())
        assert (err <= bound).all(), (k, float(err.max()))
    moved = by_name(variables["params"], variables["batch_stats"])
    assert all(not torch.equal(p.detach(), moved[k])
               for k, p in named.items())
    # the padding's labels leave the loss
    logits = torch.randn((B, N, 13),
                         generator=torch.Generator().manual_seed(0))
    other = torch.where(tensors["mask"] > 0, tensors["y"],
                        (tensors["y"] + 5) % 13)
    assert pcrit(logits, other, tensors["mask"]).item() == pcrit(
        logits, tensors["y"], tensors["mask"]).item()


# ---------------------------------------------------- validate_sphere

def jax_oracle(state, batch):
    """Logits of a class from each point's absolute height: 10 on it, 4 on
    the next class up."""
    z = batch["heights"][..., 0]
    cls = jnp.clip((z / 3.0 * 13).astype(jnp.int32), 0, 12)
    return (jax.nn.one_hot(cls, 13) * 10.0
            + jax.nn.one_hot((cls + 1) % 13, 13) * 4.0)


def port_oracle(state, batch):
    z = batch["x"][..., -1]  # feature_keys x,heights: the height is last
    cls = torch.clamp((z / 3.0 * 13).to(torch.int32), 0, 12).long()
    return (torch.nn.functional.one_hot(cls, 13).float() * 10.0
            + torch.nn.functional.one_hot((cls + 1) % 13, 13).float() * 4.0)


def test_validate_sphere_matches_jax(tmp_path):
    root = write_areas(tmp_path / "data")
    port_t, jax_t = sphere_transforms("val")
    kw = dict(SPHERE, num_steps=6)  # batches of 4: the last one padded
    ds = S3DISSphere(data_root=root, split="val", transform=port_t, **kw)
    jds = JaxSphere(data_root=root, split="val", transform=jax_t, **kw)
    jcfg, pcfg = sphere_cfgs(visualize=True)
    jcfg.run_dir, pcfg.run_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    ref = jsm.validate_sphere(jax_oracle, None, JaxLoader(jds, B),
                              get_mesh(jax.devices()[:1]), jcfg)
    loader = NumpyLoader(ds, B)
    assert len(loader) == 2
    state = TrainState(torch.nn.Linear(1, 1), None)  # the CPU
    got = validate_sphere(port_oracle, state, loader, pcfg)
    assert (got["miou"], got["macc"], got["oa"]) == ref[:3]
    np.testing.assert_array_equal(got["ious"], ref[3])
    np.testing.assert_array_equal(got["accs"], ref[4])
    assert 50 < got["oa"] < 100  # near class bounds the spheres disagree
    files = sorted(os.listdir(tmp_path / "port" / "visualization"))
    assert files == ["gt-0.obj", "input-0.obj", "pred-0.obj"]
    for f in files:
        assert (tmp_path / "port" / "visualization" / f).read_text() == (
            tmp_path / "jax" / "visualization" / f).read_text(), f


# ------------------------------------------------------------ main_6fold

def crop_cfgs(root):
    d = {"num_classes": 13, "feature_keys": "x,heights", "seed": 2,
         "batch_size": 2, "val_batch_size": 2, "lr": 0.01,
         "optimizer": {"NAME": "adamw", "weight_decay": 1e-4},
         "criterion_args": {"NAME": "CrossEntropy"}, "ignore_index": None,
         "dataloader": {"num_workers": 0},
         "dataset": {"common": {"NAME": "S3DIS", "data_root": root,
                                "test_area": 5, "voxel_size": 0.1},
                     "train": {"split": "train", "voxel_max": 128},
                     "val": {"split": "val", "voxel_max": 128}},
         "datatransforms": {"train": ["PointsToTensor"],
                            "val": ["PointsToTensor", "PointCloudXYZAlign"],
                            "kwargs": {"gravity_dim": 2}},
         "pretrained_path": os.path.join(root, "area{area}.pth"),
         "model": json.loads(json.dumps(SMALL_SEG))}
    return as_cfg(JaxConfig, copy.deepcopy(d)), as_cfg(EasyConfig, d)


class Tiny(fnn.Module):
    @fnn.compact
    def __call__(self, pos, x, training=False):
        return fnn.Dense(13)(x)


def test_main_6fold_matches_jax(tmp_path, monkeypatch):
    root = write_areas(tmp_path, n=300)
    jcfg, pcfg = crop_cfgs(root)

    def jax_eval(state, batch):
        z = batch["pos"][..., 2]
        return jnp.clip((z * 4.0).astype(jnp.int32), 0, 12)

    def port_eval(state, batch):
        z = batch["pos"][..., 2]
        return torch.clamp((z * 4.0).to(torch.int32), 0, 12)

    loaded = {"jax": [], "port": []}
    monkeypatch.setattr(jsm, "build_model_from_cfg", lambda _: Tiny())
    monkeypatch.setattr(jsm, "make_seg_steps", lambda *a: (None, jax_eval))
    monkeypatch.setattr(jsm, "load_checkpoint", lambda payload, path: (
        loaded["jax"].append(path) or (payload, 0, 0.0)))
    monkeypatch.setattr(jsm, "_restore_state", lambda state, _: state)
    monkeypatch.setattr(psm, "make_seg_eval_step",
                        lambda model, fused_eval=False: port_eval)
    monkeypatch.setattr(psm, "load_checkpoint",
                        lambda model, path: loaded["port"].append(path))
    ref = jsm.main_6fold(jcfg)
    got = psm.main_6fold(pcfg, device="cpu")
    assert loaded["port"] == loaded["jax"] == [
        os.path.join(root, f"area{a}.pth") for a in range(1, 7)]
    assert list(got) == list(ref) == [1, 2, 3, 4, 5, 6, "overall"]
    for k in got:
        assert got[k] == ref[k], k
    assert 0 < got["overall"]["oa"] < 100
    assert pcfg.dataset.common.test_area == 6


def test_main_6fold_needs_a_checkpoint_pattern(tmp_path):
    _, pcfg = crop_cfgs(str(tmp_path))
    pcfg.pretrained_path = None
    with pytest.raises(ValueError, match="pretrained_path"):
        psm.main_6fold(pcfg, device="cpu")
