"""The port's corruption-mode trainer (``engine/corrupt_main.py``) against
the JAX package, on the CPU.

- One step of ``make_train_step_pointwolf`` and of
  ``make_train_step_mixed`` from the same weights (``state_dict_from_jax``),
  with the JAX step's PointWOLF draws, resampling columns and dropout masks
  recovered from its key and handed to the port: the loss, the predictions,
  every gradient and every updated parameter, at the tolerances
  ``tests/test_torch_train_step.py`` holds the plain step to (loss rtol
  1e-4 / atol 1e-6, gradients rtol 1e-4 / atol 1e-5, parameters rtol 1e-4
  / atol 1e-6 plus ``_adam_slack``). The PointWOLF deformation itself is
  held at ``tests/test_torch_adapt_models.py``'s rtol 1e-4 / atol 1e-5.
- ``mode: scanobjectnnc`` / ``modelnetc`` with the plain, PointWOLF, RSMix
  and WolfMix epochs (the counterpart of ``tests/test_corrupt_modes.py``),
  the sweep skipped without a tree; the CLI with PointWOLF, and
  ``test=True`` sweeping a checkpoint over a ModelNet-C tree.
"""
import glob
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from adaptpoint_tpu.adapt.pointwolf import pointwolf as jax_pointwolf
from adaptpoint_tpu.engine import cls_trainer as jt
from adaptpoint_tpu.engine import corrupt_main as jax_corrupt
from adaptpoint_tpu_torch.engine import build_train_tools, TrainState
from adaptpoint_tpu_torch.engine import corrupt_main
from adaptpoint_tpu_torch.adapt import pointwolf as port_pointwolf
from adaptpoint_tpu_torch.main import main as cli

from test_torch_adapt_models import WOLF, wolf_draws_from_key
from test_torch_train_step import (B, NPOINTS, _adam_slack, _assert_state_equal,
                                   _batch, _grads_by_name, _jax_state, _pair,
                                   _pin_head_bias, _torch_batch)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "cfgs", "synthetic", "pointnext-tiny.yaml")
PW = {"w_num_anchor": 4, "w_sigma": 0.5, "w_R_range": 10, "w_S_range": 3,
      "w_T_range": 0.25}
RS = {"is_use": True, "rsmix_prob": 0.5, "beta": 1.0, "nsample": 32,
      "knn": True}
LR = 0.002


def _dropout_masks(jmodel, variables, pos, x, r_drop):
    """The head's dropout keep-masks the JAX step draws from ``r_drop``,
    read off a forward with the same key (what left each Dropout against
    what entered it; a unit that entered as zero tells nothing)."""
    _, state = jmodel.apply(
        variables, pos, x, training=True, rngs={"dropout": r_drop},
        mutable=["batch_stats", "intermediates"],
        capture_intermediates=lambda m, _: isinstance(
            m, fnn.Dropout) or type(m).__name__ == "NormAct")
    inter = state["intermediates"]["prediction"]
    masks = []
    for blk in ("LinearBlock_0", "LinearBlock_1"):
        entered = np.asarray(inter[blk]["NormAct_0"]["__call__"][0])
        left = np.asarray(inter[blk]["Dropout_0"]["__call__"][0])
        masks.append(torch.from_numpy((left != 0) | (entered == 0)))
    assert 0.2 < masks[0].float().mean() < 0.8
    return masks


def _jax_grads(jmodel, state, points, r_drop, loss_of):
    def loss_fn(params):
        logits, _ = jmodel.apply(
            {"params": params, "batch_stats": state.batch_stats},
            points[..., :3], points, training=True,
            rngs={"dropout": r_drop}, mutable=["batch_stats"])
        return loss_of(logits)

    return jax.grad(loss_fn)(state.params)


def _check_step(jmodel, variables, port, rows, state, new_state, grads,
                ref_loss, ref_preds, loss, preds):
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_array_equal(preds.numpy(), np.asarray(ref_preds))
    ref_grads = _grads_by_name(grads, variables, rows)
    named = dict(port.named_parameters())
    # scaled as the global-norm clip (10) scales them
    norm = float(np.sqrt(sum(float((np.asarray(g) ** 2).sum())
                             for g in jax.tree_util.tree_leaves(grads))))
    scale = 10.0 / norm if norm >= 10.0 else 1.0
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(),
                                   ref_grads[name].numpy() * scale,
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    after = {"params": _pin_head_bias(new_state.params, state.params),
             "batch_stats": new_state.batch_stats}
    slack = {k: _adam_slack(ref_grads[k].numpy() * scale, LR, 1e-4, 1e-5)
             for k in named}
    _assert_state_equal(port, after, rows, 1e-4, 1e-6, slack=slack)


def test_one_pointwolf_step_matches_jax():
    jmodel, variables, port, jcfg, pcfg, rows = _pair(3, dropout=0.5)
    jcfg.pointwolf, pcfg.pointwolf = dict(PW), dict(PW)
    assert WOLF == dict(sigma=PW["w_sigma"], r_range=PW["w_R_range"],
                        s_range=PW["w_S_range"], t_range=PW["w_T_range"])
    batch, key = _batch(20), jax.random.PRNGKey(5)
    criterion, tx, state = _jax_state(jmodel, variables, jcfg)
    jstep = jax_corrupt.make_train_step_pointwolf(jmodel, tx, criterion,
                                                  jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    new_state, ref_loss, ref_preds = jstep(state, jbatch, key, jnp.float32(LR))

    # the step's draws, recovered from its key with the JAX calls it makes
    r_wolf, r_fps, r_drop = jax.random.split(key, 3)
    wolf = wolf_draws_from_key(r_wolf, b=B, m=PW["w_num_anchor"],
                               values=True)
    cols = np.asarray(jax.random.choice(r_fps, NPOINTS, (NPOINTS,),
                                        replace=False)).copy()
    _, ref_xyz = jax_pointwolf(r_wolf, jbatch["x"][..., :3], 4, 0.5, 10.0,
                               3.0, 0.25)
    _, got_xyz = port_pointwolf(wolf, torch.from_numpy(batch["x"][..., :3]
                                                       .copy()), 4, 0.5,
                                10.0, 3.0, 0.25)
    np.testing.assert_allclose(got_xyz.numpy(), np.asarray(ref_xyz),
                               rtol=1e-4, atol=1e-5)
    points = jt.resample_points(
        r_fps, jnp.concatenate([ref_xyz, jbatch["x"][..., 3:]], -1), NPOINTS)
    masks = _dropout_masks(jmodel, variables, points[..., :3], points, r_drop)
    grads = _jax_grads(jmodel, state, points, r_drop,
                       lambda z: criterion(z, jbatch["y"]))

    pcrit, optimizer, _ = build_train_tools(pcfg, port)
    pstep = corrupt_main.make_train_step_pointwolf(port, optimizer, pcrit,
                                                   pcfg)
    pstate, loss, preds = pstep(TrainState(port, optimizer),
                                _torch_batch(batch), torch.from_numpy(cols),
                                LR, dropout_mask=masks, wolf=wolf)
    assert pstate.step == 1
    _check_step(jmodel, variables, port, rows, state, new_state, grads,
                ref_loss, ref_preds, loss, preds)


def test_one_mixed_step_matches_jax():
    """RSMix's two-label loss on a batch mixed on the host."""
    from adaptpoint_tpu.adapt.rsmix import rsmix
    jmodel, variables, port, jcfg, pcfg, rows = _pair(4, dropout=0.5)
    batch, key = _batch(21), jax.random.PRNGKey(6)
    x, lam, y_a, y_b = rsmix(batch["x"], batch["y"].astype(np.int64),
                             beta=1.0, n_sample=32, knn=True,
                             rng=np.random.default_rng(3))
    assert (lam > 0).any() and (y_a != y_b).any()
    mixed = {"x": x.astype(np.float32), "y": y_a.astype(np.int64),
             "y_b": y_b.astype(np.int64), "lam": lam.astype(np.float32)}
    criterion, tx, state = _jax_state(jmodel, variables, jcfg)
    jstep = jax_corrupt.make_train_step_mixed(jmodel, tx, criterion, jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in mixed.items()}
    new_state, ref_loss, ref_preds = jstep(state, jbatch, key, jnp.float32(LR))

    r_fps, r_drop = jax.random.split(key)
    cols = np.asarray(jax.random.choice(r_fps, NPOINTS, (NPOINTS,),
                                        replace=False)).copy()
    points = jt.resample_points(r_fps, jbatch["x"], NPOINTS)
    masks = _dropout_masks(jmodel, variables, points[..., :3], points, r_drop)

    def loss_of(z):
        la = criterion.per_sample(z, jbatch["y"])
        lb = criterion.per_sample(z, jbatch["y_b"])
        return jnp.mean((1.0 - jbatch["lam"]) * la + jbatch["lam"] * lb)

    grads = _jax_grads(jmodel, state, points, r_drop, loss_of)
    pcrit, optimizer, _ = build_train_tools(pcfg, port)
    pstep = corrupt_main.make_train_step_mixed(port, optimizer, pcrit, pcfg)
    _, loss, preds = pstep(TrainState(port, optimizer), _torch_batch(mixed),
                           torch.from_numpy(cols), LR, dropout_mask=masks)
    _check_step(jmodel, variables, port, rows, state, new_state, grads,
                ref_loss, ref_preds, loss, preds)


def test_an_unmixed_batch_takes_the_plain_step():
    """lam = 0 and y_b = y: the mixed step's loss, gradients and updated
    parameters equal the plain step's bit for bit."""
    _, _, port, _, pcfg, _ = _pair(4, dropout=0.5)
    batch = _batch(22)
    start = {k: v.clone() for k, v in port.state_dict().items()}
    y = batch["y"].astype(np.int64)
    unmixed = {"x": batch["x"], "y": y, "y_b": y.copy(),
               "lam": np.zeros(B, np.float32)}
    out = []
    for make in (corrupt_main.make_train_step_mixed,
                 corrupt_main.make_train_step):
        port.load_state_dict(start)
        pcrit, optimizer, _ = build_train_tools(pcfg, port)
        step = make(port, optimizer, pcrit, pcfg)
        _, loss, preds = step(TrainState(port, optimizer),
                              _torch_batch(unmixed),
                              torch.Generator().manual_seed(1), LR)
        out.append((loss, preds, {n: (p.grad.clone(), p.detach().clone())
                                  for n, p in port.named_parameters()}))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])
    for name, (g, p) in out[0][2].items():
        assert torch.equal(g, out[1][2][name][0]), name
        assert torch.equal(p, out[1][2][name][1]), name


def test_the_unmixed_step_parts_from_jax_where_jax_rounds_further():
    """ROADMAP C.7: at lam = 0 (seed 4, batch 21, key 6) the mixed step's
    gradients part from JAX's in a few entries beyond the train-step
    tolerance (rtol 1e-4, atol 1e-5). JAX's own mixed step at lam = 0 gives
    its plain loss's gradients bit for bit, so the mixing is not the cause.
    Against the float64 gradient of the same step (the port's model in
    float64 at the same draws and dropout masks) the port's f32 gradient
    sits within that tolerance everywhere, and every entry where the two
    packages part is one where JAX's f32 gradient sits further from it."""
    from adaptpoint_tpu_torch.engine.cls_trainer import resample_points
    jmodel, variables, port, jcfg, pcfg, rows = _pair(4, dropout=0.5)
    start = {k: v.clone() for k, v in port.state_dict().items()}
    batch, key = _batch(21), jax.random.PRNGKey(6)
    y = batch["y"].astype(np.int64)
    unmixed = {"x": batch["x"].astype(np.float32), "y": y, "y_b": y.copy(),
               "lam": np.zeros(B, np.float32)}
    criterion, _, state = _jax_state(jmodel, variables, jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in unmixed.items()}
    r_fps, r_drop = jax.random.split(key)
    cols = np.asarray(jax.random.choice(r_fps, NPOINTS, (NPOINTS,),
                                        replace=False)).copy()
    points = jt.resample_points(r_fps, jbatch["x"], NPOINTS)
    masks = _dropout_masks(jmodel, variables, points[..., :3], points, r_drop)

    def mixed_loss(z):
        la = criterion.per_sample(z, jbatch["y"])
        lb = criterion.per_sample(z, jbatch["y_b"])
        return jnp.mean((1.0 - jbatch["lam"]) * la + jbatch["lam"] * lb)

    grads = _jax_grads(jmodel, state, points, r_drop, mixed_loss)
    plain = _jax_grads(jmodel, state, points, r_drop,
                       lambda z: criterion(z, jbatch["y"]))
    for g, h in zip(jax.tree_util.tree_leaves(grads),
                    jax.tree_util.tree_leaves(plain)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(h))

    pcrit, optimizer, _ = build_train_tools(pcfg, port)
    pstep = corrupt_main.make_train_step_mixed(port, optimizer, pcrit, pcfg)
    pstep(TrainState(port, optimizer), _torch_batch(unmixed),
          torch.from_numpy(cols), LR, dropout_mask=masks)
    ours = {k: p.grad.numpy().astype(np.float64)
            for k, p in port.named_parameters()}  # clipped by the step
    port.load_state_dict(start)
    twin = port.double().train()
    pc = resample_points(torch.from_numpy(cols),
                         torch.from_numpy(unmixed["x"]), NPOINTS).double()
    pcrit(twin(pc[..., :3].contiguous(), pc.contiguous(),
               dropout_mask=masks), torch.from_numpy(y)).backward()

    def clipped(gs):  # as the global-norm clip (10) scales them
        norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                           for g in gs.values()))
        return {k: g * (10.0 / norm if norm >= 10.0 else 1.0)
                for k, g in gs.items()}

    theirs = clipped({k: v.numpy() for k, v in
                      _grads_by_name(grads, variables, rows).items()})
    exact = clipped({k: p.grad.numpy() for k, p in twin.named_parameters()})
    parted = 0
    for name, g in ours.items():
        tol = 1e-5 + 1e-4 * np.abs(exact[name])
        assert (np.abs(g - exact[name]) <= tol).all(), name
        apart = np.abs(g - theirs[name]) > 1e-5 + 1e-4 * np.abs(theirs[name])
        parted += int(apart.sum())
        assert (np.abs(theirs[name] - exact[name])[apart]
                > np.abs(g - exact[name])[apart]).all(), name
    assert parted > 0  # the case still shows what C.7 found


def _run_dir(root, task="synthetic"):
    runs = glob.glob(os.path.join(root, task, "*"))
    assert len(runs) == 1, runs
    return runs[0]


@pytest.mark.parametrize("mode", ["scanobjectnnc", "modelnetc"])
@pytest.mark.parametrize("variant", ["plain", "pointwolf", "rsmix",
                                     "wolfmix"])
def test_corruption_modes_train_each_variant(tmp_path, caplog, mode,
                                             variant):
    """The counterpart of ``tests/test_corrupt_modes.py``: one epoch of each
    variant; the sweep is skipped without its tree, on the best and the
    latest checkpoints."""
    import logging
    from adaptpoint_tpu_torch.utils import EasyConfig
    cfg = EasyConfig()
    cfg.load(TINY, recursive=True)
    cfg.update({"mode": mode, "epochs": 1, "seed": 2})
    cfg.update_opts(["dataset.common.size=32"])
    extra = {"pointwolf": {"pointwolf": PW}, "rsmix": {"rsmix_params": RS},
             "wolfmix": {"wolfmix": {"rsmix_params": RS, "pointwolf": PW}},
             "plain": {}}[variant]
    cfg.update(EasyConfig(extra))
    cfg.run_dir, cfg.run_name = str(tmp_path), "variant"
    cfg.ckpt_dir = str(tmp_path / "checkpoint")
    with caplog.at_level(logging.INFO):
        best = corrupt_main.main(cfg, device="cpu")
    assert best is not None and 0.0 <= best <= 100.0
    assert f"epoch variant: {variant}" in caplog.text
    assert caplog.text.count("skipping corruption eval") == 2
    assert len(re.findall(r"epoch_seconds [0-9.]+", caplog.text)) == 1
    assert os.path.exists(tmp_path / "checkpoint" / "variant_ckpt_latest.pth")


def test_the_cli_runs_modelnetc_with_pointwolf(tmp_path, capsys):
    root = str(tmp_path / "log")
    best = cli(["--cfg", TINY, "--device", "cpu", "mode=modelnetc",
                "epochs=1", "dataset.common.size=32", "seed=2",
                "pointwolf.w_num_anchor=4", f"root_dir={root}"])
    assert 0.0 <= best <= 100.0
    log = open(os.path.join(_run_dir(root), "log.txt")).read()
    assert "epoch variant: pointwolf" in log
    assert "ModelNet-C" in log  # the ModelNet-C sweep, skipped
    assert '"launch_counts"' in capsys.readouterr().out.splitlines()[-1]


def test_test_mode_sweeps_a_checkpoint_over_a_modelnetc_tree(tmp_path):
    """``test=True`` with ``pretrained_path`` only sweeps: the checkpoint's
    weights over 1 clean + 7 x 5 corrupt splits, and no training."""
    import h5py
    from adaptpoint_tpu_torch.datasets import CORRUPTIONS
    rng = np.random.default_rng(8)
    tree = tmp_path / "modelnet_c"
    tree.mkdir()
    for c in CORRUPTIONS:
        for s in (["clean"] if c == "clean"
                  else [f"{c}_{i}" for i in range(5)]):
            with h5py.File(tree / f"{s}.h5", "w") as f:
                f["data"] = rng.standard_normal((4, 128, 3)).astype(
                    np.float32)
                f["label"] = rng.integers(0, 5, (4, 1))
    root = str(tmp_path / "log")
    common = ["--cfg", TINY, "--device", "cpu", "mode=modelnetc",
              "dataset.common.size=32", "seed=2", f"root_dir={root}",
              "datatransforms_modelnet_c.val=['PointsToTensor',"
              "'PointCloudCenterAndNormalize']",
              "datatransforms_modelnet_c.kwargs.gravity_dim=1"]
    cli(common + ["epochs=1"])
    run = _run_dir(root)
    name = os.path.basename(run)
    best = os.path.join(run, "checkpoint", f"{name}_ckpt_best.pth")
    root2 = str(tmp_path / "log2")
    common2 = [o if not o.startswith("root_dir") else f"root_dir={root2}"
               for o in common]
    result = cli(common2 + ["test=True", f"pretrained_path={best}",
                            f"modelnet_c_dir={tree}"])
    assert result is None
    run2 = _run_dir(root2)
    report = open(os.path.join(run2, "outcorruption.txt")).read()
    assert report.startswith("epoch: 1")
    assert report.count("'corruption': 'clean'") == 2  # a split, overall
    assert report.count("'level': 'Overall'") == len(CORRUPTIONS)
    assert "mCE" in report and "Epoch 1" not in open(
        os.path.join(run2, "log.txt")).read()
