"""The port's classifier training against the JAX package, on the CPU.

A small PointNeXt-S-shaped classifier (stem + two strided SA stages, width
16, nsample 8; B = 8 clouds of 128 points resampled to 64) carries the same
numpy weights in both packages and sees the same batches, resampling columns
and dropout masks. JAX runs its XLA route (``ADAPTPOINT_TPU_KERNELS=xla``);
the port runs each kernel's plain version. Tolerances are f32 sum-order
tolerances:

- train-mode logits rtol 1e-4 / atol 1e-5; BatchNorm running statistics
  against flax's ``batch_stats`` rtol 1e-5 (atol 1e-6 for entries near 0);
- criterion value and gradient rtol 1e-5 / atol 1e-6;
- one optimizer step: loss and updated parameters rtol 1e-4 / atol 1e-6,
  gradients by name rtol 1e-4 / atol 1e-5 (a first-layer gradient sums
  B*N*K terms of both signs, and carries their f32 noise at a few 1e-6 on
  entries of 1e-2); three steps atol 1e-5. Adam divides each gradient by
  its own size, so where a gradient is as small as its own tolerance the
  update carries that error at full size; the parameter bound therefore adds
  ``_adam_slack``, the first-order effect of the gradient tolerance on the
  update (nothing for ordinary gradients, at most 2 lr);
- schedules and accuracies exact.
"""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import linen as fnn

from adaptpoint_tpu import scheduler as jax_scheduler
from adaptpoint_tpu.engine import cls_trainer as jt
from adaptpoint_tpu.loss import build_criterion_from_cfg as jax_criterion
from adaptpoint_tpu.models import build_model_from_cfg as jax_build
from adaptpoint_tpu.parallel import get_mesh
from adaptpoint_tpu.utils import ConfusionMatrix as JaxConfusionMatrix
from adaptpoint_tpu.utils import EasyConfig as JaxConfig
from adaptpoint_tpu_torch import scheduler as port_scheduler
from adaptpoint_tpu_torch.engine import (TrainState, build_train_tools,
                                         make_eval_step, make_train_step,
                                         train_one_epoch, validate)
from adaptpoint_tpu_torch.loss import build_criterion_from_cfg
from adaptpoint_tpu_torch.models import build_model_from_cfg
from adaptpoint_tpu_torch.models.layers.blocks import BatchNorm, Dropout
from adaptpoint_tpu_torch.optim import (build_optimizer_from_cfg,
                                        clip_by_global_norm_)
from adaptpoint_tpu_torch.utils import ConfusionMatrix, EasyConfig
from adaptpoint_tpu_torch.utils.convert import state_dict_from_jax

B, N, NPOINTS, CLASSES = 8, 128, 64, 5


def _cfg_dict(dropout=0.0, clip=10.0):
    return {
        "num_points": NPOINTS, "num_classes": CLASSES,
        "criterion_args": {"NAME": "SmoothCrossEntropy",
                           "label_smoothing": 0.3},
        "lr": 0.002, "optimizer": {"NAME": "adamw", "weight_decay": 0.05},
        "grad_norm_clip": clip, "sched": "cosine", "epochs": 10,
        "warmup_epochs": 0, "min_lr": 1.0e-4, "t_max": 8,
        "model": {
            "NAME": "BaseCls",
            "encoder_args": {
                "NAME": "PointNextEncoder", "blocks": [1, 1, 1],
                "strides": [1, 2, 2], "width": 16, "in_channels": 4,
                "sa_layers": 2, "sa_use_res": True, "radius": 0.3,
                "radius_scaling": 1.5, "nsample": 8, "expansion": 4,
                "aggr_args": {"feature_type": "dp_fj", "reduction": "max"},
                "group_args": {"NAME": "ballquery", "normalize_dp": True},
                "conv_args": {"order": "conv-norm-act"},
                "act_args": {"act": "relu"}, "norm_args": {"norm": "bn"}},
            "cls_args": {"NAME": "ClsHead", "num_classes": CLASSES,
                         "mlps": [32, 16], "dropout": dropout,
                         "norm_args": {"norm": "bn1d"}}}}


def _as(cls, node):
    """Nested dicts as ``cls`` (an EasyConfig of either package)."""
    if isinstance(node, dict):
        return cls({k: _as(cls, v) for k, v in node.items()})
    return node


def _randomize(variables, seed):
    """Non-trivial BN statistics/affines and Dense biases, as numpy."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = walk(v)
                continue
            v = np.asarray(v, np.float32)
            if k in ("var", "scale"):
                v = (rng.random(v.shape) + 0.5).astype(np.float32)
            elif k in ("mean", "bias"):
                v = (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
            out[k] = v
        return out

    return {c: walk(variables[c]) for c in ("params", "batch_stats")}


def _batch(seed, b=B):
    rng = np.random.default_rng(seed)
    pos = (rng.standard_normal((b, N, 3)) * 0.4).astype(np.float32)
    x = np.concatenate([pos, np.abs(pos[..., 1:2])], -1)
    return {"x": x, "y": rng.integers(0, CLASSES, (b,)).astype(np.int32)}


def _pair(seed, dropout=0.0, clip=10.0):
    """JAX model + numpy variables, the port model carrying the same
    weights, both packages' cfg, and the port's state_dict layout."""
    d = _cfg_dict(dropout, clip)
    jcfg, pcfg = _as(JaxConfig, d), _as(EasyConfig, d)
    jmodel = jax_build(jcfg.model)
    b = _batch(seed)
    variables = jmodel.init(jax.random.PRNGKey(seed),
                            jnp.asarray(b["x"][:2, :, :3]),
                            jnp.asarray(b["x"][:2]), training=False)
    variables = _randomize(variables, seed + 1)
    port = build_model_from_cfg(pcfg.model, device="cpu")
    rows = [[k, list(v.shape)] for k, v in port.state_dict().items()]
    port.load_state_dict(state_dict_from_jax(variables, rows))
    return jmodel, variables, port, jcfg, pcfg, rows


ADAM_EPS = 1e-8


def _adam_slack(grad, lr, rtol, atol):
    """How far an Adam update ``lr * g / (|g| + eps)`` can move when ``g`` is
    only known to ``atol + rtol * |g|``: first order, capped at ``2 lr``."""
    g = np.abs(np.asarray(grad, np.float64))
    delta = atol + rtol * g
    return lr * np.minimum(2.0, ADAM_EPS * delta / (g + ADAM_EPS) ** 2)


def _grads_by_name(grads, variables, rows):
    """JAX parameter gradients under the port's parameter names."""
    zeros = jax.tree_util.tree_map(np.zeros_like, variables["batch_stats"])
    return state_dict_from_jax(
        {"params": jax.tree_util.tree_map(np.asarray, grads),
         "batch_stats": zeros}, rows)


def _assert_state_equal(port, variables, rows, rtol, atol, what=None,
                        slack=None):
    """The port's parameters and BN buffers against the JAX variables carried
    over by ``state_dict_from_jax`` (which folds the head's Dense bias into
    ``running_mean``). ``slack`` adds a per-element bound by name."""
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, variables),
                              rows)
    got = port.state_dict()
    checked = 0
    for key, val in ref.items():
        if key.endswith("num_batches_tracked"):
            continue
        if what is not None and not key.endswith(what):
            continue
        bound = atol + rtol * np.abs(val.numpy())
        if slack is not None and key in slack:
            bound = bound + slack[key]
        err = np.abs(got[key].numpy() - val.numpy())
        assert (err <= bound).all(), (key, float(err.max()),
                                      float((err - bound).max()))
        checked += 1
    assert checked > 0
    return checked


# ---------------------------------------------------------------- (a) forward

def test_train_forward_and_bn_statistics_match_flax():
    jmodel, variables, port, _, _, rows = _pair(0)
    port.train()
    head_bn = port.prediction.head[0].bn
    assert isinstance(head_bn, BatchNorm)
    for step in range(3):
        b = _batch(10 + step)
        pos, x = b["x"][:, :NPOINTS, :3], b["x"][:, :NPOINTS]
        ref, upd = jmodel.apply(variables, jnp.asarray(pos), jnp.asarray(x),
                                training=True, mutable=["batch_stats"])
        variables = {"params": variables["params"],
                     "batch_stats": upd["batch_stats"]}
        got = port(torch.from_numpy(pos.copy()), torch.from_numpy(x.copy()))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=1e-5)
        if step in (0, 2):  # after one and after three steps
            n = _assert_state_equal(port, variables, rows, 1e-5, 1e-6,
                                    what=("running_mean", "running_var"))
            assert n == 2 * 6  # four SA convs and two head blocks
            assert int(head_bn.num_batches_tracked) == step + 1
    # the head's count is B = 8: the unbiased variance would be 8/7 larger
    port.eval()
    before = {k: v.clone() for k, v in port.state_dict().items()}
    port(torch.from_numpy(pos.copy()), torch.from_numpy(x.copy()))
    for k, v in port.state_dict().items():
        assert torch.equal(v, before[k]), k  # eval leaves the buffers alone


def test_batchnorm_keeps_the_biased_variance():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32) * 3)
    bn, ref = BatchNorm(4, momentum=0.1), torch.nn.BatchNorm1d(4, momentum=0.1)
    y, y_ref = bn(x), ref(x)
    torch.testing.assert_close(y, y_ref, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(bn.running_mean, ref.running_mean)
    biased = x.var(dim=0, unbiased=False)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * biased)
    torch.testing.assert_close(ref.running_var, 0.9 + 0.1 * biased * 8 / 7)
    assert list(bn.state_dict()) == list(ref.state_dict())


# ------------------------------------------------------------------- (b) loss

@pytest.mark.parametrize("kwargs", [
    {"NAME": "SmoothCrossEntropy", "label_smoothing": 0.3},
    {"NAME": "SmoothCrossEntropy", "label_smoothing": 0.2, "ignore_index": 2},
    {"NAME": "SmoothCrossEntropy", "label_smoothing": 0.1,
     "weight": [1.0, 0.5, 2.0, 1.5, 0.25]},
    {"NAME": "CrossEntropy"},
])
def test_criterion_value_and_gradient_match_jax(kwargs):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((12, CLASSES)).astype(np.float32) * 2
    labels = rng.integers(0, CLASSES, (12,)).astype(np.int32)
    labels[:3] = 2
    jcrit, pcrit = jax_criterion(dict(kwargs)), build_criterion_from_cfg(
        dict(kwargs))
    ref, ref_g = jax.value_and_grad(lambda z: jcrit(z, jnp.asarray(labels)))(
        jnp.asarray(logits))
    z = torch.from_numpy(logits).requires_grad_()
    got = pcrit(z, torch.from_numpy(labels))
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(ref_g), rtol=1e-5,
                               atol=1e-6)
    per = pcrit.per_sample(z.detach(), torch.from_numpy(labels))
    np.testing.assert_allclose(
        per.numpy(), np.asarray(jcrit.per_sample(jnp.asarray(logits),
                                                 jnp.asarray(labels))),
        rtol=1e-5, atol=1e-6)
    if kwargs.get("ignore_index") is not None:
        assert np.abs(z.grad.numpy()[:3]).max() == 0.0  # ignored rows


# ------------------------------------------------------------- (c) full steps

def _jax_state(jmodel, variables, jcfg):
    criterion, tx, _ = jt.build_train_tools(jcfg, jmodel, variables["params"])
    state = jt.TrainState(params=variables["params"],
                          batch_stats=variables["batch_stats"],
                          opt_state=tx.init(variables["params"]),
                          step=jnp.zeros((), jnp.int32))
    return criterion, tx, state


def _pin_head_bias(params, old_params):
    """``params`` with the head's pre-BatchNorm Dense biases put back to their
    values in ``old_params``. The port has no such parameter (the bias
    cancels in the batch mean). In flax its gradient is rounding noise, about
    1e-9, which Adam divides by its own size: the bias random-walks by up to
    lr a step without touching any train-mode output. The fold of
    ``state_dict_from_jax`` (``mean - bias``) needs the bias the running mean
    was taken with."""
    params = jax.tree_util.tree_map(lambda v: v, params)
    for blk, sub in params["prediction"].items():
        if blk.startswith("LinearBlock"):
            sub["Dense_0"]["bias"] = \
                old_params["prediction"][blk]["Dense_0"]["bias"]
    return params


def _columns(key):
    """The resampling columns the JAX step draws from ``key``."""
    rng_fps = jax.random.split(key, 3)[0]
    return np.asarray(jax.random.choice(rng_fps, NPOINTS, (NPOINTS,),
                                        replace=False)).copy()


def _jax_grads(jmodel, criterion, state, batch, key):
    rng_fps = jax.random.split(key, 3)[0]
    points = jt.resample_points(rng_fps, jnp.asarray(batch["x"]), NPOINTS)

    def loss_fn(params):
        logits, _ = jmodel.apply(
            {"params": params, "batch_stats": state.batch_stats},
            points[..., :3], points, training=True, mutable=["batch_stats"])
        return criterion(logits, jnp.asarray(batch["y"]))

    return jax.grad(loss_fn)(state.params)


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.mark.parametrize("clip_factor", [0.5, 2.0])
def test_one_train_step_matches_jax(clip_factor):
    """``clip_factor`` times the measured gradient norm is the clip: 0.5
    makes the clip scale the gradients, 2.0 leaves them as they are."""
    jmodel, variables, port, jcfg, pcfg, rows = _pair(3)
    batch, key = _batch(20), jax.random.PRNGKey(5)
    criterion, _, state = _jax_state(jmodel, variables, jcfg)
    grads = _jax_grads(jmodel, criterion, state, batch, key)
    norm = float(optax.global_norm(grads))
    clip = clip_factor * norm
    jcfg.grad_norm_clip = pcfg.grad_norm_clip = clip
    criterion, tx, state = _jax_state(jmodel, variables, jcfg)
    jstep = jt.make_train_step(jmodel, tx, criterion, jcfg)
    new_state, ref_loss, ref_preds = jstep(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, key,
        jnp.float32(0.002))

    pcrit, optimizer, _ = build_train_tools(pcfg, port)
    pstep = make_train_step(port, optimizer, pcrit, pcfg)
    pstate = TrainState(port, optimizer)
    pstate, loss, preds = pstep(pstate, _torch_batch(batch),
                                torch.from_numpy(_columns(key)), 0.002)
    assert pstate.step == 1 and loss.dim() == 0 and not loss.requires_grad
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_array_equal(preds.numpy(), np.asarray(ref_preds))

    # gradients by name: the JAX gradients carried over like weights, scaled
    # as the clip scales them
    scale = clip / norm if norm >= clip else 1.0
    ref_grads = _grads_by_name(grads, variables, rows)
    named = dict(port.named_parameters())
    assert set(named) == {k for k in ref_grads
                          if not k.endswith(("running_mean", "running_var",
                                             "num_batches_tracked"))}
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(),
                                   ref_grads[name].numpy() * scale,
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    got_norm = float(torch.linalg.vector_norm(torch.stack(
        [p.grad.norm() for p in named.values()])))
    np.testing.assert_allclose(got_norm, min(norm, clip), rtol=1e-4)

    # every parameter got its update, and the BN buffers theirs
    after = {"params": _pin_head_bias(new_state.params, state.params),
             "batch_stats": new_state.batch_stats}
    slack = {k: _adam_slack(ref_grads[k].numpy() * scale, 0.002, 1e-4, 1e-5)
             for k in named}
    assert np.mean([(v < 1e-6).mean() for v in slack.values()]) > 0.9
    _assert_state_equal(port, after, rows, 1e-4, 1e-6, slack=slack)
    moved = state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, variables), rows)
    for name, p in named.items():
        assert not torch.equal(p.detach(), moved[name]), name
    # the flax head's Dense bias in front of a BatchNorm has no counterpart
    # in the port: it gets a zero gradient and must not have moved
    # in the port: its flax gradient is noise, and Adam moves it by at most lr
    for blk in ("LinearBlock_0", "LinearBlock_1"):
        g = np.asarray(grads["prediction"][blk]["Dense_0"]["bias"])
        assert np.abs(g).max() < 1e-6
        drift = np.asarray(new_state.params["prediction"][blk]["Dense_0"]
                           ["bias"]) - variables["params"]["prediction"][
                               blk]["Dense_0"]["bias"]
        assert np.abs(drift).max() <= 0.002 * 1.001


def test_three_train_steps_match_jax():
    """Three steps on three batches with the schedule's learning rates: the
    Adam moments, the step count and the BN buffers carry over alike. Adam's
    eps is 1e-3 here (1e-8 in the one-step test and the protocol): with the
    small eps an entry whose gradient is itself rounding noise moves by up to
    lr in either package, and three steps later that shows in everything
    downstream of it. The larger eps keeps the update smooth in the
    gradient, so the comparison needs no such allowance."""
    jmodel, variables, port, jcfg, pcfg, rows = _pair(6)
    jcfg.optimizer.eps = pcfg.optimizer.eps = 1e-3
    criterion, tx, state = _jax_state(jmodel, variables, jcfg)
    jstep = jt.make_train_step(jmodel, tx, criterion, jcfg)
    pcrit, optimizer, lr_fn = build_train_tools(pcfg, port)
    assert optimizer.param_groups[0]["eps"] == 1e-3
    pstep = make_train_step(port, optimizer, pcrit, pcfg)
    pstate = TrainState(port, optimizer)
    for i in range(3):
        batch, key = _batch(30 + i), jax.random.PRNGKey(40 + i)
        lr = lr_fn(i)
        state, ref_loss, _ = jstep(
            state, {k: jnp.asarray(v) for k, v in batch.items()}, key,
            jnp.float32(lr))
        state = state.replace(params=_pin_head_bias(state.params,
                                                    variables["params"]))
        pstate, loss, _ = pstep(pstate, _torch_batch(batch),
                                torch.from_numpy(_columns(key)), lr)
        np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-4,
                                   atol=1e-5)
    assert pstate.step == 3 and int(state.step) == 3
    after = {"params": state.params, "batch_stats": state.batch_stats}
    _assert_state_equal(port, after, rows, 1e-4, 1e-5)


def test_clip_by_global_norm_follows_the_optax_rule():
    rng = np.random.default_rng(2)
    grads = [rng.standard_normal(s).astype(np.float32)
             for s in [(4, 3), (7,), (2, 2, 2)]]
    norm = float(np.sqrt(sum((g ** 2).sum() for g in grads)))
    for max_norm in (0.5 * norm, 2.0 * norm):
        tx = optax.clip_by_global_norm(max_norm)
        ref, _ = tx.update([jnp.asarray(g) for g in grads], tx.init(None))
        got = [torch.from_numpy(g.copy()) for g in grads]
        out = clip_by_global_norm_(got, max_norm)
        np.testing.assert_allclose(float(out), norm, rtol=1e-6)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=0)


@pytest.mark.parametrize("name", ["adamw", "adam", "sgd"])
def test_optimizer_update_matches_optax(name):
    from adaptpoint_tpu.optim import build_optimizer_from_cfg as jax_optim
    rng = np.random.default_rng(4)
    shapes = {"w": (5, 3), "b": (5,), "k": (2, 3, 1)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    tx = jax_optim({k: jnp.asarray(v) for k, v in params.items()}, lr=0.01,
                   NAME=name, weight_decay=0.05)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = build_optimizer_from_cfg(tp.values(), lr=0.01, NAME=name,
                                   weight_decay=0.05)
    assert [len(g["params"]) for g in opt.param_groups] == [2, 1]
    for step in range(3):
        g = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
        upd, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    for k, p in tp.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_optimizers_of_later_slices_say_so():
    p = [torch.nn.Parameter(torch.zeros(2, 2))]
    with pytest.raises(NotImplementedError, match="not ported"):
        build_optimizer_from_cfg(p, lr=0.1, NAME="lamb")
    with pytest.raises(ValueError):
        build_optimizer_from_cfg(p, lr=0.1, NAME="nonesuch")


# ------------------------------------------------------------- (d) schedules

_SCHEDS = [
    {"sched": "cosine", "t_max": 8, "min_lr": 1e-4},
    {"sched": "cosine", "warmup_epochs": 3},
    {"sched": "step", "decay_epochs": 3, "decay_rate": 0.5},
    {"sched": "multistep", "decay_epochs": [2, 5, 7], "decay_rate": 0.3},
    {"sched": "poly", "decay_rate": 2.0, "warmup_epochs": 2},
    {"sched": "tanh"},
    {"sched": "constant"},
]


@pytest.mark.parametrize("extra", _SCHEDS, ids=lambda e: "-".join(
    f"{k}" for k in e if k != "sched") + e["sched"])
def test_schedules_equal_the_jax_functions(extra):
    d = {"lr": 0.002, "epochs": 10, **extra}
    ref = jax_scheduler.build_scheduler_from_cfg(_as(JaxConfig, d))
    got = port_scheduler.build_scheduler_from_cfg(_as(EasyConfig, d))
    for t in range(0, 13):
        assert got(t) == ref(t), (extra, t)


def test_plateau_scheduler_equals_the_jax_one():
    d = {"lr": 0.01, "epochs": 10, "sched": "plateau", "patience_epochs": 1,
         "decay_rate": 0.5, "warmup_epochs": 2, "min_lr": 1e-3}
    ref = jax_scheduler.build_scheduler_from_cfg(_as(JaxConfig, d))
    got = port_scheduler.build_scheduler_from_cfg(_as(EasyConfig, d))
    assert isinstance(got, port_scheduler.PlateauScheduler)
    for t, metric in enumerate([50, 60, 59, 58, 57, 61, 60, 59, 58, 57, 56]):
        assert got(t) == ref(t), t
        got.record(metric)
        ref.record(metric)
        assert got.state_dict() == ref.state_dict()
    assert got.cur_lr < 0.01


# ------------------------------------------------- (e) metrics and validation

def test_confusion_matrix_equals_the_jax_one():
    rng = np.random.default_rng(5)
    ref, got = JaxConfusionMatrix(CLASSES), ConfusionMatrix(CLASSES)
    for _ in range(3):
        pred = rng.integers(0, CLASSES, (17,))
        true = rng.integers(0, CLASSES - 1, (17,))  # one class never occurs
        ref.update(pred, true)
        got.update(torch.from_numpy(pred), torch.from_numpy(true))
    np.testing.assert_array_equal(got.value.numpy(), ref.value)
    r_macc, r_oa, r_accs = ref.all_acc()
    macc, oa, accs = got.all_acc()
    assert (macc, oa) == (r_macc, r_oa)
    np.testing.assert_array_equal(accs.numpy(), r_accs)
    ref_i, got_i = (JaxConfusionMatrix(CLASSES, ignore_index=-1),
                    ConfusionMatrix(CLASSES, ignore_index=-1))
    true = np.array([0, 1, -1, 2, -1])
    pred = np.array([0, 2, 1, 2, 4])
    ref_i.update(pred, true)
    got_i.update(torch.from_numpy(pred), torch.from_numpy(true))
    np.testing.assert_array_equal(got_i.value.numpy(), ref_i.value)


def _loader():
    """Three eval batches; the last is padded from 3 real rows to 8."""
    out = []
    for i in range(3):
        b = _batch(50 + i)
        b["x"] = b["x"][:, :NPOINTS]
        if i == 2:
            b["x"][3:] = b["x"][:1]
            b["y"][3:] = b["y"][0]
            b["n_valid"] = 3
        out.append(b)
    return out


def test_validate_with_a_padded_last_batch_matches_jax():
    jmodel, variables, port, jcfg, pcfg, _ = _pair(7)
    _, _, state = _jax_state(jmodel, variables, jcfg)
    r_macc, r_oa, r_accs, r_cm = jt.validate(
        jt.make_eval_step(jmodel, jcfg), state, copy.deepcopy(_loader()),
        get_mesh(jax.devices()[:1]), jcfg)
    _, optimizer, _ = build_train_tools(pcfg, port)
    pstate = TrainState(port, optimizer)
    for fused in (False, True):
        macc, oa, accs, cm = validate(make_eval_step(port, pcfg, fused),
                                      pstate, _loader(), pcfg)
        assert int(cm.value.sum()) == 8 + 8 + 3
        if not fused:  # the fused route's bf16 operands may flip a near tie
            np.testing.assert_array_equal(cm.value.numpy(), r_cm.value)
            assert (macc, oa) == (r_macc, r_oa)
            np.testing.assert_array_equal(accs.numpy(), r_accs)
    assert not port.training


def test_train_one_epoch_runs_the_steps_and_counts_every_cloud():
    _, _, port, _, pcfg, _ = _pair(8)
    pcrit, optimizer, lr_fn = build_train_tools(pcfg, port)
    pstep = make_train_step(port, optimizer, pcrit, pcfg)
    pstate = TrainState(port, optimizer)
    loader = [_batch(60 + i) for i in range(3)]
    gen = torch.Generator().manual_seed(0)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    pstate, loss, macc, oa, accs, cm = train_one_epoch(
        pstep, pstate, loader, gen, lr_fn(0), pcfg)
    assert pstate.step == 3 and port.training
    assert int(cm.value.sum()) == 3 * B and accs.shape == (CLASSES,)
    assert np.isfinite(loss) and 0.0 <= oa <= 100.0 and 0.0 <= macc <= 100.0
    assert optimizer.param_groups[0]["lr"] == lr_fn(0)
    assert any(not torch.equal(v, before[k])
               for k, v in port.state_dict().items())
    # the same generator state gives the same epoch
    port2 = copy.deepcopy(port)
    port2.load_state_dict(before)
    _, opt2, _ = build_train_tools(pcfg, port2)
    _, loss2, *_ = train_one_epoch(
        make_train_step(port2, opt2, pcrit, pcfg), TrainState(port2, opt2),
        loader, torch.Generator().manual_seed(0), lr_fn(0), pcfg)
    assert loss2 == loss


# ---------------------------------------------------------------- (f) dropout

def test_dropout_takes_the_mask_scales_kept_units_and_rests_in_eval():
    drop = Dropout(0.25)
    x = torch.arange(1.0, 9.0).reshape(2, 4)
    mask = torch.tensor([[1, 0, 1, 1], [0, 1, 1, 0]])
    drop.train()
    torch.testing.assert_close(drop(x, mask), x * mask / 0.75)
    a = drop(x, generator=torch.Generator().manual_seed(3))
    b = drop(x, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    kept = a != 0
    torch.testing.assert_close(a[kept], (x / 0.75)[kept])
    drop.eval()
    assert drop(x, mask) is x


def test_train_forward_with_the_dropout_mask_read_off_flax():
    """Dropout 0.5 in both packages: flax draws its masks from the step's
    key, the test reads them off the head (what left each Dropout against
    what entered it) and hands them to the port."""
    jmodel, variables, port, _, _, _ = _pair(9, dropout=0.5)
    b = _batch(70)
    pos, x = b["x"][:, :NPOINTS, :3], b["x"][:, :NPOINTS]
    (ref, state) = jmodel.apply(
        variables, jnp.asarray(pos), jnp.asarray(x), training=True,
        rngs={"dropout": jax.random.PRNGKey(11)},
        mutable=["batch_stats", "intermediates"],
        capture_intermediates=lambda m, _: isinstance(
            m, (fnn.Dropout,)) or type(m).__name__ == "NormAct")
    inter = state["intermediates"]["prediction"]
    masks = []
    for blk in ("LinearBlock_0", "LinearBlock_1"):
        entered = np.asarray(inter[blk]["NormAct_0"]["__call__"][0])
        left = np.asarray(inter[blk]["Dropout_0"]["__call__"][0])
        keep = (left != 0) | (entered == 0)  # a zero unit tells nothing
        np.testing.assert_allclose(left[left != 0], (entered * 2)[left != 0],
                                   rtol=1e-6)
        assert 0.2 < (left != 0).mean() < 0.8
        masks.append(torch.from_numpy(keep))
    port.train()
    got = port(torch.from_numpy(pos.copy()), torch.from_numpy(x.copy()),
               dropout_mask=masks)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-5)
    port.eval()
    with torch.no_grad():
        a = port(torch.from_numpy(pos.copy()), torch.from_numpy(x.copy()),
                 dropout_mask=masks)
        b2 = port(torch.from_numpy(pos.copy()), torch.from_numpy(x.copy()))
    assert torch.equal(a, b2)
