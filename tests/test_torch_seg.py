"""The port's scene-segmentation model pieces against the JAX package, on the
CPU (``JAX_PLATFORMS=cpu``, ``ADAPTPOINT_TPU_KERNELS=xla``).

- ``LocalAggregation`` and ``InvResMLP`` (PointNeXt-B/L/XL's depth blocks),
  the encoder with depth blocks and ``BaseSeg`` with ``PointNextDecoder``
  over a stride-1 head: the same numpy weights and inputs in both packages,
  carried across by ``state_dict_from_jax``. JAX runs its XLA route, the
  port its plain versions. Eval outputs at rtol 1e-4 / atol 2e-5 (the
  part-seg tests' tolerance; the 3-NN weights come from distances the two
  packages sum in other orders). Train-mode forwards (batch statistics;
  ``BaseSeg``'s head dropout mask read off flax): outputs within rtol 1e-4
  plus 1e-4 of the largest output, and no further from a float64 copy of
  the port than JAX's f32 outputs are (plus 1e-5 of the scale); BatchNorm
  running statistics rtol 1e-4 / atol 1e-5.
- The layouts of ``ref_layout_pointnext_b_cls.json`` and
  ``ref_layout_pointnext_xl_s3dis.json``: the port builds exactly those
  names and shapes, and ``state_dict_from_jax`` equals
  ``export_reference_state_dict`` bit for bit on both.
"""
import copy
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from adaptpoint_tpu.models import build_model_from_cfg as jax_build
from adaptpoint_tpu.models.backbone.pointnext import (
    InvResMLP as JaxInvResMLP, LocalAggregation as JaxLocalAggregation)
from adaptpoint_tpu.utils import EasyConfig as JaxConfig
from adaptpoint_tpu.utils.torch_convert import export_reference_state_dict
from adaptpoint_tpu_torch.models import build_model_from_cfg
from adaptpoint_tpu_torch.models.backbone.pointnext import (InvResMLP,
                                                           LocalAggregation)
from adaptpoint_tpu_torch.utils import EasyConfig
from adaptpoint_tpu_torch.utils.convert import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import dump_ref_layouts  # noqa: E402  (the layouts' model args)

TOL_FWD = dict(rtol=1e-4, atol=2e-5)
TOL_TRAIN = 1e-4  # rtol, and atol as a share of the largest output
TOL_BN = (1e-4, 1e-5)
GROUP = {"NAME": "ballquery", "normalize_dp": True}
NORM, ACT = {"norm": "bn"}, {"act": "relu"}

# the S3DIS cfgs' model cut to size: blocks [1, 2, 2], strides [1, 4, 4],
# width 16, K = 8, N = 512 (stages of 512, 128 and 32 points)
SMALL_SEG = {
    "NAME": "BaseSeg",
    "encoder_args": {
        "NAME": "PointNextEncoder", "blocks": [1, 2, 2], "strides": [1, 4, 4],
        "width": 16, "in_channels": 4, "sa_layers": 1, "sa_use_res": False,
        "radius": 0.2, "nsample": 8, "expansion": 4,
        "aggr_args": {"feature_type": "dp_fj", "reduction": "max"},
        "group_args": GROUP, "conv_args": {"order": "conv-norm-act"},
        "act_args": ACT, "norm_args": NORM},
    "decoder_args": {"NAME": "PointNextDecoder"},
    "cls_args": {"NAME": "SegHead", "num_classes": 13, "in_channels": None,
                 "norm_args": NORM}}
N_SMALL = 512


def small_seg_cfg(**enc):
    cfg = json.loads(json.dumps(SMALL_SEG))
    cfg["encoder_args"].update(enc)
    return cfg


def randomize(variables, seed):
    """Non-trivial BN statistics, affines and biases, as numpy."""
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


def scene_inputs(seed, b, n):
    """Points in a 1.2 x 1.2 x 0.9 box (a room crop's scale at the cut
    radii), features [rgb in 0..1 || height]."""
    rng = np.random.default_rng(seed)
    pos = (rng.random((b, n, 3)) * [1.2, 1.2, 0.9]).astype(np.float32)
    rgb = rng.random((b, n, 3)).astype(np.float32)
    return pos, np.concatenate([rgb, pos[..., 2:3]], -1)


def as_cfg(cls, node):
    if isinstance(node, dict):
        return cls({k: as_cfg(cls, v) for k, v in node.items()})
    return node


def seg_pair(cfg, n, seed, b=2):
    """A JAX model + numpy variables and the port model with the same
    weights, with inputs."""
    jmodel = jax_build(as_cfg(JaxConfig, cfg))
    pos, x = scene_inputs(seed, b, n)
    variables = randomize(jmodel.init(
        jax.random.PRNGKey(seed), jnp.asarray(pos), jnp.asarray(x),
        training=False), seed + 1)
    port = build_model_from_cfg(as_cfg(EasyConfig, cfg), device="cpu")
    rows = [[k, list(v.shape)] for k, v in port.state_dict().items()]
    port.load_state_dict(state_dict_from_jax(variables, rows))
    return jmodel, variables, port, rows, (pos, x)


def module_state_dict(port: torch.nn.Module, variables, prefix: str):
    """A bare module's state_dict from the JAX module's variables, by the
    converter's rules under a model-level prefix."""
    rows = [[prefix + k, list(v.shape)] for k, v in
            port.state_dict().items()]
    sd = state_dict_from_jax(variables, rows)
    return {k[len(prefix):]: v for k, v in sd.items()}


def nest(variables, path):
    """``variables`` of a bare JAX module as they would sit at ``path``
    inside a model."""
    out = {}
    for c in ("params", "batch_stats"):
        tree = variables[c]
        for part in reversed(path.split("/")):
            tree = {part: tree}
        out[c] = tree
    return out


def check_train(got, ref, exact):
    """Train-mode outputs: within TOL_TRAIN of JAX's and no further from the
    port's float64 run than JAX's f32 outputs are."""
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=TOL_TRAIN,
                               atol=TOL_TRAIN * scale)
    assert np.abs(got - exact).max() <= np.abs(ref - exact).max() \
        + 1e-5 * scale


def check_bn(port, want_rows_sd):
    checked = 0
    for k, v in port.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), want_rows_sd[k].numpy(),
                                       rtol=TOL_BN[0], atol=TOL_BN[1],
                                       err_msg=k)
            checked += 1
    assert checked


# ------------------------------------------------------------- the blocks

@pytest.mark.parametrize("reduction", ["max", "mean"])
def test_local_aggregation_matches_jax(reduction):
    """Query = support through ``ops.ball_group`` (identity query indices):
    eval and train forwards and the BatchNorm statistics."""
    b, n, c = 2, 256, 16
    pos, x = scene_inputs(21, b, n)
    f = np.random.default_rng(22).standard_normal((b, n, c)).astype(
        np.float32)
    group = dict(GROUP, radius=0.25, nsample=8)
    jla = JaxLocalAggregation(channels=[c, c], norm_args=NORM, act_args=ACT,
                              group_args=group, reduction=reduction)
    args = [jnp.asarray(pos), jnp.asarray(f)]
    variables = randomize(jla.init(jax.random.PRNGKey(0), *args), 23)
    port = LocalAggregation([c, c], norm_args=NORM, act_args=ACT,
                            group_args=group, reduction=reduction)
    prefix, path = "encoder.encoder.1.1.convs.", \
        "encoder/enc1_b1/LocalAggregation_0"
    port.load_state_dict(module_state_dict(port, nest(variables, path),
                                           prefix))
    assert port.convs[0].conv.weight.shape == (c, c + 3, 1, 1)
    tp, tf = torch.from_numpy(pos), torch.from_numpy(f)
    port.eval()
    with torch.no_grad():
        got = port(tp, tf).numpy()
    ref = np.asarray(jla.apply(variables, *args))
    assert got.shape == (b, n, c)
    np.testing.assert_allclose(got, ref, **TOL_FWD)
    f64 = copy.deepcopy(port).double().train()
    port.train()
    ref, upd = jla.apply(variables, *args, training=True,
                         mutable=["batch_stats"])
    got = port(tp, tf).detach().numpy()
    check_train(got, np.asarray(ref),
                f64(tp.double(), tf.double()).detach().numpy())
    check_bn(port, module_state_dict(port, nest(
        {"params": variables["params"], "batch_stats": upd["batch_stats"]},
        path), prefix))


@pytest.mark.parametrize("expansion,use_res", [(4, True), (2, False)])
def test_invresmlp_matches_jax(expansion, use_res):
    """LocalAggregation, the inverted bottleneck ``c -> c * expansion ->
    c``, the residual and the activation; the points pass through."""
    b, n, c = 2, 256, 16
    pos, _ = scene_inputs(31, b, n)
    f = np.random.default_rng(32).standard_normal((b, n, c)).astype(
        np.float32)
    group = dict(GROUP, radius=0.25, nsample=8)
    kw = dict(norm_args=NORM, act_args=ACT, group_args=group,
              expansion=expansion, use_res=use_res,
              aggr_args={"feature_type": "dp_fj", "reduction": "max"})
    jblk = JaxInvResMLP(in_channels=c, **kw)
    args = [jnp.asarray(pos), jnp.asarray(f)]
    variables = randomize(jblk.init(jax.random.PRNGKey(1), *args), 33)
    port = InvResMLP(c, **kw)
    prefix, path = "encoder.encoder.2.1.", "encoder/enc2_b1"
    port.load_state_dict(module_state_dict(port, nest(variables, path),
                                           prefix))
    assert [k for k in port.state_dict()][:1] == ["convs.convs.0.0.weight"]
    assert port.pwconv[0].conv.weight.shape == (c * expansion, c, 1)
    tp, tf = torch.from_numpy(pos), torch.from_numpy(f)
    port.eval()
    with torch.no_grad():
        p_out, got = port(tp, tf)
    assert p_out is tp
    _, ref = jblk.apply(variables, *args)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL_FWD)
    f64 = copy.deepcopy(port).double().train()
    port.train()
    (_, ref), upd = jblk.apply(variables, *args, training=True,
                               mutable=["batch_stats"])
    got = port(tp, tf)[1].detach().numpy()
    check_train(got, np.asarray(ref),
                f64(tp.double(), tf.double())[1].detach().numpy())
    check_bn(port, module_state_dict(port, nest(
        {"params": variables["params"], "batch_stats": upd["batch_stats"]},
        path), prefix))


@pytest.mark.parametrize("blocks", [[1, 2, 2], [1, 3, 1]])
def test_encoder_with_depth_blocks_matches_jax(blocks):
    """The encoder's every level (``forward_seg_feat``), eval and train,
    with the per-block radii of ``_to_full_list`` (0.2, then 0.4 at the
    second stage's blocks: radius_scaling 2)."""
    cfg = small_seg_cfg(blocks=blocks)
    enc_cfg = dict(cfg["encoder_args"])
    jenc = jax_build(as_cfg(JaxConfig, enc_cfg))
    pos, x = scene_inputs(41, 2, N_SMALL)
    args = [jnp.asarray(pos), jnp.asarray(x)]
    variables = randomize(jenc.init(jax.random.PRNGKey(2), *args), 42)
    port = build_model_from_cfg(as_cfg(EasyConfig, enc_cfg), device="cpu")
    rows = [["encoder." + k, list(v.shape)] for k, v in
            port.state_dict().items()]
    sd = state_dict_from_jax({c: {"encoder": variables[c]}
                              for c in variables}, rows)
    port.load_state_dict({k[len("encoder."):]: v for k, v in sd.items()})
    radii = [[blk.convs.group_args["radius"] for blk in stage[1:]]
             for stage in port.encoder]
    assert radii[1] == [0.4] * (blocks[1] - 1)
    tp, tx = torch.from_numpy(pos), torch.from_numpy(x)
    port.eval()
    with torch.no_grad():
        ps, fs = port.forward_seg_feat(tp, tx)
    jps, jfs = jenc.apply(variables, *args, method=jenc.forward_seg_feat)
    assert [tuple(f.shape) for f in fs] == [tuple(f.shape) for f in jfs]
    for a, r in zip(ps, jps):
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))
    for a, r in zip(fs, jfs):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **TOL_FWD)
    f64 = copy.deepcopy(port).double().train()
    port.train()
    (_, jfs), _ = jenc.apply(variables, *args, training=True,
                             method=jenc.forward_seg_feat,
                             mutable=["batch_stats"])
    _, fs = port.forward_seg_feat(tp, tx)
    _, fs64 = f64.forward_seg_feat(tp.double(), tx.double())
    for a, r, e in zip(fs[2:], jfs[2:], fs64[2:]):
        check_train(a.detach().numpy(), np.asarray(r), e.detach().numpy())


@pytest.mark.parametrize("blocks", [[1, 2, 2], [1, 1, 1]])
def test_base_seg_matches_jax(blocks):
    """``BaseSeg`` (encoder with a stride-1 head, ``PointNextDecoder``,
    ``SegHead`` with ``in_channels: null``): eval logits; then the train
    forward with the head's dropout mask read off flax and the BatchNorm
    statistics it leaves."""
    cfg = small_seg_cfg(blocks=blocks)
    jmodel, variables, port, rows, (pos, x) = seg_pair(cfg, N_SMALL, 51)
    args = [jnp.asarray(pos), jnp.asarray(x)]
    targs = [torch.from_numpy(pos), torch.from_numpy(x)]
    port.eval()
    with torch.no_grad():
        got = port(*targs).numpy()
    ref = np.asarray(jmodel.apply(variables, *args, training=False))
    assert got.shape == ref.shape == (2, N_SMALL, 13)
    np.testing.assert_allclose(got, ref, **TOL_FWD)

    ref, state = jmodel.apply(
        variables, *args, training=True,
        rngs={"dropout": jax.random.PRNGKey(5)},
        mutable=["batch_stats", "intermediates"],
        capture_intermediates=lambda m, _: isinstance(m, fnn.Dropout)
        or type(m).__name__ == "ConvBlock")
    inter = state["intermediates"]["head"]
    entered = np.asarray(inter["ConvBlock_0"]["__call__"][0])
    left = np.asarray(inter["Dropout_0"]["__call__"][0])
    np.testing.assert_allclose(left[left != 0], (entered * 2)[left != 0],
                               rtol=1e-6)
    keep = torch.from_numpy((left != 0) | (entered == 0))
    f64 = copy.deepcopy(port).double().train()
    port.train()
    got = port(*targs, dropout_mask=keep).detach().numpy()
    exact = f64(targs[0].double(), targs[1].double(),
                dropout_mask=keep).detach().numpy()
    check_train(got, np.asarray(ref), exact)
    check_bn(port, state_dict_from_jax(
        {"params": variables["params"], "batch_stats": state["batch_stats"]},
        rows))


# ------------------------------------------------------------ the layouts

@pytest.mark.parametrize("name", ["pointnext_b_cls", "pointnext_xl_s3dis"])
def test_layout_matches_reference(name):
    spec = json.loads(json.dumps(dump_ref_layouts.SPECS[name]))
    model = build_model_from_cfg(EasyConfig(spec), device="cpu", seed=0)
    rows = json.load(open(os.path.join(REPO, "tests", "fixtures",
                                       f"ref_layout_{name}.json")))
    assert [[k, list(v.shape)] for k, v in model.state_dict().items()] == rows


def test_s3dis_pointnext_b_builds_at_published_width():
    """``cfgs/s3dis/pointnext-b.yaml``: width 32, blocks [1, 2, 3, 2, 2],
    13 classes; one InvResMLP at stage 1, two at stage 2, one each at 3
    and 4, radii doubling per stage."""
    cfg = EasyConfig()
    cfg.load(os.path.join(REPO, "cfgs/s3dis/pointnext-b.yaml"),
             recursive=True)
    model = build_model_from_cfg(cfg.model, device="cpu", seed=0)
    enc = model.encoder
    assert enc.channel_list == [32, 64, 128, 256, 512]
    assert [len(s) - 1 for s in enc.encoder] == [0, 1, 2, 1, 1]
    assert [s[0].group_args.get("radius") for s in enc.encoder[1:]] == [
        0.1, 0.2, 0.4, 0.8]
    assert [[b.convs.group_args["radius"] for b in s[1:]]
            for s in enc.encoder[1:]] == [[0.2], [0.4, 0.4], [0.8], [1.6]]
    assert model.head.head[-1].conv.out_channels == 13
    n = sum(p.numel() for p in model.parameters())
    assert 3.5e6 < n < 4.0e6, n


@pytest.mark.parametrize("name", ["pointnext_b_cls", "pointnext_xl_s3dis"])
def test_state_dict_from_jax_equals_export_reference(name):
    spec = json.loads(json.dumps(dump_ref_layouts.SPECS[name]))
    jmodel = jax_build(as_cfg(JaxConfig, spec))
    pos, x = scene_inputs(61, 2, 256)
    variables = randomize(jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(pos), jnp.asarray(x),
        training=False), 62)
    rows = json.load(open(os.path.join(REPO, "tests", "fixtures",
                                       f"ref_layout_{name}.json")))
    ref, _ = export_reference_state_dict(variables, rows)
    got = state_dict_from_jax(variables, rows)
    assert list(got) == [k for k, _ in rows]
    assert any(".pwconv." in k for k in got)
    for k, _ in rows:
        assert np.array_equal(got[k].numpy(), np.asarray(ref[k])), k
        assert got[k].numpy().dtype == np.asarray(ref[k]).dtype, k
    port = build_model_from_cfg(EasyConfig(spec), device="cpu")
    port.load_state_dict(got)


def test_local_aggregation_takes_the_ball_query_only():
    """The ball query is the port's one grouper (``create_grouper``): any
    other grouper is refused when the block is built."""
    with pytest.raises(ValueError, match="not ported"):
        LocalAggregation([16, 16], group_args={"NAME": "knn", "nsample": 8})
    blk = InvResMLP(16, group_args=dict(GROUP, radius=0.2, nsample=8))
    assert blk.convs.group_args["NAME"] == "ballquery"
