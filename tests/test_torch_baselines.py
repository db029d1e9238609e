"""The corruption protocols' baseline classifiers of the port against the JAX
package, on the CPU: DGCNN (the mCE normaliser), BallDGCNN, PointNet++,
PointNet and PointMLP.

- ``state_dict_from_jax`` equals the JAX package's
  ``export_reference_state_dict`` bit for bit on the five reference layouts
  (``tests/fixtures/ref_layout_{dgcnn,balldgcnn,pointnet2,pointnet,
  pointmlp}_cls.json``) at the cfgs' full widths, and the port's models
  built from ``cfgs/scanobjectnn/{dgcnn,pointnet++,pointnet,pointmlp}.yaml``
  hold exactly those layouts' keys and shapes;
- each encoder and its ``BaseCls`` at a small size (DGCNN channels 16,
  embed 64, 4 blocks, k 8, N 128; PointMLP embed 16, k 8, two stages) carry the same
  numpy weights as the JAX modules and see the same numpy clouds: eval
  logits and features rtol 1e-4 / atol 1e-5, training-mode BatchNorm
  (batch statistics, running statistics after the forward) rtol 1e-4 /
  atol 1e-4 on the logits and 1e-4 / 1e-5 on the running statistics (a
  tenth of each batch statistic, which carries the f32 noise of the
  layers before it: 2e-6 on a head mean of 1e-2 in BallDGCNN): f32 sums
  in another order;
- DGCNN's feature-space graphs are discrete choices on features the two
  packages round differently: the port records its graphs
  (``dgcnn.graph_tape``) and the JAX model takes them through its
  ``knn_point``, so both run on one graph; on equal inputs each kNN call's
  indices are exact (``knn_idx_plain`` against JAX's ``knn_point``, past
  the staged kernel's 894 points at C = 64, duplicates included); without
  sharing, the share of rows whose neighbours agree is reported and held
  above 0.99;
- the self-contained ``PointMLP`` against the JAX ``PointMLP``.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import adaptpoint_tpu.models.backbone.dgcnn as jax_dgcnn
from adaptpoint_tpu.models import build_model_from_cfg as jax_build
from adaptpoint_tpu.ops import geometry as jgeo
from adaptpoint_tpu.utils import EasyConfig as JaxConfig
from adaptpoint_tpu.utils.torch_convert import export_reference_state_dict
from adaptpoint_tpu_torch.models import build_model_from_cfg
from adaptpoint_tpu_torch.models.backbone.dgcnn import graph_tape
from adaptpoint_tpu_torch.ops import knn
from adaptpoint_tpu_torch.utils import EasyConfig
from adaptpoint_tpu_torch.utils.convert import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
B, N = 4, 128

DGCNN = {"NAME": "DGCNN", "in_channels": 4, "channels": 16, "embed_dim": 64,
         "n_blocks": 4, "k": 8, "norm_args": {"norm": "bn"},
         "act_args": {"act": "leakyrelu", "negative_slope": 0.2},
         "conv_args": {"order": "conv-norm-act"}}
BALL = {"NAME": "BallDGCNN", "in_channels": 4, "channels": 16,
        "embed_dim": 32, "n_blocks": 4, "k": 8, "radius": 0.4}
PN2 = {"NAME": "PointNet2Encoder", "in_channels": 4,
       "mlps": [[[16, 16, 32]], [[32, 32, 64]], [[64, 64, 128]]],
       "radius": [0.2, 0.4, None], "num_samples": [8, 16, None],
       "strides": [4, 4, 1], "aggr_args": {"feature_type": "dp_fj",
                                           "reduction": "max"},
       "group_args": {"NAME": "ballquery"}, "norm_args": {"norm": "bn"},
       "act_args": {"act": "relu"}, "conv_args": {"order": "conv-norm-act"}}
PNET = {"NAME": "PointNetEncoder", "in_channels": 4, "input_transform": True,
        "feature_transform": True}
PMLP = {"NAME": "PointMLPEncoder", "in_channels": 4, "embed_dim": 16,
        "res_expansion": 1.0, "dim_expansion": [2, 2],
        "pre_blocks": [1, 2], "pos_blocks": [2, 1], "k_neighbors": [8, 8],
        "reducers": [2, 4]}
ENCODERS = {"dgcnn": DGCNN, "balldgcnn": BALL, "pointnet2": PN2,
            "pointnet": PNET, "pointmlp": PMLP}


def _as(cls, node):
    if isinstance(node, dict):
        return cls({k: _as(cls, v) for k, v in node.items()})
    return node


def _cloud(seed, b=B, n=N):
    rng = np.random.default_rng(seed)
    pos = (rng.standard_normal((b, n, 3)) * 0.4).astype(np.float32)
    return pos, np.concatenate([pos, np.abs(pos[..., 1:2])], -1)


def _randomize(tree, rng):
    """Non-trivial BN affines and statistics, biases and affine params."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _randomize(v, rng)
            continue
        v = np.asarray(v, np.float32)
        if k in ("var", "scale", "affine_alpha"):
            v = (rng.random(v.shape) + 0.5).astype(np.float32)
        elif k in ("mean", "bias", "affine_beta"):
            v = (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
        elif k == "kernel" and not np.any(v):  # the T-Nets' zero start
            v = (rng.standard_normal(v.shape) * 0.01).astype(np.float32)
        out[k] = v
    return out


def _cls_cfg(encoder, classes=5, dropout=0.0):
    return {"NAME": "BaseCls", "encoder_args": dict(encoder),
            "cls_args": {"NAME": "ClsHead", "num_classes": classes,
                         "mlps": [32, 16], "dropout": dropout,
                         "norm_args": {"norm": "bn1d"}}}


def _jax_knn_from(graphs):
    """A stand-in for JAX DGCNN's ``knn_point`` that hands back the port's
    recorded graphs in call order (cycling), as constants."""
    calls = [0]

    def knn_point(k, x, q):
        idx = graphs[calls[0] % len(graphs)]
        calls[0] += 1
        return None, jnp.asarray(idx.numpy())
    return knn_point


def _pair(cfg, seed):
    """(JAX module, numpy variables, port model with the same weights)."""
    jmodel = jax_build(_as(JaxConfig, cfg))
    pos, x = _cloud(seed, b=2)
    init = jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(pos),
                       jnp.asarray(x), training=False)
    rng = np.random.default_rng(seed + 1)
    variables = {c: _randomize(jax.tree_util.tree_map(np.asarray, init[c]),
                               rng) for c in ("params", "batch_stats")}
    port = build_model_from_cfg(_as(EasyConfig, cfg), device="cpu")
    rows = [[k, list(v.shape)] for k, v in port.state_dict().items()]
    port.load_state_dict(state_dict_from_jax(variables, rows))
    return jmodel, variables, port


def _run(jmodel, variables, port, pos, x, training, monkeypatch):
    """Both forwards on one graph: the port's first, recording its kNN
    graphs, then JAX's on them. Returns (port out, JAX out, JAX stats)."""
    port.train(training)
    with graph_tape(port) as tape:
        got = port(torch.from_numpy(pos), torch.from_numpy(x))
    monkeypatch.setattr(jax_dgcnn, "knn_point", _jax_knn_from(tape.graphs))
    if training:
        ref, upd = jmodel.apply(variables, jnp.asarray(pos), jnp.asarray(x),
                                training=True, mutable=["batch_stats"])
        return got, np.asarray(ref), upd["batch_stats"]
    ref = jmodel.apply(variables, jnp.asarray(pos), jnp.asarray(x),
                       training=False)
    return got, np.asarray(ref), None


# ---------------------------------------------------------------- converter

SONN = {"dgcnn": "dgcnn.yaml", "pointnet2": "pointnet++.yaml",
        "pointnet": "pointnet.yaml", "pointmlp": "pointmlp.yaml"}


@pytest.mark.parametrize("name", ["dgcnn", "balldgcnn", "pointnet2",
                                  "pointnet", "pointmlp"])
def test_converter_equals_the_jax_export_at_full_width(name):
    """The JAX model at the cfg's full width (BallDGCNN at the layout's
    own), its variables random: the port's conversion equals the JAX
    package's export bit for bit, and the port's model holds the layout."""
    rows = json.load(open(os.path.join(FIXTURES,
                                       f"ref_layout_{name}_cls.json")))
    if name == "balldgcnn":
        model = _cls_cfg(BALL, classes=15)
        model["cls_args"] = {"NAME": "ClsHead", "num_classes": 15,
                             "mlps": [64], "norm_args": {"norm": "bn1d"}}
    else:
        cfg = EasyConfig()
        cfg.load(os.path.join(REPO, "cfgs", "scanobjectnn", SONN[name]),
                 recursive=True)
        model = json.loads(json.dumps(cfg.model))
    jmodel = jax_build(_as(JaxConfig, model))
    pos, x = _cloud(1, b=2, n=64)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(pos), jnp.asarray(x),
        training=False))
    rng = np.random.default_rng(7)
    variables = {c: jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes[c])
        for c in ("params", "batch_stats")}
    ref, report = export_reference_state_dict(variables, rows)
    got = state_dict_from_jax(variables, rows)
    assert list(got) == [k for k, _ in rows]
    for key, val in ref.items():
        assert got[key].dtype == (torch.int64 if key.endswith(
            "num_batches_tracked") else torch.float32), key
        np.testing.assert_array_equal(got[key].numpy(), val, err_msg=key)
    port = build_model_from_cfg(_as(EasyConfig, model), device="cpu")
    assert {k: list(v.shape) for k, v in port.state_dict().items()} == \
        {k: list(s) for k, s in rows}
    port.load_state_dict(got)


# ----------------------------------------------------------------- encoders

@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", list(ENCODERS))
def test_classifier_matches_jax(name, training, monkeypatch):
    """BaseCls over each encoder: logits, and in training the BatchNorms'
    running statistics after the forward."""
    jmodel, variables, port = _pair(_cls_cfg(ENCODERS[name]), 3)
    pos, x = _cloud(11)
    got, ref, stats = _run(jmodel, variables, port, pos, x, training,
                           monkeypatch)
    tol = (1e-4, 1e-4) if training else (1e-4, 1e-5)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=tol[0],
                               atol=tol[1])
    if training:
        rows = [[k, list(v.shape)] for k, v in port.state_dict().items()]
        want = state_dict_from_jax({"params": variables["params"],
                                    "batch_stats": jax.tree_util.tree_map(
                                        np.asarray, stats)}, rows)
        have = port.state_dict()
        n = 0
        for key, val in want.items():
            if key.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(have[key].numpy(), val.numpy(),
                                           rtol=1e-4, atol=1e-5,
                                           err_msg=key)
                n += 1
        assert n > 0


@pytest.mark.parametrize("name", list(ENCODERS))
def test_encoder_features_match_jax(name, monkeypatch):
    """The encoder alone: the global feature in eval."""
    jmodel, variables, port = _pair(_cls_cfg(ENCODERS[name]), 5)
    pos, x = _cloud(13)
    port.eval()
    with graph_tape(port) as tape:
        got = port.encoder.forward_cls_feat(torch.from_numpy(pos),
                                            torch.from_numpy(x))
    monkeypatch.setattr(jax_dgcnn, "knn_point", _jax_knn_from(tape.graphs))
    ref = jmodel.apply(variables, jnp.asarray(pos), jnp.asarray(x),
                       method=lambda m, p, f: m.encoder.forward_cls_feat(
                           p, f, training=False))
    assert got.shape == ref.shape == (B, port.encoder.out_channels)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-5)
    if name == "dgcnn":
        assert len(tape.graphs) == 3  # the xyz graph and two in features


def test_dgcnn_graphs_agree_without_sharing():
    """Each package computes its own graphs: the port's graphs on the JAX
    model's own features (recovered by running JAX's forward on the
    port's recorded graphs would hide the difference, so the JAX graphs
    are taken by a recording stand-in around its own kNN). The share of
    rows whose k neighbours agree, set for set, is reported; the xyz graph
    agrees exactly."""
    jmodel, variables, port = _pair(_cls_cfg(DGCNN), 3)
    pos, x = _cloud(11)
    port.eval()
    with graph_tape(port) as tape:
        port(torch.from_numpy(pos), torch.from_numpy(x))
    seen = []
    own = jgeo.knn_point

    def recording(k, a, q):
        d2, idx = own(k, a, q)
        seen.append(np.asarray(idx))
        return d2, idx
    orig = jax_dgcnn.knn_point
    jax_dgcnn.knn_point = recording
    try:
        jmodel.apply(variables, jnp.asarray(pos), jnp.asarray(x),
                     training=False)
    finally:
        jax_dgcnn.knn_point = orig
    assert len(seen) == len(tape.graphs) == 3
    np.testing.assert_array_equal(tape.graphs[0].numpy(), seen[0])
    shares = []
    for mine, theirs in zip(tape.graphs[1:], seen[1:]):
        same = np.sort(mine.numpy(), -1) == np.sort(theirs, -1)
        shares.append(float(same.all(-1).mean()))
    print("rows with the same neighbours, blocks 1-2:", shares)
    assert min(shares) > 0.99


def test_pointmlp_classifier_matches_jax():
    """The self-contained PointMLP (its own 512-256 head, dropout 0.5, in
    eval) against the JAX module, the head's flax names (fc1, fc2, cls)
    carried over as the port's ClsHead."""
    cfg = dict(PMLP, NAME="PointMLP", num_classes=7)
    jmodel = jax_build(_as(JaxConfig, cfg))
    pos, x = _cloud(17)
    init = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(pos),
                       jnp.asarray(x), training=False)
    variables = {c: _randomize(jax.tree_util.tree_map(np.asarray, init[c]),
                               np.random.default_rng(19))
                 for c in ("params", "batch_stats")}
    renamed = {}
    for c, tree in variables.items():
        t = dict(tree)
        t["prediction"] = {"LinearBlock_0": t.pop("fc1"),
                           "LinearBlock_1": t.pop("fc2")}
        if "cls" in t:
            t["prediction"]["Dense_0"] = t.pop("cls")
        renamed[c] = t
    port = build_model_from_cfg(_as(EasyConfig, cfg), device="cpu").eval()
    rows = [[k, list(v.shape)] for k, v in port.state_dict().items()]
    port.load_state_dict(state_dict_from_jax(renamed, rows))
    ref = jmodel.apply(variables, jnp.asarray(pos), jnp.asarray(x),
                       training=False)
    got = port(torch.from_numpy(pos), torch.from_numpy(x))
    assert got.shape == (B, 7)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------- kNN calls

@pytest.mark.parametrize("k,n,c,kind", [(20, 1024, 64, "random"),
                                        (20, 1000, 64, "twice"),
                                        (8, 460, 128, "random"),
                                        (32, 1700, 35, "twice")])
def test_knn_plain_matches_jax_past_the_staged_kernel(k, n, c, kind):
    """Past knn_max_points(C) (894 at C = 64, 450 at C = 128), where the
    tiled instance takes the call on the card: the plain version the card
    is held to equals JAX's knn_point index for index, the lower index first
    among equal points."""
    assert n > knn.knn_max_points(c)
    assert knn.knn_variant(k, n, c).kind == "tiled"
    rng = np.random.default_rng(n + c)
    if kind == "twice":
        half = rng.standard_normal((2, n // 2, c)).astype(np.float32)
        x = np.concatenate([half, half], axis=1)
        x[:, ::5] = 0.0
    else:
        x = rng.standard_normal((2, n, c)).astype(np.float32)
    q = np.concatenate([x[:, :40], rng.standard_normal((2, 9, c)).astype(
        np.float32)], axis=1)
    _, ref = jgeo.knn_point(k, jnp.asarray(x), jnp.asarray(q))
    got = knn.knn_idx_plain(k, torch.from_numpy(x), torch.from_numpy(q))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("c", [3, 64, 128, 256])
def test_knn_chooser_edges(c):
    """At knn_max_points(C) the support is staged whole; one point more
    takes the tiled instance, whose list is MAX_K long whatever k and N;
    tiny supports (k > N) stay staged. The tiled plan fits two blocks an
    SM at every C, so the chooser takes C past 1416 (the ceiling of the
    tiled instance's first draft) and refuses only past the launcher's
    int."""
    top = knn.knn_max_points(c)
    at, past = knn.knn_variant(20, top, c), knn.knn_variant(20, top + 1, c)
    assert at.kind == "warp" and past == ("tiled", knn.MAX_K)
    assert knn.knn_variant(20, 5, c).kind == "warp"
    plan = knn.knn_tiled_plan()  # the same at every C
    assert (plan.queries, plan.points, plan.chunk) == (64, 64, 64)
    assert plan.smem_bytes <= 115712  # two blocks an SM
    for wide in (1417, 4 * c + 1500):
        assert knn.knn_variant(20, top + 1, wide) == ("tiled", knn.MAX_K)
    assert knn.TILED_MAX_CHANNELS == 2 ** 31 - 1
    with pytest.raises(ValueError):
        knn.knn_variant(20, top + 1, knn.TILED_MAX_CHANNELS + 1)
