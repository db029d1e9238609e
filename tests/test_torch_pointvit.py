"""PointViT's modules in the port against the JAX package's
``adaptpoint_tpu/models/backbone/pointvit.py`` and ``models/layers/
kmeans.py``, on the CPU (``ADAPTPOINT_TPU_KERNELS=xla``: the JAX package's
XLA route; the port's plain versions).

The same numpy weights (random, BatchNorm statistics and affines too) and
the same seeded numpy clouds go through both packages: ``Attention`` and
``TransformerBlock`` (with and without ``qkv_bias``, dropout in training with
the keep-masks read off flax), ``PointPatchEmbed`` for every
``feature_type``, each of the ``in2d`` / ``bn`` / ``ln`` norms (``bn`` in
eval and training), ``num_groups = 0`` and ball grouping, ``PointViT`` for
every ``global_feat``, ``distill`` (the distillation token's feature in
training), ``forward_seg_feat`` and ``BaseCls`` in training with dropout in
the encoder and the head, the decoders with both samplers (and the global
read-outs, and the part decoder's class conditioning), ``kmeans`` (the
assignments exact, duplicated points and empty clusters included) and
``KMeansEmbed``, ``ViTGraph`` with both embeddings and features wider than
3, and ``P3Embed`` (its ``stages`` expression too). Tolerances, f32 sums in
another order: features and logits rtol 1e-4 / atol 1e-5 (rtol 1e-4 /
atol 1e-4 behind a training-mode BatchNorm, whose batch statistics carry
the f32 noise of the layers before it), running statistics rtol 1e-4 /
atol 1e-5, index outputs exact (as
``tests/test_torch_baselines.py``); the kNN graphs are not shared: on equal
centers both packages pick the same neighbours.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from adaptpoint_tpu.models import build_model_from_cfg as jax_build
from adaptpoint_tpu.models.backbone import pointvit as jv
from adaptpoint_tpu.models.layers.kmeans import kmeans as jax_kmeans
from adaptpoint_tpu.utils import EasyConfig as JaxConfig
from adaptpoint_tpu_torch.models import build_model_from_cfg
from adaptpoint_tpu_torch.models.backbone import pointvit as pv
from adaptpoint_tpu_torch.models.layers.kmeans import kmeans
from adaptpoint_tpu_torch.utils import EasyConfig
from adaptpoint_tpu_torch.utils.convert import state_dict_from_jax

B, N, E = 4, 256, 48
TOL = dict(rtol=1e-4, atol=1e-5)
# outputs of training-mode BatchNorms: f32 batch statistics summed in another
# order (as tests/test_torch_baselines.py holds its training logits)
TOL_TRAIN = dict(rtol=1e-4, atol=1e-4)


def _as(cls, node):
    if isinstance(node, dict):
        return cls({k: _as(cls, v) for k, v in node.items()})
    return node


def _cloud(seed, b=B, n=N, c=4):
    rng = np.random.default_rng(seed)
    pos = (rng.standard_normal((b, n, 3)) * 0.4).astype(np.float32)
    extra = [np.abs(pos[..., 1:2])] + [
        rng.standard_normal((b, n, 1)).astype(np.float32)
        for _ in range(c - 4)]
    return pos, np.concatenate([pos] + extra, -1)[..., :c]


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
        elif k in ("cls_token", "cls_pos", "dist_token", "dist_pos"):
            v = (rng.standard_normal(v.shape) * 0.5).astype(np.float32)
        out[k] = v
    return out


def _init(module, seed, *args, **kw):
    init = module.init(jax.random.PRNGKey(seed), *args, **kw)
    rng = np.random.default_rng(seed + 100)
    return {c: _randomize(jax.tree_util.tree_map(np.asarray, init[c]), rng)
            for c in init}


_DENSE = {"weight": "kernel", "bias": "bias"}  # torch leaf -> flax leaf
_LN = {"weight": "scale", "bias": "bias"}


def _get(tree, path):
    for part in path.split("/"):
        tree = tree[part]
    return np.asarray(tree, np.float32)


def _load(port, variables, names):
    """Load JAX ``variables`` into ``port``. ``names`` maps a port module
    path to ``(flax path, kind)``: ``conv`` a ConvBlock (Dense_0 at slot 0,
    its BatchNorm or LayerNorm at slot 1), ``linear`` a Dense, ``ln`` a
    LayerNorm, ``param`` a bare parameter."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd = {}
    for key, val in port.state_dict().items():
        if key in names:
            sd[key] = _get(params, names[key][0])
            continue
        mod, leaf = key.rsplit(".", 1)
        if mod in names and names[mod][1] in ("linear", "ln"):
            fp, kind = names[mod]
            if kind == "linear":
                v = _get(params, f"{fp}/{_DENSE[leaf]}")
                sd[key] = v.T.reshape(val.shape) if leaf == "weight" else v
            else:
                sd[key] = _get(params, f"{fp}/{_LN[leaf]}")
        else:
            base, slot = mod.rsplit(".", 1)
            fp, kind = names[base]
            assert kind == "conv", key
            if slot == "0":
                v = _get(params, f"{fp}/Dense_0/{_DENSE[leaf]}")
                sd[key] = v.T.reshape(val.shape) if leaf == "weight" else v
            elif leaf == "num_batches_tracked":
                sd[key] = np.zeros((), np.int64)
            elif isinstance(port.get_submodule(mod), torch.nn.LayerNorm):
                sd[key] = _get(params,
                               f"{fp}/NormAct_0/LayerNorm_0/{_LN[leaf]}")
            else:
                coll, name = {"weight": (params, "scale"),
                              "bias": (params, "bias"),
                              "running_mean": (stats, "mean"),
                              "running_var": (stats, "var")}[leaf]
                sd[key] = _get(coll, f"{fp}/NormAct_0/BatchNorm_0/{name}")
    port.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                          sd.items()})
    return port


def _block_names(prefix="", flax_prefix=""):
    """A TransformerBlock's port paths under ``prefix`` -> flax names under
    ``flax_prefix``."""
    pairs = [("norm1", "norm1", "ln"), ("norm2", "norm2", "ln"),
             ("attn.qkv", "attn/qkv", "linear"),
             ("attn.proj", "attn/proj", "linear"),
             ("mlp.fc1", "fc1", "linear"), ("mlp.fc2", "fc2", "linear")]
    return {".".join(filter(None, (prefix, a))):
            ("/".join(filter(None, (flax_prefix, b))), kind)
            for a, b, kind in pairs}


def _load_vit_encoder(port, variables):
    """An encoder with the reference layout through the converter."""
    rows = [["encoder." + k, list(v.shape)]
            for k, v in port.state_dict().items()]
    sd = state_dict_from_jax({c: {"encoder": t}
                              for c, t in variables.items()}, rows)
    port.load_state_dict({k[len("encoder."):]: v for k, v in sd.items()})
    return port


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, ref, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               **(tol or TOL))


def _stats_close(port, jstats, names):
    """Running statistics of the port's BatchNorms against the JAX
    ``batch_stats`` after a training forward."""
    n = 0
    for key, val in port.state_dict().items():
        if not key.endswith(("running_mean", "running_var")):
            continue
        fp = names[key.rsplit(".", 2)[0]][0]
        leaf = "mean" if key.endswith("mean") else "var"
        ref = _get(jstats, f"{fp}/NormAct_0/BatchNorm_0/{leaf}")
        np.testing.assert_allclose(val.numpy(), ref, rtol=1e-4, atol=1e-5,
                                   err_msg=key)
        n += 1
    assert n > 0


def _drop_masks(inter, paths):
    """Keep-masks flax drew: where each Dropout's output is non-zero (its
    inputs, softmax rows and projections, have no zeros)."""
    out = []
    for path in paths:
        left = np.asarray(_tree(inter, path)["__call__"][0])
        assert 0.0 < (left == 0).mean() < 0.5
        out.append(torch.from_numpy(left != 0))
    return out


def _tree(tree, path):
    for part in path.split("/"):
        tree = tree[part]
    return tree


# ---------------------------------------------------------------- blocks

@pytest.mark.parametrize("qkv_bias", [False, True])
def test_attention_and_block_match_jax(qkv_bias):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 33, E)).astype(np.float32)
    jb = jv.TransformerBlock(E, 3, qkv_bias=qkv_bias)
    variables = _init(jb, 1, jnp.asarray(x))
    port = _load(pv.TransformerBlock(E, 3, qkv_bias=qkv_bias), variables,
                 _block_names())
    assert (port.attn.qkv.bias is not None) == qkv_bias
    _close(port(_t(x)), jb.apply(variables, jnp.asarray(x)))
    ja = jv.Attention(E, 3, qkv_bias)
    _close(port.attn(_t(x)), ja.apply({"params": variables["params"]["attn"]},
                                      jnp.asarray(x)))


def test_block_dropout_with_the_masks_read_off_flax():
    """drop 0.25 on the attention matrix and the projection, in training:
    flax's masks handed to the port give its output; in eval both are the
    identity."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, 33, E)).astype(np.float32)
    jb = jv.TransformerBlock(E, 3, drop=0.25)
    variables = _init(jb, 2, jnp.asarray(x))
    port = _load(pv.TransformerBlock(E, 3, drop=0.25), variables,
                 _block_names())
    ref, st = jb.apply(variables, jnp.asarray(x), training=True,
                       rngs={"dropout": jax.random.PRNGKey(7)},
                       mutable=["intermediates"],
                       capture_intermediates=lambda m, _: isinstance(
                           m, fnn.Dropout))
    masks = _drop_masks(st["intermediates"], ["attn/Dropout_0",
                                              "attn/Dropout_1"])
    assert masks[0].shape == (B, 3, 33, 33) and masks[1].shape == (B, 33, E)
    port.train()
    _close(port(_t(x), masks), ref)
    port.eval()
    _close(port(_t(x)), jb.apply(variables, jnp.asarray(x)))


# ----------------------------------------------------------------- embed

def _embed_names(port, bn_numbers=True):
    """Port embed paths -> flax names: conv{h}.{j} is Dense_{slot}, its
    norm BatchNorm_m / LayerNorm_m."""
    n1 = len(port.conv1)
    names = {}
    for h, seq in ((1, port.conv1), (2, port.conv2)):
        for j, mod in enumerate(seq):
            slot = j if h == 1 else n1 + j
            names[f"conv{h}.{j}.0"] = (f"Dense_{slot}", "linear")
            if len(mod) > 1:
                m = j if h == 1 else n1 - 1 + j
                kind = type(mod[1]).__name__
                if kind == "BatchNorm":
                    names[f"conv{h}.{j}.1"] = (f"BatchNorm_{m}", "bn")
                elif kind == "LayerNorm":
                    names[f"conv{h}.{j}.1"] = (f"LayerNorm_{m}", "ln")
    return names


def _load_embed(port, variables):
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd = {}
    names = _embed_names(port)
    for key, val in port.state_dict().items():
        mod, leaf = key.rsplit(".", 1)
        fp, kind = names[mod]
        if kind == "linear":
            v = _get(params, f"{fp}/{_DENSE[leaf]}")
            sd[key] = v.T.reshape(val.shape) if leaf == "weight" else v
        elif leaf == "num_batches_tracked":
            sd[key] = np.zeros((), np.int64)
        else:
            coll, name = {"weight": (params, "scale"),
                          "bias": (params, "bias"),
                          "running_mean": (stats, "mean"),
                          "running_var": (stats, "var")}[leaf]
            sd[key] = _get(coll, f"{fp}/{name}")
    port.load_state_dict({k: torch.from_numpy(np.array(v))
                          for k, v in sd.items()})
    return port


EMBED_CASES = [
    ("fj", "in2d", {}, False), ("df", "in2d", {}, False),
    ("dp", "in2d", {}, False), ("dp_fj", "in2d", {}, False),
    ("dp_df", "in2d", {}, False),
    ("dp_fj", "in2d", {"normalize_dp": True, "radius": 0.2}, False),
    ("fj", "bn", {}, False), ("fj", "bn", {}, True), ("fj", "ln", {}, False),
    ("fj", "in2d", {"num_groups": 0, "sample_ratio": 0.125}, False),
    ("dp_fj", "in2d", {"group": "ballquery", "radius": 0.3}, False)]


@pytest.mark.parametrize("ft,norm,extra,training", EMBED_CASES,
                         ids=[f"{c[0]}-{c[1]}-{i}"
                              for i, c in enumerate(EMBED_CASES)])
def test_patch_embed_matches_jax(ft, norm, extra, training):
    pos, x = _cloud(11)
    kw = dict(num_groups=32, group_size=8, embed_dim=E, in_channels=4,
              feature_type=ft, norm=norm)
    kw.update(extra)
    jm = jv.PointPatchEmbed(**kw)
    variables = _init(jm, 4, jnp.asarray(pos), jnp.asarray(x))
    port = _load_embed(pv.PointPatchEmbed(**kw), variables)
    port.train(training)
    if training:
        (jc, jh), upd = jm.apply(variables, jnp.asarray(pos), jnp.asarray(x),
                                 training=True, mutable=["batch_stats"])
    else:
        jc, jh = jm.apply(variables, jnp.asarray(pos), jnp.asarray(x))
    centers, h = port(_t(pos), _t(x))
    groups = 32 if kw["num_groups"] else int(N * kw["sample_ratio"])
    assert h.shape == (B, groups, E)
    np.testing.assert_array_equal(centers.numpy(), np.asarray(jc))
    _close(h, jh, **(TOL_TRAIN if training else TOL))
    if training:
        names = _embed_names(port)
        for key, val in port.state_dict().items():
            if key.endswith(("running_mean", "running_var")):
                fp = names[key.rsplit(".", 1)[0]][0]
                leaf = "mean" if key.endswith("mean") else "var"
                np.testing.assert_allclose(
                    val.numpy(), _get(upd["batch_stats"], f"{fp}/{leaf}"),
                    rtol=1e-4, atol=1e-5, err_msg=key)


# --------------------------------------------------------------- PointViT

def _vit_pair(seed, **kw):
    args = dict(in_channels=4, embed_dim=E, depth=2, num_heads=3,
                num_groups=32, group_size=8)
    args.update(kw)
    jm = jv.PointViT(**args)
    pos, x = _cloud(seed, b=2, c=args["in_channels"])
    variables = _init(jm, seed, jnp.asarray(pos), jnp.asarray(x))
    port = _load_vit_encoder(pv.PointViT(**args), variables)
    return jm, variables, port


@pytest.mark.parametrize("global_feat", ["cls,max", "max", "avg", "cls",
                                         "cls,max,mean"])
def test_pointvit_features_match_jax(global_feat):
    jm, variables, port = _vit_pair(6, global_feat=global_feat)
    pos, x = _cloud(13)
    port.eval()
    got = port.forward_cls_feat(_t(pos), _t(x))
    ref = jm.apply(variables, jnp.asarray(pos), jnp.asarray(x))
    assert got.shape == (B, port.out_channels)
    _close(got, ref, **TOL_TRAIN)


def test_pointvit_distill_and_seg_features_match_jax():
    """The distillation token: (global, dist) in training, the global
    feature alone in eval; ``forward_seg_feat``'s lists (the token sequence
    with both tokens first); ``x = None`` takes the xyz as features."""
    jm, variables, port = _vit_pair(8, distill=True)
    pos, x = _cloud(15)
    port.train()
    g, d = port.forward_cls_feat(_t(pos), _t(x))
    rg, rd = jm.apply(variables, jnp.asarray(pos), jnp.asarray(x),
                      training=True)
    _close(g, rg)
    _close(d, rd)
    port.eval()
    _close(port(_t(pos), _t(x)), jm.apply(variables, jnp.asarray(pos),
                                          jnp.asarray(x)))
    (p0, c), (f0, hx) = port.forward_seg_feat(_t(pos), _t(x))
    (jp0, jc), (jf0, jhx) = jm.apply(variables, jnp.asarray(pos),
                                     jnp.asarray(x),
                                     method=jm.forward_seg_feat)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    assert hx.shape == (B, 32 + 2, E) and port.channel_list == [4, E]
    _close(hx, jhx)
    _, var3, port3 = _vit_pair(9, in_channels=3)
    port3.eval()
    jm3 = jv.PointViT(in_channels=3, embed_dim=E, depth=2, num_heads=3,
                      num_groups=32, group_size=8)
    _close(port3(_t(pos)), jm3.apply(var3, jnp.asarray(pos)))


def test_classifier_dropout_in_encoder_and_head_matches_jax():
    """BaseCls over PointViT with ``drop_rate`` 0.2 and the head's dropout
    0.5, in training: the masks flax drew (attention and projection of each
    block, the head's two) handed to the port as ``{"encoder", "head"}``;
    logits and the head's running statistics."""
    cfg = {"NAME": "BaseCls",
           "encoder_args": {"NAME": "PointViT", "in_channels": 4,
                            "embed_dim": E, "depth": 2, "num_heads": 3,
                            "num_groups": 32, "group_size": 8,
                            "drop_rate": 0.2},
           "cls_args": {"NAME": "ClsHead", "num_classes": 5,
                        "mlps": [32, 16], "dropout": 0.5,
                        "norm_args": {"norm": "bn1d"}}}
    jm = jax_build(_as(JaxConfig, cfg))
    pos, x = _cloud(17)
    variables = _init(jm, 10, jnp.asarray(pos[:2]), jnp.asarray(x[:2]))
    port = build_model_from_cfg(_as(EasyConfig, cfg), device="cpu")
    rows = [[k, list(v.shape)] for k, v in port.state_dict().items()]
    port.load_state_dict(state_dict_from_jax(variables, rows))
    ref, st = jm.apply(variables, jnp.asarray(pos), jnp.asarray(x),
                       training=True, rngs={"dropout": jax.random.PRNGKey(3)},
                       mutable=["batch_stats", "intermediates"],
                       capture_intermediates=lambda m, _: isinstance(
                           m, fnn.Dropout) or type(m).__name__ == "NormAct")
    inter = st["intermediates"]
    enc = _drop_masks(inter["encoder"], [f"block{i}/attn/Dropout_{j}"
                                         for i in range(2) for j in (0, 1)])
    head = []
    for blk in ("LinearBlock_0", "LinearBlock_1"):
        entered = np.asarray(inter["prediction"][blk]["NormAct_0"][
            "__call__"][0])
        left = np.asarray(inter["prediction"][blk]["Dropout_0"][
            "__call__"][0])
        head.append(torch.from_numpy((left != 0) | (entered == 0)))
    port.train()
    got = port(_t(pos), _t(x), dropout_mask={"encoder": enc, "head": head})
    _close(got, ref)
    want = state_dict_from_jax(
        {"params": variables["params"], "batch_stats": jax.tree_util.tree_map(
            np.asarray, st["batch_stats"])}, rows)
    for key, val in want.items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(port.state_dict()[key].numpy(),
                                       val.numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=key)


# --------------------------------------------------------------- decoders

def _dec_inputs(seed, c=4, g=32):
    pos, x = _cloud(seed, c=c)
    rng = np.random.default_rng(seed + 1)
    centers = pos[:, rng.permutation(N)[:g]]
    tokens = rng.standard_normal((B, g + 1, E)).astype(np.float32)
    return [pos, centers], [x, tokens]


def _dec_names(port):
    names = {}
    for name, mod in port.named_children():
        if name.startswith("fp"):
            for j, _ in mod.named_children():
                names[f"{name}.{j}"] = (f"{name}/{j}", "conv")
        elif name == "convc":
            names["convc"] = ("convc", "conv")
    return names


DEC_CASES = [("fps", None, 2, False), ("random", None, 2, False),
             ("fps", "cls,max", 2, True), ("random", "max,avg", 3, False),
             ("fps", None, 1, True)]


@pytest.mark.parametrize("sampler,global_feat,stages,training", DEC_CASES)
def test_decoder_matches_jax(sampler, global_feat, stages, training):
    p, f = _dec_inputs(21)
    kw = dict(encoder_channel_list=[4, E], n_decoder_stages=stages,
              sampler=sampler, global_feat=global_feat)
    jm = jv.PointViTDecoder(**kw)
    jp, jf = [jnp.asarray(a) for a in p], [jnp.asarray(a) for a in f]
    variables = _init(jm, 12, jp, jf)
    port = pv.PointViTDecoder(**kw)
    names = _dec_names(port)
    _load(port, variables, names)
    port.train(training)
    if training:
        ref, upd = jm.apply(variables, jp, jf, training=True,
                            mutable=["batch_stats"])
    else:
        ref = jm.apply(variables, jp, jf)
    got = port([_t(a) for a in p], [_t(a) for a in f])
    assert got.shape == (B, N, port.out_channels)
    _close(got, ref, **(TOL_TRAIN if training else TOL))
    if training:
        _stats_close(port, upd["batch_stats"], names)


@pytest.mark.parametrize("sampler,training", [("fps", False),
                                              ("random", True)])
def test_part_decoder_matches_jax(sampler, training):
    p, f = _dec_inputs(23)
    label = np.array([0, 2, 1, 2], np.int32)
    kw = dict(encoder_channel_list=[4, E], sampler=sampler, num_classes=3,
              global_feat="cls,max")
    jm = jv.PointViTPartDecoder(**kw)
    jp, jf = [jnp.asarray(a) for a in p], [jnp.asarray(a) for a in f]
    variables = _init(jm, 14, jp, jf, jnp.asarray(label))
    port = pv.PointViTPartDecoder(**kw)
    names = _dec_names(port)
    _load(port, variables, names)
    port.train(training)
    if training:
        ref, upd = jm.apply(variables, jp, jf, jnp.asarray(label),
                            training=True, mutable=["batch_stats"])
    else:
        ref = jm.apply(variables, jp, jf, jnp.asarray(label))
    got = port([_t(a) for a in p], [_t(a) for a in f], _t(label))
    assert got.shape == (B, N, port.out_channels)
    _close(got, ref, **(TOL_TRAIN if training else TOL))
    if training:
        _stats_close(port, upd["batch_stats"], names)


# --------------------------------------------------------------- k-means

@pytest.mark.parametrize("kind", ["random", "duplicates", "wide"])
def test_kmeans_matches_jax(kind):
    """Assignments exact, centroids close. ``duplicates``: 5 distinct
    points for 8 clusters, so FPS seeds coincide and the higher-numbered
    twin of each pair is empty (its centroid the origin, the count floored
    at 1); ``wide``: C = 6, seeded on the first three dims."""
    rng = np.random.default_rng(31)
    if kind == "duplicates":
        distinct = rng.standard_normal((2, 5, 3)).astype(np.float32)
        pts = distinct[:, rng.integers(0, 5, 64)]
    else:
        c = 6 if kind == "wide" else 3
        pts = rng.standard_normal((2, 128, c)).astype(np.float32)
    ja, jc = jax_kmeans(jnp.asarray(pts), 8, 10)
    a, c = kmeans(_t(pts), 8, 10)
    assert a.dtype == torch.int32
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    _close(c, jc)
    if kind == "duplicates":
        assert (np.abs(c.numpy()).sum(-1) == 0).any()


def test_kmeans_embed_matches_jax():
    pos, x = _cloud(33, c=5)
    jm = jv.KMeansEmbed(num_groups=16, group_size=8, embed_dim=E)
    variables = _init(jm, 16, jnp.asarray(pos), jnp.asarray(x))
    port = _load(pv.KMeansEmbed(16, 8, E, in_channels=5), variables,
                 {"conv0": ("ConvBlock_0", "conv"),
                  "conv1": ("ConvBlock_1", "conv"),
                  "proj": ("Dense_0", "linear")})
    jc, jh = jm.apply(variables, jnp.asarray(pos), jnp.asarray(x))
    c, h = port(_t(pos), _t(x))
    _close(c, jc)
    _close(h, jh)


# --------------------------------------------------------------- ViTGraph

@pytest.mark.parametrize("embed", ["groupembed", "kmeans"])
def test_vitgraph_with_wider_features_matches_jax(embed):
    """in_channels 6: features wider than the xyz through either
    embedding (the JAX embed infers the width; the port is built for it)."""
    emb = {"NAME": embed, "num_groups": 16, "group_size": 8,
           "embed_dim": 32}
    kw = dict(in_channels=6, encoder_dim=E, depth=2, num_heads=3,
              embed_args=emb)
    jm = jv.ViTGraph(**kw)
    pos, x = _cloud(35, c=6)
    variables = _init(jm, 18, jnp.asarray(pos), jnp.asarray(x))
    port = pv.ViTGraph(**kw)
    names = {"cls_token": ("cls_token", "param"),
             "cls_pos": ("cls_pos", "param"),
             "proj_layer": ("proj_layer", "linear"),
             "pos_embed.0.0": ("pos1", "linear"),
             "pos_embed.1": ("pos2", "linear"), "norm": ("norm", "ln")}
    for i in range(2):
        names.update(_block_names(f"blocks.{i}", f"block{i}"))
    if embed == "kmeans":
        names.update({"group_embed.conv0": ("group_embed/ConvBlock_0",
                                            "conv"),
                      "group_embed.conv1": ("group_embed/ConvBlock_1",
                                            "conv"),
                      "group_embed.proj": ("group_embed/Dense_0", "linear")})
    else:
        for k, (fp, kind) in _embed_names(port.group_embed).items():
            names[f"group_embed.{k}"] = (f"group_embed/{fp}", kind)
    _load(port, variables, names)
    jc, jh = jm.apply(variables, jnp.asarray(pos), jnp.asarray(x))
    c, h = port(_t(pos), _t(x))
    assert h.shape == (B, 17, E)
    _close(c, jc)
    _close(h, jh)
    _close(port.forward_cls_feat(_t(pos), _t(x)),
           jm.apply(variables, jnp.asarray(pos), jnp.asarray(x),
                    method=jm.forward_cls_feat))
    with pytest.raises(ValueError, match="6 feature channels"):
        port(_t(pos))


# ---------------------------------------------------------------- P3Embed

@pytest.mark.parametrize("ratio,scale", [(0.0625, 4), (0.25, 4), (1 / 64, 4),
                                         (0.125, 2), (0.01, 3)])
def test_p3embed_stages_expression(ratio, scale):
    """``int(math.log(1 / sample_ratio, scale))`` in both packages, the float
    expression's truncation included (1/64 at scale 4 gives 2)."""
    assert pv.P3Embed(ratio, scale).stages == \
        jv.P3Embed(ratio, scale).stages == int(math.log(1.0 / ratio, scale))
    assert pv.P3Embed(ratio, scale, embed_dim=64).channel_list == \
        jv.P3Embed(ratio, scale, embed_dim=64).channel_list


P3_CASES = [({}, False), ({}, True),
            ({"group": "knn", "feature_type": "dp_fj", "reduction": "mean"},
             False),
            ({"feature_type": "dp_fj_df", "radius": 0.3}, False)]


@pytest.mark.parametrize("extra,training", P3_CASES)
def test_p3embed_matches_jax(extra, training):
    kw = dict(group_size=8, embed_dim=E, radius=0.25, in_channels=4)
    kw.update(extra)
    jm = jv.P3Embed(**kw)
    pos, x = _cloud(37)
    variables = _init(jm, 20, jnp.asarray(pos), jnp.asarray(x))
    port = pv.P3Embed(**kw)
    names = {n: (n, "conv") for n, _ in port.named_children()}
    _load(port, variables, names)
    port.train(training)
    if training:
        (jps, jfs), upd = jm.apply(variables, jnp.asarray(pos),
                                   jnp.asarray(x), training=True,
                                   mutable=["batch_stats"])
    else:
        jps, jfs = jm.apply(variables, jnp.asarray(pos), jnp.asarray(x))
    ps, fs = port(_t(pos), _t(x))
    assert [f.shape[-1] for f in fs] == port.channel_list
    for a, b in zip(ps, jps):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(fs, jfs):
        _close(a, b, **(TOL_TRAIN if training else TOL))
    if training:
        _stats_close(port, upd["batch_stats"], names)
