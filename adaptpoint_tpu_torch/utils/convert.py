"""Carry weights across from the JAX package to the port.

``state_dict_from_jax(variables, layout_rows)`` turns the JAX package's
``{"params", "batch_stats"}`` tree (numpy arrays) into the port's
``state_dict``, whose names are the reference openpoints layout (a
``tests/fixtures/ref_layout_*.json`` fixture gives ``layout_rows``). It keeps
its own copy of the PointNeXt SA-stage, InvResMLP depth-block
(``encoder.encoder.{s}.{b > 0}``: ``convs.convs.{j}``, the local
aggregation's convs, and ``pwconv.{i}``), ClsHead and segmentation rules
(SegHead, the FP decoder stages and the part decoder's ``global_conv1``,
``global_conv2`` and ``convc``), and the baselines' rules (DGCNN and
BallDGCNN, whose conv-act-norm blocks hold their BatchNorm at slot 2;
PointNet++'s SA stages; PointNet's T-Nets and trunk; PointMLP's embedding,
affine parameters, transfer and residual convs), and PointViT's (tokens,
the positional MLP, the patch embed's convs and their bn or ln norms, the
transformer blocks and the final norm) of
``adaptpoint_tpu/utils/torch_convert.py`` ``export_reference_state_dict``:

- ``Dense`` kernels ``(in, out)`` transpose to ``(out, in)`` and reshape to
  the layout's rank (Conv1d ``(out, in, 1)``, Conv2d ``(out, in, 1, 1)``,
  Linear ``(out, in)``);
- BatchNorm ``scale/bias`` -> ``weight/bias``, ``mean/var`` ->
  ``running_mean/running_var``, ``num_batches_tracked`` = 0;
- a head ``LinearBlock`` Dense bias, which the reference's bias-free Linear
  has no slot for, is folded into the BatchNorm's ``running_mean``
  (``mean - b``; exact in eval mode).

A reference ``.pth`` (or one written by ``scripts/export_torch_ckpt.py``)
already has these names and loads with ``load_state_dict`` directly.

``generator_state_dict_from_jax`` and ``discriminator_state_dict_from_jax`` do
the same for the AdaptPoint augmentor and discriminator (its own copy of the
rules of ``export_reference_generator`` / ``export_reference_discriminator``
there). The discriminator's flax spectral norm stores the raw kernel and the
power-iteration ``u``; the reference layout also has ``_v``, exported as
``normalize(W^T u)``. ``discriminator_stats_to_jax`` reads the port's ``u``
and ``sigma`` back under the flax module names, for comparisons.
"""
from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Any, Dict, Iterable, Tuple

import numpy as np
import torch

__all__ = ["state_dict_from_jax", "generator_state_dict_from_jax",
           "discriminator_state_dict_from_jax", "discriminator_stats_to_jax",
           "DIS_MODULES"]

_SA_CONV = re.compile(r"^encoder\.encoder\.(\d+)\.0\.convs\.(\d+)\.([01])\.(.+)$")
_SA_SKIP = re.compile(r"^encoder\.encoder\.(\d+)\.0\.skipconv\.0\.(weight|bias)$")
_IRB_LA = re.compile(
    r"^encoder\.encoder\.(\d+)\.([1-9]\d*)\.convs\.convs\.(\d+)\.([01])\.(.+)$")
_IRB_PW = re.compile(
    r"^encoder\.encoder\.(\d+)\.([1-9]\d*)\.pwconv\.(\d+)\.([01])\.(.+)$")
_HEAD = re.compile(r"^prediction\.head\.(\d+)\.([01])\.(.+)$")
_SEGHEAD = re.compile(r"^head\.head\.(\d+)\.([01])\.(.+)$")
_DEC = re.compile(r"^decoder\.decoder\.(\d+)\.0\.convs\.(\d+)\.([01])\.(.+)$")
_DEC_GLOBAL = re.compile(
    r"^decoder\.(global_conv[12]|convc)\.0\.0\.(weight|bias)$")
_PN2 = re.compile(r"^encoder\.SA_modules\.(\d+)\.local_aggregations\.0\."
                  r"SA_CONFIG_operator\.convs\.(\d+)\.([01])\.(.+)$")
_DGCNN = re.compile(r"^encoder\.(head|backbone\.(\d+))\.gconv\.nn\.([012])"
                    r"\.(.+)$")
_DGCNN_FUSION = re.compile(r"^encoder\.fusion_block\.([012])\.(.+)$")
_PNET_STN = re.compile(r"^encoder\.(stn|fstn)\.(conv|fc|bn)(\d)\.(.+)$")
_PNET_TRUNK = re.compile(r"^encoder\.(conv|bn)(0_[12]|[123])\.(.+)$")
# the trunk's layers in call order: flax names them _MLPBN_0 ... _MLPBN_4
_PNET_TRUNK_SLOT = {"0_1": 0, "0_2": 1, "1": 2, "2": 3, "3": 4}
_PMLP_EMB = re.compile(r"^encoder\.embedding\.net\.([01])\.(.+)$")
_PMLP_AFF = re.compile(r"^encoder\.local_grouper_list\.(\d+)\."
                       r"(affine_alpha|affine_beta)$")
_PMLP_TRANSFER = re.compile(r"^encoder\.pre_blocks_list\.(\d+)\.transfer\."
                            r"net\.([01])\.(.+)$")
_PMLP_RES = re.compile(r"^encoder\.(pre|pos)_blocks_list\.(\d+)\."
                       r"operation\.(\d+)\.net([12])\.([01])\.(.+)$")
# PointViT (pointvit.py + layers/group_embed.py + layers/attention.py): the
# patch-embed convs are flax's Dense_0 ... Dense_{L-1} in call order (in2d
# has no parameters; a bn or ln norm is BatchNorm_m / LayerNorm_m), the
# blocks keep torch's member names
_VIT_TOKEN = re.compile(r"^encoder\.(cls_token|cls_pos|dist_token|dist_pos)$")
_VIT_POS = re.compile(r"^encoder\.pos_embed\.(0\.0|1)\.(weight|bias)$")
_VIT_EMBED = re.compile(r"^encoder\.patch_embed\.conv([12])\.(\d+)\.([01])\."
                        r"(.+)$")
_VIT_BLOCK = re.compile(r"^encoder\.blocks\.(\d+)\.(norm1|norm2|attn\.qkv|"
                        r"attn\.proj|mlp\.fc1|mlp\.fc2)\.(weight|bias)$")
_VIT_NORM = re.compile(r"^encoder\.norm\.(weight|bias)$")
_VIT_BLOCK_DST = {"norm1": "norm1", "norm2": "norm2", "attn.qkv": "attn/qkv",
                  "attn.proj": "attn/proj", "mlp.fc1": "fc1", "mlp.fc2": "fc2"}
_LN = {"weight": "scale", "bias": "bias"}
_BN = {"weight": ("params", "scale"), "bias": ("params", "bias"),
       "running_mean": ("batch_stats", "mean"),
       "running_var": ("batch_stats", "var")}


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


def _pair(sub: str, leaf: str, dense: str, bn: str):
    """(collection, path, is_kernel) of one leaf of a [conv, BN] pair."""
    if sub == "0":
        if leaf == "weight":
            return "params", f"{dense}/kernel", True
        if leaf == "bias":
            return "params", f"{dense}/bias", False
    elif leaf in _BN:
        coll, name = _BN[leaf]
        return coll, f"{bn}/{name}", False
    elif leaf == "num_batches_tracked":
        return "count", "", False
    raise KeyError(leaf)


def _convblock_any(sub: str, leaf: str, base: str):
    """A ConvBlock of either order: conv-norm-act keeps its BatchNorm at
    slot 1 (flax ``NormAct_0``), conv-act-norm at slot 2 (``NormAct_1``)."""
    bn = f"{base}/NormAct_{1 if sub == '2' else 0}/BatchNorm_0"
    return _pair(sub, leaf, f"{base}/Dense_0", bn)


def _translate_vit(key: str, keys) -> Tuple[str, str, bool]:
    """The rules of PointViT."""
    m = _VIT_TOKEN.match(key)
    if m:
        return "params", f"encoder/{m.group(1)}", False
    m = _VIT_POS.match(key)
    if m:
        dst = "pos1" if m.group(1) == "0.0" else "pos2"
        return _pair("0", m.group(2), f"encoder/{dst}", "")
    m = _VIT_EMBED.match(key)
    if m:
        half, j, sub, leaf = m.groups()
        j = int(j)
        # conv2's Dense and norm numbers continue after conv1's
        n_conv1 = len({k.split(".")[3] for k in keys
                       if k.startswith("encoder.patch_embed.conv1.")})
        base = "encoder/patch_embed"
        if sub == "0":
            slot = j if half == "1" else n_conv1 + j
            return _pair("0", leaf, f"{base}/Dense_{slot}", "")
        norm = j if half == "1" else n_conv1 - 1 + j  # each half's last: none
        prefix = key.rsplit(".", 1)[0]
        if f"{prefix}.running_mean" in keys:
            return _pair("1", leaf, "", f"{base}/BatchNorm_{norm}")
        return "params", f"{base}/LayerNorm_{norm}/{_LN[leaf]}", False
    m = _VIT_BLOCK.match(key)
    if m:
        base = f"encoder/block{m.group(1)}/{_VIT_BLOCK_DST[m.group(2)]}"
        if m.group(2).startswith("norm"):
            return "params", f"{base}/{_LN[m.group(3)]}", False
        return _pair("0", m.group(3), base, "")
    m = _VIT_NORM.match(key)
    if m:
        return "params", f"encoder/norm/{_LN[m.group(1)]}", False
    raise KeyError(key)


def _translate_baselines(key: str) -> Tuple[str, str, bool]:
    """The rules of DGCNN / BallDGCNN, PointNet++, PointNet and PointMLP."""
    m = _PN2.match(key)
    if m:
        s, j, sub, leaf = m.groups()
        base = f"encoder/sa{s}/ConvBlock_{j}"
        return _pair(sub, leaf, f"{base}/Dense_0",
                     f"{base}/NormAct_0/BatchNorm_0")
    m = _DGCNN.match(key)
    if m:
        _, block, sub, leaf = m.groups()
        name = "head" if block is None else f"block{block}"
        return _convblock_any(sub, leaf, f"encoder/{name}/ConvBlock_0")
    m = _DGCNN_FUSION.match(key)
    if m:
        return _convblock_any(m.group(1), m.group(2), "encoder/fusion")
    m = _PNET_STN.match(key)
    if m:
        tnet, kind, i, leaf = m.groups()
        base = f"encoder/{tnet}"
        if kind == "fc" and i == "3":  # the bare last Dense
            return _pair("0", leaf, f"{base}/Dense_0", "")
        # conv1-3 and fc1-2 are _MLPBN_0-4, bn{i} their BatchNorms
        slot = int(i) - 1 + (3 if kind == "fc" else 0)
        mlp = f"{base}/_MLPBN_{slot}"
        return _pair("1" if kind == "bn" else "0", leaf, f"{mlp}/Dense_0",
                     f"{mlp}/BatchNorm_0")
    m = _PNET_TRUNK.match(key)
    if m:
        kind, i, leaf = m.groups()
        mlp = f"encoder/_MLPBN_{_PNET_TRUNK_SLOT[i]}"
        return _pair("1" if kind == "bn" else "0", leaf, f"{mlp}/Dense_0",
                     f"{mlp}/BatchNorm_0")
    m = _PMLP_EMB.match(key)
    if m:
        return _pair(m.group(1), m.group(2), "encoder/embedding/Dense_0",
                     "encoder/embedding/BatchNorm_0")
    m = _PMLP_AFF.match(key)
    if m:
        return "params", f"encoder/grouper{m.group(1)}/{m.group(2)}", False
    m = _PMLP_TRANSFER.match(key)
    if m:
        base = f"encoder/pre{m.group(1)}_transfer"
        return _pair(m.group(2), m.group(3), f"{base}/Dense_0",
                     f"{base}/BatchNorm_0")
    m = _PMLP_RES.match(key)
    if m:
        kind, i, j, net, sub, leaf = m.groups()
        base = f"encoder/{kind}{i}_res{j}"
        if net == "1":  # the expansion conv: the block's _ConvBNAct_0
            base += "/_ConvBNAct_0"
        return _pair(sub, leaf, f"{base}/Dense_0", f"{base}/BatchNorm_0")
    raise KeyError(key)


def _translate(key: str, keys) -> Tuple[str, str, bool]:
    if key.startswith(("encoder.cls_", "encoder.dist_", "encoder.pos_embed.",
                       "encoder.patch_embed.", "encoder.blocks.",
                       "encoder.norm.")):
        return _translate_vit(key, keys)
    m = _SA_CONV.match(key)
    if m:
        stage, j, sub, leaf = m.groups()
        base = f"encoder/enc{stage}_sa/ConvBlock_{j}"
        return _pair(sub, leaf, f"{base}/Dense_0",
                     f"{base}/NormAct_0/BatchNorm_0")
    m = _SA_SKIP.match(key)
    if m:
        stage, leaf = m.groups()
        base = f"encoder/enc{stage}_sa/skipconv"
        return ("params", f"{base}/kernel", True) if leaf == "weight" \
            else ("params", f"{base}/bias", False)
    m = _IRB_LA.match(key) or _IRB_PW.match(key)
    if m:
        stage, block, j, sub, leaf = m.groups()
        base = f"encoder/enc{stage}_b{block}/" + (
            f"LocalAggregation_0/ConvBlock_{j}" if m.re is _IRB_LA
            else f"ConvBlock_{j}")
        return _pair(sub, leaf, f"{base}/Dense_0",
                     f"{base}/NormAct_0/BatchNorm_0")
    m = _HEAD.match(key)
    if m:
        i, sub, leaf = int(m.group(1)), m.group(2), m.group(3)
        if f"prediction.head.{i}.1.weight" in keys:
            # the k-th head slot with a BatchNorm is LinearBlock_k (slots
            # alternate with Dropout only when the head has dropout)
            k = sum(f"prediction.head.{j}.1.weight" in keys for j in range(i))
            base = f"prediction/LinearBlock_{k}"
            return _pair(sub, leaf, f"{base}/Dense_0",
                         f"{base}/NormAct_0/BatchNorm_0")
        return _pair(sub, leaf, "prediction/Dense_0", "")
    m = _SEGHEAD.match(key)
    if m:
        i, sub, leaf = int(m.group(1)), m.group(2), m.group(3)
        if f"head.head.{i}.1.weight" in keys:
            # the k-th head slot with a BatchNorm is ConvBlock_k
            k = sum(f"head.head.{j}.1.weight" in keys for j in range(i))
            base = f"head/ConvBlock_{k}"
            return _pair(sub, leaf, f"{base}/Dense_0",
                         f"{base}/NormAct_0/BatchNorm_0")
        return _pair(sub, leaf, "head/Dense_0", "")
    m = _DEC.match(key)
    if m:
        stage, j, sub, leaf = m.groups()
        base = f"decoder/fp{stage}/ConvBlock_{j}"
        return _pair(sub, leaf, f"{base}/Dense_0",
                     f"{base}/NormAct_0/BatchNorm_0")
    m = _DEC_GLOBAL.match(key)
    if m:
        # the part decoder's category convs: a conv with a bias, no norm
        name, leaf = m.groups()
        return _pair("0", leaf, f"decoder/{name}/Dense_0", "")
    return _translate_baselines(key)


# augmentor sites under ``predict_prob_layer.``: reference prefix (conv at
# .0, BN at .1) -> (Dense path, BatchNorm path) under ``predict_prob_layer/``
_GEN_PAIR_SITES = [
    (re.compile(r"^embedding\.net\.([01])\.(.+)$"),
     lambda m: ("embedding/Dense_0", "embedding/BatchNorm_0")),
    (re.compile(r"^extract_feat_list\.(\d+)\.net\.([01])\.(.+)$"),
     lambda m: (f"pre{m.group(1)}/Dense_0", f"pre{m.group(1)}/BatchNorm_0")),
    (re.compile(r"^decode_list\.(\d+)\.fuse\.net\.([01])\.(.+)$"),
     lambda m: (f"fp{m.group(1)}/ConvBNReLU_0/Dense_0",
                f"fp{m.group(1)}/ConvBNReLU_0/BatchNorm_0")),
    (re.compile(r"^head\.global_layer\.([01])\.(.+)$"),
     lambda m: ("head/global_conv", "head/global_bn")),
    (re.compile(r"^head\.prob_head\.([01])\.(.+)$"),
     lambda m: ("head/prob_head", "head/prob_bn")),
    (re.compile(r"^head\.anchor_selfattention\.pos_embedding\.([01])\.(.+)$"),
     lambda m: ("head/anchor_attn/pos_embedding", "head/anchor_attn/pos_bn")),
    (re.compile(r"^head\.anchor_selfattention\.res\.([01])\.(.+)$"),
     lambda m: ("head/anchor_attn/res", "head/anchor_attn/res_bn")),
    (re.compile(r"^localfeat_mask_selfattention\.pos_embedding\.([01])\.(.+)$"),
     lambda m: ("mask_attn/pos_embedding", "mask_attn/pos_bn")),
    (re.compile(r"^localfeat_mask_selfattention\.res\.([01])\.(.+)$"),
     lambda m: ("mask_attn/res", "mask_attn/res_bn")),
    (re.compile(r"^extract_local_feat_masking\.([01])\.(.+)$"),
     lambda m: ("mask_local", "mask_local_bn")),
    (re.compile(r"^extract_global_feat_masking\.([01])\.(.+)$"),
     lambda m: ("mask_global", "mask_global_bn")),
    (re.compile(r"^fuse_masking\.([01])\.(.+)$"),
     lambda m: ("mask_fuse", "mask_fuse_bn")),
]
_GEN_QKV = {"head.anchor_selfattention.to_qkv.weight":
            "head/anchor_attn/to_qkv/kernel",
            "localfeat_mask_selfattention.to_qkv.weight":
            "mask_attn/to_qkv/kernel"}
_GEN_AFFINE = re.compile(
    r"^pointset_grouper_list\.(\d+)\.(affine_alpha|affine_beta)$")

# discriminator: reference module -> flax Dense name
DIS_MODULES = {"sa1.mlp_convs.0": "sa_conv0", "sa1.mlp_convs.1": "sa_conv1",
               "sa1.mlp_convs.2": "sa_conv2", "fc1": "fc0", "fc2": "fc1",
               "fc3": "fc2", "prob_head.0": "prob_head"}


def _translate_generator(key: str, keys) -> Tuple[str, str, bool]:
    root = "predict_prob_layer"
    if not key.startswith(root + "."):
        raise KeyError(key)
    rest = key[len(root) + 1:]
    for rx, dst in _GEN_PAIR_SITES:
        m = rx.match(rest)
        if m:
            dense, bn = dst(m)
            return _pair(m.group(m.lastindex - 1), m.group(m.lastindex),
                         f"{root}/{dense}", f"{root}/{bn}")
    if rest in _GEN_QKV:
        return "params", f"{root}/{_GEN_QKV[rest]}", True
    m = _GEN_AFFINE.match(rest)
    if m:
        return "params", f"{root}/grouper{m.group(1)}/{m.group(2)}", False
    raise KeyError(key)


def state_dict_from_jax(variables: Mapping, layout_rows: Iterable
                        ) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` from JAX ``variables`` (numpy leaves).

    ``layout_rows`` is ``[[key, shape], ...]``. Raises on a key with no
    rule, a missing source leaf, a size mismatch, or a source leaf no key
    consumed (trained weights would otherwise be dropped)."""
    return _from_jax(variables, layout_rows, _translate)


def generator_state_dict_from_jax(variables: Mapping, layout_rows: Iterable
                                  ) -> Dict[str, torch.Tensor]:
    """The augmentor's ``state_dict`` from its JAX ``variables``: the same
    contract as :func:`state_dict_from_jax`. Every conv and bias slot exists
    on both sides, so nothing is folded."""
    return _from_jax(variables, layout_rows, _translate_generator)


def _flatten_tuples(tree, prefix=()) -> Dict[tuple, Any]:
    """Flatten with tuple paths: flax's SpectralNorm leaf names hold
    slashes (``fc0/kernel/u``)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten_tuples(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = v
    return out


def discriminator_state_dict_from_jax(variables: Mapping,
                                      layout_rows: Iterable
                                      ) -> Dict[str, torch.Tensor]:
    """The discriminator's ``state_dict`` from its JAX ``variables``:
    ``kernel`` (in, out) -> ``parametrizations.weight.original`` (out, in
    [, 1, 1]), ``bias`` as it is, ``u`` (1, out) -> ``_u`` (out,), and
    ``_v = normalize(W^T u)`` (in,), which flax does not store."""
    shapes = {k: tuple(s) for k, s in layout_rows}
    flat_p = _flatten_tuples(variables.get("params", {}))
    flat_b = _flatten_tuples(variables.get("batch_stats", {}))
    u_by_name = {path[-1][:-len("/kernel/u")]:
                 np.asarray(leaf, np.float32).reshape(-1)
                 for path, leaf in flat_b.items()
                 if path[-1].endswith("/kernel/u")}
    out: Dict[str, torch.Tensor] = {}
    for src, name in DIS_MODULES.items():
        w_key = f"{src}.parametrizations.weight.original"
        if w_key not in shapes:
            continue
        if (name, "kernel") not in flat_p or name not in u_by_name:
            raise ValueError(f"{src}: no source kernel or u for {name}")
        w = np.ascontiguousarray(
            np.asarray(flat_p[(name, "kernel")], np.float32).T)  # (out, in)
        if w.size != int(np.prod(shapes[w_key])):
            raise ValueError(f"{w_key}: kernel {w.shape} vs layout "
                             f"{shapes[w_key]}")
        out[w_key] = torch.from_numpy(w.reshape(shapes[w_key]))
        if f"{src}.bias" in shapes:
            out[f"{src}.bias"] = torch.from_numpy(np.array(
                flat_p[(name, "bias")], np.float32))
        u = u_by_name[name]
        v = w.T @ u
        v = v / max(float(np.linalg.norm(v)), 1e-12)
        out[f"{src}.parametrizations.weight.0._u"] = torch.from_numpy(
            u.copy())
        out[f"{src}.parametrizations.weight.0._v"] = torch.from_numpy(
            v.astype(np.float32))
    missing = [k for k in shapes if k not in out]
    if missing:
        raise ValueError(f"layout keys with no source: {missing[:10]}")
    return {k: out[k] for k in shapes}


def discriminator_stats_to_jax(model: torch.nn.Module) -> Dict[str, Dict]:
    """The port discriminator's power-iteration state under the flax Dense
    names: ``{name: {"u": (1, out), "sigma": ()}}`` as numpy arrays."""
    out = {}
    for src, name in DIS_MODULES.items():
        st = model.get_submodule(src).state
        out[name] = {"u": st._u.detach().cpu().numpy()[None, :].copy(),
                     "sigma": st._sigma.detach().cpu().numpy().copy()}
    return out


def _from_jax(variables: Mapping, layout_rows: Iterable, translate
              ) -> Dict[str, torch.Tensor]:
    rows = [(k, tuple(s)) for k, s in layout_rows]
    keys = {k for k, _ in rows}
    flat = {c: _flatten(variables.get(c, {})) for c in ("params",
                                                         "batch_stats")}
    used = {c: set() for c in flat}
    out: Dict[str, torch.Tensor] = {}
    for key, shape in rows:
        try:
            coll, path, is_kernel = translate(key, keys)
        except KeyError:
            raise ValueError(f"no conversion rule for {key}") from None
        if coll == "count":
            out[key] = torch.tensor(0, dtype=torch.int64)
            continue
        if path not in flat[coll]:
            raise ValueError(f"{key} <- {coll}:{path}: no such source leaf")
        val = np.asarray(flat[coll][path], np.float32)
        if is_kernel:
            val = np.ascontiguousarray(val.T)  # (in, out) -> (out, in)
        if val.size != int(np.prod(shape)):
            raise ValueError(f"{key} <- {coll}:{path}: size {val.shape} vs "
                             f"layout {shape}")
        if coll == "batch_stats" and key.endswith(".1.running_mean"):
            dense_bias = path.replace("/NormAct_0/BatchNorm_0/mean",
                                      "/Dense_0/bias")
            conv_bias_key = key[:-len(".1.running_mean")] + ".0.bias"
            if conv_bias_key not in keys and dense_bias in flat["params"]:
                val = val - np.asarray(flat["params"][dense_bias], np.float32)
                used["params"].add(dense_bias)
        out[key] = torch.from_numpy(np.ascontiguousarray(val.reshape(shape)))
        used[coll].add(path)
    unused = [f"{c}:{p}" for c, leaves in flat.items() for p in leaves
              if p not in used[c]]
    if unused:
        raise ValueError(f"source leaves with no layout slot: {unused[:10]}")
    return out
