"""Carry weights across from the JAX package to the port.

``state_dict_from_jax(variables, layout_rows)`` turns the JAX package's
``{"params", "batch_stats"}`` tree (numpy arrays) into the port's
``state_dict``, whose names are the reference openpoints layout (a
``tests/fixtures/ref_layout_*.json`` fixture gives ``layout_rows``). It keeps
its own copy of the PointNeXt SA-stage and ClsHead rules of
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
"""
from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Any, Dict, Iterable, Tuple

import numpy as np
import torch

__all__ = ["state_dict_from_jax"]

_SA_CONV = re.compile(r"^encoder\.encoder\.(\d+)\.0\.convs\.(\d+)\.([01])\.(.+)$")
_SA_SKIP = re.compile(r"^encoder\.encoder\.(\d+)\.0\.skipconv\.0\.(weight|bias)$")
_HEAD = re.compile(r"^prediction\.head\.(\d+)\.([01])\.(.+)$")
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


def _translate(key: str, keys) -> Tuple[str, str, bool]:
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
    m = _HEAD.match(key)
    if m:
        i, sub, leaf = int(m.group(1)), m.group(2), m.group(3)
        if f"prediction.head.{i}.1.weight" in keys:
            base = f"prediction/LinearBlock_{i // 2}"
            return _pair(sub, leaf, f"{base}/Dense_0",
                         f"{base}/NormAct_0/BatchNorm_0")
        return _pair(sub, leaf, "prediction/Dense_0", "")
    raise KeyError(key)


def state_dict_from_jax(variables: Mapping, layout_rows: Iterable
                        ) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` from JAX ``variables`` (numpy leaves).

    ``layout_rows`` is ``[[key, shape], ...]``. Raises on a key with no
    rule, a missing source leaf, a size mismatch, or a source leaf no key
    consumed (trained weights would otherwise be dropped)."""
    rows = [(k, tuple(s)) for k, s in layout_rows]
    keys = {k for k, _ in rows}
    flat = {c: _flatten(variables.get(c, {})) for c in ("params",
                                                         "batch_stats")}
    used = {c: set() for c in flat}
    out: Dict[str, torch.Tensor] = {}
    for key, shape in rows:
        try:
            coll, path, is_kernel = _translate(key, keys)
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
