"""The port's PointNeXt-S classifier against the JAX package.

- Layout: the full-width port's state_dict has exactly the reference
  openpoints keys and shapes of tests/fixtures/ref_layout_pointnext_s_cls.json.
- Conversion: ``state_dict_from_jax`` equals
  ``adaptpoint_tpu.utils.torch_convert.export_reference_state_dict`` bit for
  bit on a full-width JAX init with non-zero head biases.
- Logits of a small PointNeXt-S-shaped model (stem, two strided SA stages,
  the group-all stage, ClsHead) on the same numpy inputs and weights:
  unfused route against JAX on its XLA route at rtol 1e-4 / atol 1e-5 (sums
  in another order; dp multiplied by f32(1/r) instead of divided); fused
  route against JAX's fused_eval() in Pallas interpret mode at 2e-2 with the
  same argmax (bf16 operands: an accumulation-order difference can flip one
  bf16 rounding of a hidden activation).
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaptpoint_tpu.models import build_model_from_cfg as jax_build
from adaptpoint_tpu.utils import EasyConfig as JaxConfig
from adaptpoint_tpu.utils.fastpath import fused_eval
from adaptpoint_tpu.utils.torch_convert import export_reference_state_dict
from adaptpoint_tpu_torch.models import build_model_from_cfg
from adaptpoint_tpu_torch.utils import EasyConfig
from adaptpoint_tpu_torch.utils.convert import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYOUT = os.path.join(REPO, "tests/fixtures/ref_layout_pointnext_s_cls.json")
CFG = os.path.join(REPO, "cfgs/scanobjectnn/pointnext-s.yaml")


def _small_cfg():
    return {
        "NAME": "BaseCls",
        "encoder_args": {
            "NAME": "PointNextEncoder",
            "blocks": [1, 1, 1, 1], "strides": [1, 2, 2, 1], "width": 16,
            "in_channels": 4, "sa_layers": 2, "sa_use_res": True,
            "radius": 0.3, "radius_scaling": 1.5, "nsample": 8,
            "expansion": 4,
            "aggr_args": {"feature_type": "dp_fj", "reduction": "max"},
            "group_args": {"NAME": "ballquery", "normalize_dp": True},
            "conv_args": {"order": "conv-norm-act"},
            "act_args": {"act": "relu"},
            "norm_args": {"norm": "bn"},
        },
        "cls_args": {"NAME": "ClsHead", "num_classes": 5, "mlps": [32, 16],
                     "norm_args": {"norm": "bn1d"}},
    }


def _randomize(variables, seed):
    """Non-trivial BN statistics/affines and Dense biases, as numpy."""
    rng = np.random.default_rng(seed)

    def walk(tree, path=()):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                out[k] = walk(v, path + (k,))
                continue
            v = np.asarray(v, np.float32)
            if k == "var":
                v = (rng.random(v.shape) + 0.5).astype(np.float32)
            elif k in ("mean", "bias"):
                v = (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
            elif k == "scale":
                v = (rng.random(v.shape) + 0.5).astype(np.float32)
            out[k] = v
        return out

    return {c: walk(variables[c]) for c in ("params", "batch_stats")}


def _inputs(seed, B, N):
    rng = np.random.default_rng(seed)
    pos = (rng.standard_normal((B, N, 3)) * 0.4).astype(np.float32)
    x = np.concatenate([pos, np.abs(pos[..., 1:2])], -1)
    return pos, x


def test_full_width_layout_matches_reference():
    cfg = EasyConfig()
    cfg.load(CFG, recursive=True)
    model = build_model_from_cfg(cfg.model, device="cpu", seed=0)
    rows = json.load(open(LAYOUT))
    got = [[k, list(v.shape)] for k, v in model.state_dict().items()]
    assert got == rows
    assert sum(p.numel() for p in model.parameters()) == 1367119


def test_state_dict_from_jax_equals_export_reference():
    cfg = JaxConfig()
    cfg.load(CFG, recursive=True)
    model = jax_build(cfg.model)
    pos, x = _inputs(0, 2, 64)
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(pos),
                           jnp.asarray(x), training=False)
    variables = _randomize(variables, 1)
    head = variables["params"]["prediction"]
    assert np.abs(head["LinearBlock_0"]["Dense_0"]["bias"]).min() > 0
    rows = json.load(open(LAYOUT))
    ref, _ = export_reference_state_dict(variables, rows)
    got = state_dict_from_jax(variables, rows)
    assert list(got) == [k for k, _ in rows]
    for k, _ in rows:
        assert np.array_equal(got[k].numpy(), np.asarray(ref[k])), k
        assert got[k].numpy().dtype == np.asarray(ref[k]).dtype, k
    # and the port loads it as it is
    port = build_model_from_cfg(EasyConfig(cfg.model), device="cpu")
    port.load_state_dict(got)


def _pair(seed):
    """A JAX model + variables and the port model carrying the same weights."""
    cfg = _small_cfg()
    jmodel = jax_build(JaxConfig(cfg))
    pos, x = _inputs(seed, 2, 128)
    variables = jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(pos),
                            jnp.asarray(x), training=False)
    variables = _randomize(variables, seed + 1)
    port = build_model_from_cfg(EasyConfig(cfg), device="cpu").eval()
    rows = [[k, list(v.shape)] for k, v in port.state_dict().items()]
    port.load_state_dict(state_dict_from_jax(variables, rows))
    return jmodel, variables, port, pos, x


def test_unfused_logits_match_jax_xla():
    jmodel, variables, port, pos, x = _pair(0)
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(pos),
                                  jnp.asarray(x), training=False))
    with torch.no_grad():
        got = port(torch.from_numpy(pos), torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 5)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_fused_logits_match_jax_fused_eval(monkeypatch):
    monkeypatch.setenv("ADAPTPOINT_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.delenv("ADAPTPOINT_TPU_KERNELS", raising=False)
    jmodel, variables, port, pos, x = _pair(2)
    with fused_eval():
        ref = np.asarray(jmodel.apply(variables, jnp.asarray(pos),
                                      jnp.asarray(x), training=False))
    with torch.no_grad():
        got = port(torch.from_numpy(pos), torch.from_numpy(x),
                   fused_eval=True).numpy()
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("fused", [False, True])
def test_group_all_and_head_shapes(fused):
    """Every stage's output shape on the small model, both routes."""
    _, _, port, pos, x = _pair(4)
    with torch.no_grad():
        ps, fs = port.encoder.forward_seg_feat(
            torch.from_numpy(pos), torch.from_numpy(x), fused_eval=fused)
    assert [tuple(p.shape) for p in ps] == [(2, 128, 3), (2, 128, 3),
                                           (2, 64, 3), (2, 32, 3),
                                           (2, 32, 3)]
    assert [f.shape[-1] for f in fs] == [4, 16, 32, 64, 64]
    assert fs[-1].shape[1] == 1  # group-all pools to one row


def test_fused_weight_cache_follows_weight_changes():
    """The fused route caches the folded weights; changing a BN statistic in
    place or loading new weights must refold them."""
    _, _, port, pos, x = _pair(5)
    p, f = torch.from_numpy(pos), torch.from_numpy(x)
    with torch.no_grad():
        before = port(p, f, fused_eval=True)
        assert torch.equal(before, port(p, f, fused_eval=True))
        bn = port.encoder.encoder[1][0].convs[0].bn
        bn.running_mean.add_(0.5)
        changed = port(p, f, fused_eval=True)
        fresh = build_model_from_cfg(EasyConfig(_small_cfg()),
                                     device="cpu").eval()
        fresh.load_state_dict(port.state_dict())
        assert torch.equal(changed, fresh(p, f, fused_eval=True))
        assert not torch.equal(before, changed)
        port.load_state_dict(fresh.state_dict())
        bn.running_mean.sub_(0.5)
        assert torch.equal(port(p, f, fused_eval=True), before)
