"""The port's part-segmentation pieces against the JAX package, on the CPU.

- ``get_ins_mious`` and ``part_seg_refinement``: equal outputs.
- ``SyntheticPartSeg``, ``FormDatasetShapeNet``, and ``ShapeNetPart``,
  ``ShapeNetPartCurve``, ``ShapeNetPartNormal``, ``ShapeNetPartC`` on small
  files written to ``tmp_path``: equal samples bit for bit for the same
  per-sample generators; ``eval_corrupt_wrapper_shapenetc`` writes the same
  ``outcorruption.txt`` for the same per-split metrics.
- ``state_dict_from_jax`` equals ``export_reference_state_dict`` bit for bit
  on ``ref_layout_pointnext_s_partseg.json``, and the full-width port has
  exactly that layout.
- ``FeaturePropagation`` and ``BasePartSeg`` carry the same numpy weights in
  both packages and see the same inputs; JAX runs its XLA route, the port
  its plain versions. The FP outputs and the eval logits are held at rtol
  1e-4 / atol 2e-5 (readings: 6e-8 at worst). The 3-NN weights come from
  distances the two packages compute in other orders (JAX from the whole
  (N, M) distance matrix, the port from the gathered rows; 1e-6 apart in
  d^2 at these scales), and given the same indices and weights the f32
  weighted sum over the three neighbours is the port's ``(t0 + t1) + t2``
  bit for bit and within 2 ulp of the JAX composite's (XLA adds the three
  in another order): ``test_f32_interpolation_sum_order`` pins both.
- The train-mode forward (batch statistics, the head's dropout mask read
  off flax): logits within rtol 1e-4 plus 1e-4 of the largest logit, and no
  further from a float64 copy of the port than JAX's f32 logits are (plus
  1e-5 of the scale). Batch statistics over few rows (32 at the fifth
  stage of the 5-stage model) magnify f32 rounding: there JAX's logits sit
  up to 3.0e-4 from the float64 run and the port's 6e-5 (largest logit 6),
  and the two packages 2.7e-4 apart. BatchNorm running statistics rtol
  1e-4 / atol 1e-5 (the classifier's tests: 1e-5 / 1e-6 at three stages).
"""
import copy
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from adaptpoint_tpu.adapt.form_dataset import FormDatasetShapeNet as JaxFake
from adaptpoint_tpu.datasets import shapenetpart as jsp
from adaptpoint_tpu.datasets.synthetic import SyntheticPartSeg as JaxSynth
from adaptpoint_tpu.models import build_model_from_cfg as jax_build
from adaptpoint_tpu.models.backbone.pointnext import (
    FeaturePropagation as JaxFP)
from adaptpoint_tpu.utils import EasyConfig as JaxConfig
from adaptpoint_tpu.utils.partseg import (
    get_ins_mious as jax_ins_mious,
    part_seg_refinement as jax_refinement)
from adaptpoint_tpu.utils.torch_convert import export_reference_state_dict
from adaptpoint_tpu_torch import ops as pops
from adaptpoint_tpu_torch.adapt.form_dataset import (FormDatasetShapeNet,
                                                     Form_dataset_shapenet)
from adaptpoint_tpu_torch.datasets import shapenetpart as psp
from adaptpoint_tpu_torch.datasets.synthetic import SyntheticPartSeg
from adaptpoint_tpu_torch.models import build_model_from_cfg
from adaptpoint_tpu_torch.models.backbone.pointnext import FeaturePropagation
from adaptpoint_tpu_torch.utils import EasyConfig
from adaptpoint_tpu_torch.utils.convert import state_dict_from_jax
from adaptpoint_tpu_torch.utils.partseg import (get_ins_mious,
                                                part_seg_refinement)
from test_partseg import PARTSEG_CFG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYOUT = os.path.join(REPO, "tests", "fixtures",
                      "ref_layout_pointnext_s_partseg.json")
CFG = os.path.join(REPO, "cfgs/shapenetpart/pointnext-s.yaml")
TOL_FWD = dict(rtol=1e-4, atol=2e-5)
TOL_TRAIN = 1e-4  # rtol, and atol as a share of the largest logit
TOL_BN = (1e-4, 1e-5)


# ----------------------------------------------------------------- metrics

@pytest.mark.parametrize("multihead", [False, True])
def test_ins_mious_equal_jax(multihead):
    rng = np.random.default_rng(0)
    cls2parts = psp.CLS2PARTS
    cls = rng.integers(0, 16, 12)
    pred = rng.integers(0, 50, (12, 40))
    target = np.stack([rng.choice(cls2parts[c], 40) for c in cls])
    pred[:3] = target[:3]  # perfect shapes
    got = get_ins_mious(pred, target, cls, cls2parts, multihead)
    ref = jax_ins_mious(pred, target, cls, cls2parts, multihead)
    assert got == ref and len(got) == 12 and got[0] == 100.0


@pytest.mark.parametrize("n", [3, 10])
def test_part_seg_refinement_equals_jax(n):
    rng = np.random.default_rng(1)
    cls = rng.integers(0, 16, 6)
    pos = rng.standard_normal((6, 64, 3)).astype(np.float32)
    pred = np.stack([rng.choice(psp.CLS2PARTS[c], 64) for c in cls])
    pred[:, :5] = rng.integers(0, 50, (6, 5))  # strays out of category
    pred[5] = psp.CLS2PARTS[cls[5]][0]  # one label only: left alone
    got = part_seg_refinement(pred, pos, cls, psp.CLS2PARTS, n)
    ref = jax_refinement(pred, pos, cls, psp.CLS2PARTS, n)
    np.testing.assert_array_equal(got, ref)
    assert not np.array_equal(got, pred)
    np.testing.assert_array_equal(got[5], pred[5])


# -------------------------------------------------------------------- data

def _assert_samples_equal(port_ds, jax_ds, seeds=(0, 1)):
    assert len(port_ds) == len(jax_ds)
    for i in range(len(port_ds)):
        for s in seeds:
            got = port_ds.get(i, np.random.default_rng((s, i)))
            ref = jax_ds.get(i, np.random.default_rng((s, i)))
            assert sorted(got) == sorted(ref)
            for k in ref:
                a, b = np.asarray(got[k]), np.asarray(ref[k])
                assert a.dtype == b.dtype and np.array_equal(a, b), (i, k)


@pytest.mark.parametrize("split,size,points", [("train", 9, 64),
                                               ("val", 5, 128)])
def test_synthetic_partseg_equals_jax(split, size, points):
    port = SyntheticPartSeg(split=split, num_points=points, size=size, seed=4)
    ref = JaxSynth(split=split, num_points=points, size=size, seed=4)
    np.testing.assert_array_equal(port.points, ref.points)
    assert port.cls2parts == ref.cls2parts and port.num_classes == 8
    _assert_samples_equal(port, ref)


def test_form_dataset_shapenet_equals_jax():
    rng = np.random.default_rng(2)
    bufs = [[rng.standard_normal((4, 32, 3)).astype(np.float32)
             for _ in range(3)],
            [rng.integers(0, 50, (4, 32)) for _ in range(3)],
            [rng.random((4, 32, 1)).astype(np.float32) for _ in range(3)],
            [rng.integers(0, 16, (4,)) for _ in range(3)]]
    port, ref = FormDatasetShapeNet(*bufs), JaxFake(*bufs)
    assert Form_dataset_shapenet is FormDatasetShapeNet and len(port) == 12
    _assert_samples_equal(port, ref, seeds=(0,))
    with pytest.raises(ValueError):
        FormDatasetShapeNet(bufs[0], bufs[1][:2], bufs[2], bufs[3])


def _write_seg_h5(path, n, points, seed):
    import h5py
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, 16, n)
    with h5py.File(path, "w") as f:
        f["data"] = rng.standard_normal((n, points, 3)).astype(np.float32)
        f["label"] = cls[:, None].astype(np.uint8)
        f["pid"] = np.stack([rng.choice(psp.CLS2PARTS[c], points)
                             for c in cls]).astype(np.uint8)


@pytest.fixture
def shards(tmp_path):
    root = tmp_path / "shapenetpart"
    os.makedirs(root / "hdf5_data")
    for i, name in enumerate(["ply_data_train0", "ply_data_train1",
                              "ply_data_val0", "ply_data_test0"]):
        _write_seg_h5(root / "hdf5_data" / f"{name}.h5", 5, 48, i)
    return str(root)


@pytest.mark.parametrize("split", ["train", "trainval", "val", "test"])
def test_shapenetpart_equals_jax(shards, split):
    port = psp.ShapeNetPart(data_root=shards, num_points=40, split=split)
    ref = jsp.ShapeNetPart(data_root=shards, num_points=40, split=split)
    assert port.partition == ref.partition
    assert len(port) == (15 if split in ("train", "trainval") else 5)
    _assert_samples_equal(port, ref)
    with pytest.raises(FileNotFoundError):
        psp.ShapeNetPart(data_root=os.path.join(shards, "nowhere"))


@pytest.mark.parametrize("split,choice", [("train", None), ("test", "chair"),
                                          ("trainval", "airplane")])
def test_shapenetpart_curve_equals_jax(shards, split, choice):
    port = psp.ShapeNetPartCurve(data_root=shards, num_points=40,
                                 split=split, class_choice=choice)
    ref = jsp.ShapeNetPartCurve(data_root=shards, num_points=40, split=split,
                                class_choice=choice)
    assert (port.seg_num_all, port.seg_start_index) == (ref.seg_num_all,
                                                        ref.seg_start_index)
    _assert_samples_equal(port, ref)


@pytest.mark.parametrize("split", ["train", "test"])
def test_shapenetpart_normal_equals_jax(tmp_path, split):
    rng = np.random.default_rng(5)
    root = tmp_path / "normal"
    os.makedirs(root / "train_test_split")
    cats = {"Airplane": "02691156", "Chair": "03001627"}
    (root / "synsetoffset2category.txt").write_text(
        "".join(f"{k}\t{v}\n" for k, v in cats.items()))
    lists = {"train": [], "val": [], "test": []}
    for j, synset in enumerate(cats.values()):
        os.makedirs(root / synset)
        for i in range(4):
            name = f"shape{j}{i}"
            rows = np.concatenate([rng.standard_normal((30 + 10 * i, 6)),
                                   rng.integers(0, 4, (30 + 10 * i, 1))], 1)
            np.savetxt(root / synset / f"{name}.txt", rows)
            lists[["train", "val", "test", "test"][i]].append(
                f"shape_data/{synset}/{name}")
    for w, ids in lists.items():
        (root / "train_test_split" / f"shuffled_{w}_file_list.json"
         ).write_text(json.dumps(ids))
    port = psp.ShapeNetPartNormal(data_root=str(root), num_points=40,
                                  split=split)
    ref = jsp.ShapeNetPartNormal(data_root=str(root), num_points=40,
                                 split=split)
    assert len(port) == 4
    _assert_samples_equal(port, ref)


def test_shapenetpart_c_and_the_sweep_equal_jax(tmp_path):
    tree = tmp_path / "shapenet_c"
    os.makedirs(tree)
    splits = ["clean"] + [f"{c}_{lv}" for c in psp.SHAPENETC_CORRUPTIONS[1:]
                          for lv in range(5)]
    for i, split in enumerate(splits):
        _write_seg_h5(tree / f"{split}.h5", 3, 32, 10 + i)
    for split in ("clean", "jitter_3"):
        _assert_samples_equal(
            psp.ShapeNetPartC(data_dir=str(tree), split=split, num_points=24),
            jsp.ShapeNetPartC(data_dir=str(tree), split=split, num_points=24))

    def metrics(dataset_cls):
        def eval_fn(split, scale):
            ds = dataset_cls(data_dir=str(tree), split=split)
            pos = np.stack([ds.get(i, None)["pos"] for i in range(len(ds))])
            return {"acc": float(np.abs(pos).mean()) * scale,
                    "ins_miou": float(pos.max()), "cls_miou": float(pos[0, 0,
                                                                       0])}
        return eval_fn

    outs = {}
    for name, cls, wrapper in (("port", psp.ShapeNetPartC,
                                psp.eval_corrupt_wrapper_shapenetc),
                               ("jax", jsp.ShapeNetPartC,
                                jsp.eval_corrupt_wrapper_shapenetc)):
        out = tmp_path / name
        os.makedirs(out)
        outs[name] = (wrapper(metrics(cls), {"scale": 2.0}, str(out),
                              "E7"), (out / "outcorruption.txt").read_text())
    assert outs["port"] == outs["jax"]
    lines = outs["port"][1].splitlines()
    assert lines[0] == "epoch: E7" and len(lines) == 1 + 36 + 8
    with pytest.raises(FileNotFoundError):
        psp.ShapeNetPartC(data_dir=str(tree), split="nonesuch")


# ------------------------------------------------------------- conversion

def _randomize(variables, seed):
    """Non-trivial BN statistics/affines and biases, as numpy."""
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


def _inputs(seed, b, n):
    rng = np.random.default_rng(seed)
    pos = (rng.standard_normal((b, n, 3)) * 0.4).astype(np.float32)
    x = np.concatenate([pos, np.abs(pos[..., 1:2])], -1)
    return pos, x


def test_full_width_layout_matches_reference():
    cfg = EasyConfig()
    cfg.load(CFG, recursive=True)
    model = build_model_from_cfg(cfg.model, device="cpu", seed=0)
    rows = json.load(open(LAYOUT))
    assert [[k, list(v.shape)] for k, v in model.state_dict().items()] == rows
    assert sum(p.numel() for p in model.parameters()) == 890290


def test_state_dict_from_jax_equals_export_reference():
    cfg = JaxConfig()
    cfg.load(CFG, recursive=True)
    model = jax_build(cfg.model)
    pos, x = _inputs(0, 2, 128)
    variables = _randomize(model.init(
        jax.random.PRNGKey(0), jnp.asarray(pos), jnp.asarray(x),
        jnp.asarray([1, 3]), training=False), 1)
    dec = variables["params"]["decoder"]
    assert np.abs(dec["global_conv1"]["Dense_0"]["bias"]).min() > 0
    rows = json.load(open(LAYOUT))
    ref, _ = export_reference_state_dict(variables, rows)
    got = state_dict_from_jax(variables, rows)
    assert list(got) == [k for k, _ in rows]
    for k, _ in rows:
        assert np.array_equal(got[k].numpy(), np.asarray(ref[k])), k
        assert got[k].numpy().dtype == np.asarray(ref[k]).dtype, k
    port = build_model_from_cfg(EasyConfig(cfg.model), device="cpu")
    port.load_state_dict(got)


# ------------------------------------------------------- modules and model

def test_f32_interpolation_sum_order():
    """Same indices and weights: the port's sum is ``(t0 + t1) + t2`` bit
    for bit, the JAX composite's within 2 ulp of it."""
    rng = np.random.default_rng(6)
    unknown = torch.from_numpy(rng.standard_normal((2, 256, 3)).astype(
        np.float32) * 0.5)
    known = torch.from_numpy(rng.standard_normal((2, 64, 3)).astype(
        np.float32) * 0.5)
    feat = torch.from_numpy(rng.standard_normal((2, 64, 32)).astype(
        np.float32))
    got = pops.three_interpolation(unknown, known, feat)
    dist, idx = pops.three_nn(unknown, known)
    recip = 1.0 / (dist + 1e-8)
    w = recip / recip.sum(dim=2, keepdim=True)
    t = pops.index_points(feat, idx) * w[..., None]
    assert torch.equal(got, (t[:, :, 0] + t[:, :, 1]) + t[:, :, 2])
    ref = np.asarray(jnp.sum(jnp.asarray(t.numpy()), axis=2))
    scale = t.abs().sum(dim=2).numpy()
    assert (np.abs(got.numpy() - ref) <= 2 * 2.0 ** -23 * scale).all()


def _fp_state_dict(variables, mlp):
    """The port FP's state_dict from the JAX FP's variables."""
    sd = {}
    for j in range(len(mlp) - 1):
        p = variables["params"][f"ConvBlock_{j}"]
        s = variables["batch_stats"][f"ConvBlock_{j}"]["NormAct_0"][
            "BatchNorm_0"]
        bn = p["NormAct_0"]["BatchNorm_0"]
        sd[f"convs.{j}.0.weight"] = torch.from_numpy(np.ascontiguousarray(
            np.asarray(p["Dense_0"]["kernel"]).T)[..., None])
        sd[f"convs.{j}.1.weight"] = torch.from_numpy(np.asarray(bn["scale"]))
        sd[f"convs.{j}.1.bias"] = torch.from_numpy(np.asarray(bn["bias"]))
        sd[f"convs.{j}.1.running_mean"] = torch.from_numpy(
            np.asarray(s["mean"]))
        sd[f"convs.{j}.1.running_var"] = torch.from_numpy(
            np.asarray(s["var"]))
        sd[f"convs.{j}.1.num_batches_tracked"] = torch.tensor(0)
    return sd


@pytest.mark.parametrize("with_skip", [True, False])
def test_feature_propagation_matches_jax(with_skip):
    rng = np.random.default_rng(7)
    b, n, m, c1, c2 = 2, 96, 24, 8, 16
    p1 = (rng.standard_normal((b, n, 3)) * 0.4).astype(np.float32)
    p2 = p1[:, :m].copy()
    f1 = rng.standard_normal((b, n, c1)).astype(np.float32) \
        if with_skip else None
    f2 = rng.standard_normal((b, m, c2)).astype(np.float32)
    mlp = [(c1 if with_skip else 0) + c2, 24, 12]
    jfp = JaxFP(mlp)
    args = [jnp.asarray(p1), None if f1 is None else jnp.asarray(f1),
            jnp.asarray(p2), jnp.asarray(f2)]
    variables = _randomize(jfp.init(jax.random.PRNGKey(0), *args), 8)
    port = FeaturePropagation(mlp)
    port.load_state_dict(_fp_state_dict(variables, mlp))
    targs = [torch.from_numpy(p1), None if f1 is None else
             torch.from_numpy(f1), torch.from_numpy(p2), torch.from_numpy(f2)]
    port.eval()
    with torch.no_grad():
        got = port(*targs).numpy()
    ref = np.asarray(jfp.apply(variables, *args))
    assert got.shape == (b, n, 12)
    np.testing.assert_allclose(got, ref, **TOL_FWD)
    port.train()
    ref, upd = jfp.apply(variables, *args, training=True,
                         mutable=["batch_stats"])
    got = port(*targs).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(ref), **TOL_FWD)
    want = _fp_state_dict({"params": variables["params"],
                           "batch_stats": upd["batch_stats"]}, mlp)
    for k, v in port.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                       rtol=TOL_BN[0], atol=TOL_BN[1])


def _cfg_5stage(cls_map="curvenet"):
    """The real part-seg cfg's model at width 16 (five stages, two-layer
    residual SA stages, K = 32)."""
    cfg = JaxConfig()
    cfg.load(CFG, recursive=True)
    d = json.loads(json.dumps(dict(cfg.model)))
    d["encoder_args"]["width"] = 16
    d["encoder_args"]["radius"] = 0.15
    d["decoder_args"]["cls_map"] = cls_map
    d["cls_args"]["mlps"] = [32]
    return d


def _model_cfgs():
    pn2 = json.loads(json.dumps(PARTSEG_CFG))
    curve = json.loads(json.dumps(PARTSEG_CFG))
    curve["decoder_args"]["cls_map"] = "curvenet"
    return {"small-pointnet2": (pn2, 64, 4), "small-curvenet": (curve, 64, 4),
            "5stage-curvenet": (_cfg_5stage(), 256, 16)}


def _as(cls, node):
    if isinstance(node, dict):
        return cls({k: _as(cls, v) for k, v in node.items()})
    return node


def model_pair(cfg, n, shapes, seed, b=2):
    """A JAX BasePartSeg + numpy variables and the port model carrying the
    same weights, with inputs."""
    jmodel = jax_build(_as(JaxConfig, cfg))
    pos, x = _inputs(seed, b, n)
    cls = np.random.default_rng(seed).integers(0, shapes, b)
    variables = _randomize(jmodel.init(
        jax.random.PRNGKey(seed), jnp.asarray(pos), jnp.asarray(x),
        jnp.asarray(cls), training=False), seed + 1)
    port = build_model_from_cfg(_as(EasyConfig, cfg), device="cpu")
    rows = [[k, list(v.shape)] for k, v in port.state_dict().items()]
    port.load_state_dict(state_dict_from_jax(variables, rows))
    return jmodel, variables, port, rows, (pos, x, cls)


@pytest.mark.parametrize("name", list(_model_cfgs()))
def test_basepartseg_matches_jax(name):
    """Eval logits; then a train-mode forward with the head's dropout mask
    read off flax (what left the Dropout against what entered it) and the
    BatchNorm statistics it leaves."""
    cfg, n, shapes = _model_cfgs()[name]
    jmodel, variables, port, rows, (pos, x, cls) = model_pair(cfg, n, shapes,
                                                              3)
    args = [jnp.asarray(pos), jnp.asarray(x), jnp.asarray(cls)]
    targs = [torch.from_numpy(pos), torch.from_numpy(x),
             torch.from_numpy(cls)]
    port.eval()
    with torch.no_grad():
        got = port(*targs).numpy()
    ref = np.asarray(jmodel.apply(variables, *args, training=False))
    assert got.shape == ref.shape == (2, n, cfg["cls_args"]["num_classes"])
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
    assert 0.2 < (left != 0).mean() < 0.8
    keep = torch.from_numpy((left != 0) | (entered == 0))
    f64 = copy.deepcopy(port).double().train()
    port.train()
    got = port(*targs, dropout_mask=keep).detach().numpy()
    ref = np.asarray(ref)
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=TOL_TRAIN,
                               atol=TOL_TRAIN * scale)
    exact = f64(targs[0].double(), targs[1].double(), targs[2],
                dropout_mask=keep).detach().numpy()
    assert np.abs(got - exact).max() <= np.abs(ref - exact).max() \
        + 1e-5 * scale
    want = state_dict_from_jax({"params": variables["params"],
                                "batch_stats": state["batch_stats"]}, rows)
    checked = 0
    for k, v in port.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                       rtol=TOL_BN[0], atol=TOL_BN[1],
                                       err_msg=k)
            checked += 1
    assert checked > 10


def test_seg_head_global_feat_and_in_channels():
    """``global_feat`` widens the head's input per pool; ``BaseSeg`` takes
    the head's width from the decoder."""
    head = build_model_from_cfg(
        {"NAME": "SegHead", "num_classes": 5, "in_channels": 8,
         "mlps": [16, 12], "global_feat": "max,avg"}, device="cpu").eval()
    assert head.head[0].conv.in_channels == 24
    assert [type(m).__name__ for m in head.head] == [
        "ConvBlock", "ConvBlock", "Dropout", "ConvBlock"]
    f = torch.randn(2, 10, 8)
    out = head(f)
    x = torch.cat([f, f.amax(1, keepdim=True).expand_as(f),
                   f.mean(1, keepdim=True).expand_as(f)], -1)
    for layer in head.head:
        x = layer(x)
    assert torch.equal(out, x) and out.shape == (2, 10, 5)
    cfg = json.loads(json.dumps(PARTSEG_CFG))
    cfg["NAME"] = "BaseSeg"
    cfg["decoder_args"] = {"NAME": "PointNextDecoder", "decoder_stages": 2}
    seg = build_model_from_cfg(cfg, device="cpu")
    assert seg.decoder.out_channels == 16
    assert seg.head.head[0].conv.in_channels == 16


def test_base_seg_with_point_next_decoder_matches_jax():
    cfg = json.loads(json.dumps(PARTSEG_CFG))
    cfg["NAME"] = "BaseSeg"
    cfg["decoder_args"] = {"NAME": "PointNextDecoder", "decoder_stages": 3}
    jmodel = jax_build(_as(JaxConfig, cfg))
    pos, x = _inputs(11, 2, 64)
    variables = _randomize(jmodel.init(jax.random.PRNGKey(11),
                                       jnp.asarray(pos), jnp.asarray(x),
                                       training=False), 12)
    port = build_model_from_cfg(_as(EasyConfig, cfg), device="cpu").eval()
    rows = [[k, list(v.shape)] for k, v in port.state_dict().items()]
    assert rows[-1][0] == "head.head.2.0.bias"
    port.load_state_dict(state_dict_from_jax(variables, rows))
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(pos), jnp.asarray(x),
                                  training=False))
    with torch.no_grad():
        got = port(torch.from_numpy(pos), torch.from_numpy(x)).numpy()
    assert got.shape == (2, 64, 8)
    np.testing.assert_allclose(got, ref, **TOL_FWD)


def test_partseg_modules_are_covered_by_the_isolation_scan():
    from test_torch_isolation import FORBIDDEN, _imported_modules, _port_files
    scanned = {os.path.relpath(p, REPO) for p in _port_files()}
    for rel in ("adaptpoint_tpu_torch/partseg.py",
                "adaptpoint_tpu_torch/engine/partseg_main.py",
                "adaptpoint_tpu_torch/models/segmentation/base_seg.py",
                "adaptpoint_tpu_torch/datasets/shapenetpart.py",
                "adaptpoint_tpu_torch/utils/partseg.py"):
        assert rel in scanned, rel
        for mod in _imported_modules(os.path.join(REPO, rel)):
            assert mod.split(".")[0] not in FORBIDDEN + ("h5py",), (rel, mod)
