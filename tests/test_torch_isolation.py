"""The port stands alone and never runs on the CPU unless asked.

- No module of adaptpoint_tpu_torch, and not chip_smoke.py, imports jax,
  flax or adaptpoint_tpu (module names matched exactly: the port's own name
  shares the prefix).
- Entry points asked for their default device raise without a GPU.
- The CUDA wrappers raise on a CPU tensor instead of falling back.
"""
import ast
import importlib
import os
import shutil
import subprocess
import sys

import pytest
import torch

from adaptpoint_tpu_torch import ops, resolve_device
from adaptpoint_tpu_torch.models import build_model_from_cfg
from adaptpoint_tpu_torch.ops import (attention, ballgroup, ballgroup_max,
                                      fpinterp, fpsample, gather, knn,
                                      saeval, satrainbn, window)
from adaptpoint_tpu_torch.serving import ServingModel, export_serving_artifact

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "adaptpoint_tpu")


def _port_files():
    root = os.path.join(REPO, "adaptpoint_tpu_torch")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, names in os.walk(root):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return files


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                    "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


def test_no_jax_imports_in_the_port():
    files = _port_files()
    assert len(files) > 20 and os.path.exists(files[0])
    bad = []
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            if top in FORBIDDEN:
                bad.append((os.path.relpath(path, REPO), mod))
    assert not bad, bad


NEW_MODULES = ["adapt", "adapt.augmentor", "adapt.build", "adapt.common",
               "adapt.discriminator", "adapt.feedback", "adapt.form_dataset",
               "adapt.pointwolf", "ops.attention", "ops.knn",
               "ops.ballgroup_max", "ops.saeval", "engine.adapt_trainer"]


def test_phase_a_modules_are_covered_and_import_without_a_toolchain():
    """The adversarial step's modules are among the scanned files, import
    nothing forbidden, and importing them on the CPU needs neither ``triton``
    nor ``nvcc``: kernels are built inside the call that launches them."""
    scanned = {os.path.relpath(p, os.path.join(REPO, "adaptpoint_tpu_torch"))
               for p in _port_files()[1:]}
    for name in NEW_MODULES:
        rel = name.replace(".", os.sep)
        assert rel + ".py" in scanned or os.path.join(
            rel, "__init__.py") in scanned, name
        mod = importlib.import_module("adaptpoint_tpu_torch." + name)
        for imported in _imported_modules(mod.__file__):
            assert imported.split(".")[0] not in FORBIDDEN, (name, imported)
    assert "triton" not in sys.modules
    if shutil.which("nvcc") is None and not os.path.exists(
            "/usr/local/cuda/bin/nvcc"):
        from adaptpoint_tpu_torch.ops import _build
        assert {"attention", "knn", "ballgroup_max",
                "sa_train_bwd"} <= set(_build.SOURCES)
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.load("knn")
    for src in ("attention.cu", "knn.cu", "ballgroup_max.cu",
                "sa_train_bwd.cu", "sa_common.cuh"):
        text = open(os.path.join(REPO, "adaptpoint_tpu_torch", "ops", "csrc",
                                 src)).read()
        assert "torch/" not in text
        assert 'extern "C"' in text or src.endswith(".cuh")


SLICE3_MODULES = ["ops.satrainbn", "datasets", "datasets.build",
                  "datasets.loader", "datasets.data_util",
                  "datasets.scanobjectnn", "datasets.synthetic",
                  "transforms", "transforms.transforms_factory",
                  "transforms.point_transforms", "metricslog",
                  "utils.logger", "utils.random", "utils.ckpt",
                  "engine.cls_main", "main"]


def test_mode_train_modules_are_covered_and_import_without_a_toolchain():
    """The ``mode: train`` entry path's modules and the train-BN kernels'
    are among the scanned files, import nothing forbidden, and import on the
    CPU without ``nvcc`` or ``h5py`` (read only when a file is opened);
    the kernel source has a plain C interface."""
    scanned = {os.path.relpath(p, os.path.join(REPO, "adaptpoint_tpu_torch"))
               for p in _port_files()[1:]}
    for name in SLICE3_MODULES:
        rel = name.replace(".", os.sep)
        assert rel + ".py" in scanned or os.path.join(
            rel, "__init__.py") in scanned, name
        mod = importlib.import_module("adaptpoint_tpu_torch." + name)
        for imported in _imported_modules(mod.__file__):
            assert imported.split(".")[0] not in FORBIDDEN, (name, imported)
    from adaptpoint_tpu_torch.ops import _build
    assert "satrainbn" in _build.SOURCES
    text = open(os.path.join(REPO, "adaptpoint_tpu_torch", "ops", "csrc",
                             "satrainbn.cu")).read()
    assert "torch/" not in text and 'extern "C"' in text
    for name in ("datasets.data_util", "datasets.scanobjectnn"):
        mod = importlib.import_module("adaptpoint_tpu_torch." + name)
        tree = ast.parse(open(mod.__file__).read())
        top = [n for n in tree.body if isinstance(n, (ast.Import,
                                                      ast.ImportFrom))]
        assert not any("h5py" in ast.unparse(n) for n in top), name


SLICE4_MODULES = ["ops.window", "engine.adapt_main", "engine.adapt_trainer",
                  "datasets.scanobjectnn", "metricslog", "main"]


def test_adaptpoint_modules_are_covered_and_import_without_a_toolchain():
    """The windowed op's and the ``mode: adaptpoint`` entry path's modules
    are among the scanned files, import nothing forbidden, and import on
    the CPU without ``nvcc`` or ``h5py`` (the fake-cloud dumps and the
    corruption splits import it when they write or read a file); the
    windowed kernels' source has a plain C interface and is built."""
    scanned = {os.path.relpath(p, os.path.join(REPO, "adaptpoint_tpu_torch"))
               for p in _port_files()[1:]}
    for name in SLICE4_MODULES:
        rel = name.replace(".", os.sep)
        assert rel + ".py" in scanned or os.path.join(
            rel, "__init__.py") in scanned, name
        mod = importlib.import_module("adaptpoint_tpu_torch." + name)
        for imported in _imported_modules(mod.__file__):
            assert imported.split(".")[0] not in FORBIDDEN, (name, imported)
        tree = ast.parse(open(mod.__file__).read())
        top = [n for n in tree.body if isinstance(n, (ast.Import,
                                                      ast.ImportFrom))]
        assert not any("h5py" in ast.unparse(n) for n in top), name
    from adaptpoint_tpu_torch.ops import _build
    assert "window" in _build.SOURCES
    text = open(os.path.join(REPO, "adaptpoint_tpu_torch", "ops", "csrc",
                             "window.cu")).read()
    assert "torch/" not in text and 'extern "C"' in text
    if shutil.which("nvcc") is None and not os.path.exists(
            "/usr/local/cuda/bin/nvcc"):
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.load("window")


SPHERE_MODULES = ["ops.cpu", "ops.cpu.kdtree_knn", "ops.cpu.grid_subsample",
                  "datasets.s3dis", "datasets.vis3d", "engine.seg_main",
                  "loss", "transforms.point_transforms", "seg"]


def test_the_host_libraries_are_the_ports_own():
    """The sphere protocol's modules are among the scanned files and import
    nothing forbidden. No file of the port names the JAX package's C++
    directory (``adaptpoint_tpu/cpp``) or its libraries; the host kd-tree
    and grid subsampling compile from the port's own sources
    (``ops/cpu/*.cpp``) into ``build/adaptpoint_tpu_torch``, and a process
    that uses them loads no library of the JAX package."""
    scanned = {os.path.relpath(p, os.path.join(REPO, "adaptpoint_tpu_torch"))
               for p in _port_files()[1:]}
    for name in SPHERE_MODULES:
        rel = name.replace(".", os.sep)
        assert rel + ".py" in scanned or os.path.join(
            rel, "__init__.py") in scanned, name
        for imported in _imported_modules(importlib.import_module(
                "adaptpoint_tpu_torch." + name).__file__):
            assert imported.split(".")[0] not in FORBIDDEN, (name, imported)
    sources = [os.path.join(d, n) for d, _, names in os.walk(
        os.path.join(REPO, "adaptpoint_tpu_torch")) for n in names
        if n.endswith((".py", ".cpp", ".cu", ".cuh"))]
    sources.append(os.path.join(REPO, "chip_smoke.py"))
    bad = [(os.path.relpath(p, REPO), needle) for p in sources
           for needle in ("adaptpoint_tpu/cpp", "adaptpoint_tpu\\cpp",
                          "libkdtreeknn", "libgridsubsample")
           if needle in open(p).read()]
    assert not bad, bad
    for name in ("kdtree_knn.cpp", "grid_subsampling.cpp"):
        text = open(os.path.join(REPO, "adaptpoint_tpu_torch", "ops", "cpu",
                                 name)).read()
        assert 'extern "C"' in text and "torch/" not in text
    probe = ("import numpy as np, sys\n"
             "from adaptpoint_tpu_torch.ops.cpu import KDTree, "
             "grid_subsample\n"
             "p = np.random.default_rng(0).random((500, 3), np.float32)\n"
             "KDTree(p).query(p[:4], 2); grid_subsample(p, None, 0.1)\n"
             "print(sorted(m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'flax', 'adaptpoint_tpu')))\n"
             "print(open('/proc/self/maps').read())\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, text=True,
                         capture_output=True, check=True).stdout
    first, maps = out.split("\n", 1)
    assert first == "[]"
    assert "adaptpoint_tpu/cpp" not in maps
    for lib in ("libkdtree_knn-", "libgrid_subsampling-"):
        assert os.path.join("build", "adaptpoint_tpu_torch", lib) in maps


def test_port_tests_leave_the_environment_as_they_found_it():
    """The JAX package reads ``ADAPTPOINT_TPU_*`` when it traces, and the
    whole suite may share one process: the port's tests set such a variable
    through ``monkeypatch`` / ``pytest.MonkeyPatch`` only, which restores it,
    and never assign into ``os.environ``."""
    tests = os.path.join(REPO, "tests")
    files = [n for n in os.listdir(tests)
             if n.startswith("test_torch_") and n.endswith(".py")]
    assert len(files) >= 10
    bad = []
    for name in files:
        for node in ast.walk(ast.parse(open(os.path.join(tests, name)).read())):
            targets = node.targets if isinstance(node, ast.Assign) else \
                [node.target] if isinstance(node, ast.AugAssign) else []
            calls = [node.func] if isinstance(node, ast.Call) else []
            for t in targets:
                if isinstance(t, ast.Subscript) and \
                        ast.unparse(t.value) == "os.environ":
                    bad.append((name, node.lineno))
            for f in calls:
                if ast.unparse(f) in ("os.environ.update", "os.putenv",
                                      "os.environ.setdefault",
                                      "os.environ.pop"):
                    bad.append((name, node.lineno))
    assert not bad, bad


VIT_MODULES = ["models.backbone.pointvit", "models.layers.kmeans",
               "models.classification.cls_base", "models.build",
               "utils.convert", "ops.attention"]


def test_pointvit_modules_are_covered_and_run_on_the_card_by_default(
        monkeypatch):
    """PointViT's modules (and the k-means, the converter's rules, the
    attention check's allowance) are among the scanned files and import
    nothing forbidden; building ``cfgs/scanobjectnn/pointvit.yaml``'s model
    with the default device raises without a GPU, and its CPU forward needs
    neither ``triton`` nor ``nvcc``."""
    from adaptpoint_tpu_torch.utils import EasyConfig
    scanned = {os.path.relpath(p, os.path.join(REPO, "adaptpoint_tpu_torch"))
               for p in _port_files()[1:]}
    for name in VIT_MODULES:
        assert name.replace(".", os.sep) + ".py" in scanned, name
        for imported in _imported_modules(importlib.import_module(
                "adaptpoint_tpu_torch." + name).__file__):
            assert imported.split(".")[0] not in FORBIDDEN, (name, imported)
    cfg = EasyConfig()
    cfg.load(os.path.join(REPO, "cfgs", "scanobjectnn", "pointvit.yaml"),
             recursive=True)
    cfg.model.encoder_args.update({"embed_dim": 24, "depth": 1,
                                   "num_heads": 2, "num_groups": 8,
                                   "group_size": 4})
    model = build_model_from_cfg(cfg.model, device="cpu").eval()
    with torch.no_grad():
        out = model(torch.rand(2, 64, 3), torch.rand(2, 64, 4))
    assert out.shape == (2, 15) and "triton" not in sys.modules
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        build_model_from_cfg(cfg.model)


def _tiny_cfg():
    return {"NAME": "BaseCls",
            "encoder_args": {"NAME": "PointNextEncoder", "blocks": [1, 1],
                             "strides": [1, 2], "width": 8, "in_channels": 4,
                             "sa_layers": 2, "sa_use_res": True,
                             "radius": 0.4, "nsample": 4},
            "cls_args": {"NAME": "ClsHead", "num_classes": 2, "mlps": [8],
                         "norm_args": {"norm": "bn1d"}}}


def test_default_device_raises_without_gpu(monkeypatch, tmp_path):
    model = build_model_from_cfg(_tiny_cfg(), device="cpu")
    export_serving_artifact(model, str(tmp_path), num_points=16,
                            in_channels=4, batch_sizes=(1,))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        build_model_from_cfg(_tiny_cfg())
    with pytest.raises(RuntimeError):
        ServingModel(str(tmp_path))
    assert ServingModel(str(tmp_path), device="cpu").device.type == "cpu"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_cuda_wrappers_raise_on_cpu_tensors():
    xyz = torch.zeros(1, 16, 3)
    q = torch.zeros(1, 4, dtype=torch.int32)
    f = torch.zeros(1, 16, 5)
    w1, b1 = torch.zeros(8, 6), torch.zeros(6)
    w2, b2 = torch.zeros(6, 7), torch.zeros(7)
    idx = torch.zeros(1, 4, 4, dtype=torch.int32)
    before = ops.launch_counts()
    with pytest.raises(ValueError):
        fpsample.furthest_point_sample_cuda(xyz, 4)
    with pytest.raises(ValueError):
        ballgroup.ball_group_cuda(0.3, 4, xyz, q, f)
    with pytest.raises(ValueError):
        ballgroup.ball_group_bwd_cuda(0.3, idx, q, torch.zeros(1, 4, 3),
                                      torch.zeros(1, 4, 5),
                                      torch.zeros(1, 4, 4, 8), 16)
    with pytest.raises(ValueError):
        gather.gather_rows_cuda(f, q)
    with pytest.raises(ValueError):
        gather.gather_rows_bwd_cuda(torch.zeros(1, 4, 5), q, 16)
    with pytest.raises(ValueError):
        saeval.sa_eval_cuda(0.3, 4, xyz, q, f, w1, b1, w2, b2)
    qkv = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError):
        attention.mha_cuda(qkv, qkv, qkv, 4.0)
    with pytest.raises(ValueError):
        attention.mha_bwd_cuda(qkv, qkv, qkv, 4.0, qkv, (qkv, qkv, qkv))
    with pytest.raises(ValueError):
        knn.knn_idx_cuda(3, xyz, xyz)
    with pytest.raises(ValueError):
        ballgroup_max.ball_group_max_cuda(0.3, 4, xyz, q, f)
    u8 = torch.zeros(1, 4, 5, dtype=torch.uint8)
    with pytest.raises(ValueError):
        ballgroup_max.ball_group_max_bwd_cuda(idx, q, u8, u8, None, None,
                                              torch.zeros(1, 4, 5), None, 16)
    packed = saeval.pack_weights(w1, b1, w2, b2)
    with pytest.raises(ValueError):
        saeval.sa_train_cuda(0.3, 4, xyz, q, f, packed)
    with pytest.raises(ValueError):
        saeval.sa_train_bwd_cuda(0.3, xyz, q, f, packed, idx,
                                 torch.zeros(1, 4, 7, dtype=torch.uint8),
                                 None, None, torch.zeros(1, 4, 7))
    fb = torch.zeros(1, 16, 5, dtype=torch.bfloat16)
    idx3 = torch.zeros(1, 4, 3, dtype=torch.int32)
    with pytest.raises(ValueError):
        fpinterp.weighted_gather3_cuda(fb, idx3, torch.zeros(1, 4, 3))
    with pytest.raises(ValueError):
        fpinterp.weighted_gather3_bwd_cuda(fb, idx3, torch.zeros(1, 4, 3),
                                           torch.zeros(1, 4, 5))
    prep = window.window_prep(xyz, q, 0.3, 4, 128)
    with pytest.raises(ValueError):
        window.ball_group_max_windowed_cuda(0.3, 4, xyz, q, f, prep, 128, 4)
    u8w = torch.zeros(1, 4, 5, dtype=torch.uint8)
    cnt = torch.zeros(1, 4, dtype=torch.int32)
    with pytest.raises(ValueError):
        window.ball_group_max_windowed_bwd_cuda(idx, cnt, cnt, u8w, u8w, None,
                                                None, torch.zeros(1, 4, 5),
                                                None, 16)
    sa_idx = torch.zeros(1, 4, 4, dtype=torch.int32)
    vec6, vec7 = torch.zeros(6), torch.zeros(7)
    with pytest.raises(ValueError):
        satrainbn.stats_cuda(0.3, 4, xyz, q, f)
    with pytest.raises(ValueError):
        satrainbn.fwd_cuda(0.3, xyz, q, f, sa_idx, w1, vec6, vec6, w2)
    with pytest.raises(ValueError):
        satrainbn.bwd_w2_cuda(0.3, xyz, q, f, sa_idx, w1, vec6, vec6, w2,
                              vec6, vec6, vec7, vec7, vec7,
                              torch.zeros(1, 4, 7, dtype=torch.uint8),
                              torch.zeros(1, 4, 7),
                              torch.zeros(1, 1, 4, 4, dtype=torch.int32),
                              torch.zeros(6 * 8 + 7 * 8))
    with pytest.raises(ValueError):
        satrainbn.bwd_x_cuda(0.3, xyz, q, f, sa_idx, w1,
                             torch.zeros(1, 4, 4, 6), torch.zeros(1, 4, 4, 6),
                             vec6, vec6, vec6)
    # the dispatching ops take the plain versions on CPU tensors and never
    # count a launch, forward or backward
    ops.furthest_point_sample(xyz, 4)
    ops.sa_eval(0.3, 4, xyz, q, f, w1, b1, w2, b2)
    fg = f.clone().requires_grad_()
    out = ops.ball_group(0.3, 4, xyz, q, fg)
    pooled = ops.ball_group_max(0.3, 4, xyz, q, fg)
    windowed = ops.ball_group_max_windowed(0.3, 4, xyz, q, fg, tm=4)
    fused = ops.sa_train(0.3, 4, xyz, q, fg, w1, b1, w2, b2)
    trainbn = ops.sa_trainbn(0.3, 4, xyz, q, fg, w1, torch.ones(6), b1, w2,
                             torch.ones(7), b2)
    qg = qkv.clone().requires_grad_()
    (out[1].sum() + out[2].sum() + pooled[2].sum() + pooled[3].sum()
     + windowed[2].sum() + windowed[3].sum()
     + fused[2].sum() + trainbn[2].sum() + ops.gather_rows(fg, q).sum()
     + ops.fps(fg, 4).sum() + ops.index_points(fg, idx).sum()
     + ops.three_interpolation(xyz, xyz[:, :8], fg[:, :8]).sum()
     + ops.three_interpolation(xyz, xyz[:, :8],
                               fg[:, :8].bfloat16()).sum()
     + ops.fused_self_attention(qg, qg, qg, 4.0).sum()).backward()
    ops.knn_point(3, xyz, xyz)
    assert fg.grad is not None and qg.grad is not None
    assert ops.launch_counts() == before
    assert set(before) == {"fps", "ball_group", "ball_group_bwd",
                           "ball_group_max", "ball_group_max_bwd",
                           "ball_group_max_windowed",
                           "ball_group_max_windowed_bwd", "sa_eval",
                           "sa_train", "sa_train_bwd", "gather_rows",
                           "gather_rows_bwd", "mha", "mha_bwd", "knn",
                           "knn_tiled", "fpinterp", "fpinterp_bwd", "sa_trainbn_stats",
                           "sa_trainbn_fwd", "sa_trainbn_bwd_w2",
                           "sa_trainbn_bwd_x"}
    assert not any(before.values())


def test_cuda_wrappers_refuse_to_drop_gradients():
    """The fused eval SA kernel has no backward: a call that needs one raises
    rather than returning outputs detached from the features. The ball group
    has one now (``BallGroup``), so its forward wrapper no longer refuses a
    tensor that requires grad; on CPU tensors it still raises, inside and
    outside ``no_grad``."""
    xyz = torch.zeros(1, 16, 3)
    q = torch.zeros(1, 4, dtype=torch.int32)
    f = torch.zeros(1, 16, 5, requires_grad=True)
    with pytest.raises(ValueError):  # not CUDA; no longer NotImplementedError
        ballgroup.ball_group_cuda(0.3, 4, xyz, q, f)
    with pytest.raises(NotImplementedError):
        saeval.sa_eval_cuda(0.3, 4, xyz, q, f, torch.zeros(8, 6),
                            torch.zeros(6), torch.zeros(6, 7), torch.zeros(7))
    with torch.no_grad(), pytest.raises(ValueError):  # then: not CUDA
        ballgroup.ball_group_cuda(0.3, 4, xyz, q, f)
    with pytest.raises(ValueError):
        ballgroup.BallGroup.apply(xyz, q, f, 0.3, 4, True, False)
    with pytest.raises(ValueError):
        gather.GatherRows.apply(f, q)
    with pytest.raises(ValueError):
        ballgroup_max.BallGroupMax.apply(xyz, q, f, 0.3, 4, True)
    with pytest.raises(ValueError):
        window.BallGroupMaxWindowed.apply(xyz, q, f, 0.3, 4, 1, 1, 4, 128,
                                          True)
    with pytest.raises(ValueError):
        saeval.SaTrain.apply(xyz, q, f, torch.zeros(8, 6), torch.zeros(6),
                             torch.zeros(6, 7), torch.zeros(7), 0.3, 4, True,
                             False, None, True)
    with pytest.raises(ValueError):
        satrainbn.SaTrainBN.apply(xyz, q, f, torch.zeros(8, 6),
                                  torch.ones(6), torch.zeros(6),
                                  torch.zeros(6, 7), torch.ones(7),
                                  torch.zeros(7), 0.3, 4, True, False, 1e-5,
                                  True)
