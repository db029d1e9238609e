"""The port stands alone and never runs on the CPU unless asked.

- No module of adaptpoint_tpu_torch, and not chip_smoke.py, imports jax,
  flax or adaptpoint_tpu (module names matched exactly: the port's own name
  shares the prefix).
- Entry points asked for their default device raise without a GPU.
- The CUDA wrappers raise on a CPU tensor instead of falling back.
"""
import ast
import os

import pytest
import torch

from adaptpoint_tpu_torch import ops, resolve_device
from adaptpoint_tpu_torch.models import build_model_from_cfg
from adaptpoint_tpu_torch.ops import ballgroup, fpsample, gather, saeval
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
    # the dispatching ops take the plain versions on CPU tensors and never
    # count a launch, forward or backward
    ops.furthest_point_sample(xyz, 4)
    ops.sa_eval(0.3, 4, xyz, q, f, w1, b1, w2, b2)
    fg = f.clone().requires_grad_()
    out = ops.ball_group(0.3, 4, xyz, q, fg)
    (out[1].sum() + out[2].sum() + ops.gather_rows(fg, q).sum()
     + ops.fps(fg, 4).sum()).backward()
    assert fg.grad is not None
    assert ops.launch_counts() == before
    assert set(before) == {"fps", "ball_group", "ball_group_bwd", "sa_eval",
                           "gather_rows", "gather_rows_bwd"}
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
