"""The port's serving layer (adaptpoint_tpu_torch.serving) on a tiny CPU model:
bucket routing, padding and chunking, single-cloud input, the HTTP contract,
export -> load, and ``preprocess_clouds`` against the JAX package's."""
import io
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from adaptpoint_tpu.serving.artifact import preprocess_clouds as jax_preprocess
from adaptpoint_tpu_torch.models import build_model_from_cfg
from adaptpoint_tpu_torch.serving import (ServingModel,
                                          export_serving_artifact,
                                          preprocess_clouds)
from adaptpoint_tpu_torch.serving.server import make_server

N_POINTS = 64


def _tiny_cfg():
    return {
        "NAME": "BaseCls",
        "encoder_args": {
            "NAME": "PointNextEncoder",
            "blocks": [1, 1, 1, 1], "strides": [1, 2, 2, 1], "width": 8,
            "in_channels": 4, "sa_layers": 2, "sa_use_res": True,
            "radius": 0.4, "radius_scaling": 1.5, "nsample": 8,
            "group_args": {"NAME": "ballquery", "normalize_dp": True},
            "norm_args": {"norm": "bn"},
        },
        "cls_args": {"NAME": "ClsHead", "num_classes": 3, "mlps": [16],
                     "norm_args": {"norm": "bn1d"}},
    }


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    model = build_model_from_cfg(_tiny_cfg(), device="cpu", seed=3).eval()
    out = str(tmp_path_factory.mktemp("artifact"))
    manifest = export_serving_artifact(model, out, num_points=N_POINTS,
                                       in_channels=4, batch_sizes=(4, 1))
    return model, out, manifest


def _clouds(n, seed=0, extra_points=0):
    rng = np.random.default_rng(seed)
    xyz = rng.standard_normal((n, N_POINTS + extra_points, 3)) * 0.5
    return preprocess_clouds(xyz.astype(np.float32))


def _direct(model, x):
    with torch.no_grad():
        t = torch.from_numpy(np.ascontiguousarray(x[:, :N_POINTS]))
        return model(t[..., :3].contiguous(), t[..., :4].contiguous()).numpy()


def test_manifest(artifact):
    _, path, manifest = artifact
    assert manifest["format"] == "adaptpoint-tpu-torch-serving-v1"
    assert manifest["batch_sizes"] == [1, 4]
    assert manifest["num_classes"] == 3 and manifest["fused_eval"] is False
    assert manifest["cfg"]["encoder_args"]["width"] == 8
    with open(f"{path}/manifest.json") as f:
        assert json.load(f) == manifest


def test_export_then_load_same_logits(artifact):
    model, path, _ = artifact
    sm = ServingModel(path, device="cpu")
    x = _clouds(4, seed=1)
    np.testing.assert_allclose(sm.predict(x), _direct(model, x), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("n,buckets", [(1, [1]), (3, [4]), (4, [4]),
                                       (6, [4, 4]), (9, [4, 4, 1])])
def test_bucket_routing_padding_chunking(artifact, n, buckets):
    model, path, _ = artifact
    sm = ServingModel(path, device="cpu")
    seen = []
    infer = sm.infer
    sm.infer = lambda x: seen.append(x.shape[0]) or infer(x)
    x = _clouds(n, seed=n, extra_points=5)  # longer clouds are cut to N
    logits = sm.predict(x)
    assert seen == buckets
    assert logits.shape == (n, 3)
    # padding rows never perturb real rows: per-cloud forwards agree
    want = np.concatenate([_direct(model, x[i:i + 1]) for i in range(n)])
    np.testing.assert_allclose(logits, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(sm.predict_labels(x), want.argmax(-1))


def test_single_cloud_and_shape_errors(artifact):
    model, path, _ = artifact
    sm = ServingModel(path, device="cpu")
    x = _clouds(1, seed=5)
    one = sm.predict(x[0])
    assert one.shape == (3,)
    np.testing.assert_allclose(one, _direct(model, x)[0], rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(ValueError):
        sm.predict(np.zeros((2, N_POINTS - 1, 4), np.float32))
    with pytest.raises(ValueError):
        sm.predict(np.zeros((2, N_POINTS, 3), np.float32))
    with pytest.raises(ValueError):
        sm.predict(np.zeros((N_POINTS, 4, 2), np.float32))


def test_not_an_artifact(tmp_path):
    (tmp_path / "manifest.json").write_text(json.dumps({"format": "x"}))
    with pytest.raises(ValueError):
        ServingModel(str(tmp_path), device="cpu")


def test_http_round_trip(artifact):
    model, path, _ = artifact
    sm = ServingModel(path, device="cpu")
    srv = make_server(sm, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        health = json.load(urllib.request.urlopen(f"{base}/healthz"))
        assert health["ok"] and health["batch_sizes"] == [1, 4]
        assert health["num_classes"] == 3
        x = _clouds(2, seed=7)
        want = _direct(model, x)
        buf = io.BytesIO()
        np.save(buf, x)
        req = urllib.request.Request(f"{base}/predict?logits=1",
                                     data=buf.getvalue(), method="POST")
        out = json.load(urllib.request.urlopen(req))
        assert out["labels"] == want.argmax(-1).tolist()
        np.testing.assert_allclose(np.asarray(out["logits"]), want,
                                   rtol=1e-5, atol=1e-5)
        raw = np.random.default_rng(7).standard_normal(
            (2, N_POINTS, 3)).astype(np.float32) * 0.5
        body = json.dumps({"points": raw.tolist(), "preprocess": True})
        req = urllib.request.Request(f"{base}/predict", data=body.encode(),
                                     method="POST")
        out = json.load(urllib.request.urlopen(req))
        assert out["labels"] == want.argmax(-1).tolist()
        assert "logits" not in out
        bad = urllib.request.Request(f"{base}/predict",
                                     data=b'{"points": [[1, 2]]}',
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(bad)
        assert e.value.code == 400
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join()


@pytest.mark.parametrize("gravity_dim,append_height", [(1, True), (2, False)])
def test_preprocess_matches_jax(gravity_dim, append_height):
    xyz = np.random.default_rng(9).standard_normal((3, 50, 3)) * 2 + 1
    got = preprocess_clouds(xyz, gravity_dim=gravity_dim,
                            append_height=append_height)
    ref = jax_preprocess(xyz, gravity_dim=gravity_dim,
                         append_height=append_height)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(preprocess_clouds(xyz[0]), jax_preprocess(
        xyz[0]))
