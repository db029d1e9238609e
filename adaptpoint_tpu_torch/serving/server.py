"""Dependency-free HTTP inference server over a serving artifact.

Counterpart of ``adaptpoint_tpu/serving/server.py``, with the same contract:

- ``GET /healthz`` -> ``{"ok": true, "model": ..., "batch_sizes": [...]}``
- ``POST /predict`` -> ``{"labels": [...], "logits": [[...]]}`` (logits only
  when ``?logits=1``). Body is either a ``.npy`` payload (magic-sniffed;
  ``numpy.save`` of a ``(n, N, C)`` float array) or JSON
  ``{"points": [[[x,y,z,...], ...], ...], "preprocess": false}``. With
  ``preprocess`` true the body carries raw xyz clouds and the server applies
  :func:`adaptpoint_tpu_torch.serving.preprocess_clouds` first.

Single-flight: requests serialize through one lock; batching happens inside
:class:`ServingModel` (bucket routing + chunking).
"""
from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from .artifact import ServingModel, preprocess_clouds

__all__ = ["make_server", "serve_forever"]


def _parse_body(body: bytes):
    """Returns (clouds float32 array, preprocess flag)."""
    if body[:6] == b"\x93NUMPY":
        return np.load(io.BytesIO(body), allow_pickle=False), False
    payload = json.loads(body.decode("utf-8"))
    return (np.asarray(payload["points"], np.float32),
            bool(payload.get("preprocess", False)))


def make_server(model: ServingModel, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _reply(self, code: int, obj) -> None:
            data = json.dumps(obj).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if urlparse(self.path).path != "/healthz":
                return self._reply(404, {"error": "not found"})
            self._reply(200, {"ok": True,
                              "model": model.manifest.get("model_name", ""),
                              "num_points": model.num_points,
                              "in_channels": model.in_channels,
                              "num_classes": model.num_classes,
                              "batch_sizes": model.batch_sizes,
                              "fused_eval": model.fused_eval,
                              "device": str(model.device)})

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/predict":
                return self._reply(404, {"error": "not found"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                clouds, preprocess = _parse_body(self.rfile.read(n))
                if preprocess:
                    clouds = preprocess_clouds(clouds)
                with lock:
                    logits = model.predict(clouds)
                if logits.ndim == 1:
                    logits = logits[None]
                out = {"labels": np.argmax(logits, -1).tolist()}
                if parse_qs(url.query).get("logits", ["0"])[0] == "1":
                    out["logits"] = logits.tolist()
                self._reply(200, out)
            except Exception as e:  # surface the error to the client
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})

    return ThreadingHTTPServer((host, port), Handler)


def serve_forever(artifact_dir: str, host: str = "0.0.0.0", port: int = 8000,
                  device: Optional[str] = None) -> None:
    model = ServingModel(artifact_dir, device)
    model.warmup()  # build the kernels before the first request
    srv = make_server(model, host, port)
    print(f"serving {artifact_dir} on http://{host}:{srv.server_address[1]} "
          f"(buckets {model.batch_sizes}, {model.device}, fused_eval="
          f"{model.fused_eval})", flush=True)
    srv.serve_forever()
