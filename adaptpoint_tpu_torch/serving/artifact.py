"""Serving artifacts: the model's cfg and weights, served in batch buckets.

Counterpart of ``adaptpoint_tpu/serving/artifact.py``. The JAX package bakes
its weights into StableHLO; a PyTorch port has no such export of the
hand-written kernels, so an artifact directory holds::

    manifest.json   format, model name, cfg (inlined), shapes, buckets,
                    fused_eval
    weights.pt      the model's state_dict (reference openpoints names)

and the serving process builds the model from the manifest's cfg.
:class:`ServingModel` keeps the JAX class's behaviour: a request routes to
the smallest bucket that fits, short batches are padded by repeating the
first cloud (eval forwards are per-sample independent), requests larger
than the largest bucket are chunked, and one ``(N, C)`` cloud is accepted.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..models import MODELS

__all__ = ["export_serving_artifact", "load_serving_artifact",
           "ServingModel", "preprocess_clouds", "FORMAT"]

FORMAT = "adaptpoint-tpu-torch-serving-v1"
_MANIFEST = "manifest.json"
_WEIGHTS = "weights.pt"


def export_serving_artifact(model, out_dir: str, *, num_points: int,
                            in_channels: int,
                            batch_sizes: Sequence[int] = (1, 8, 32),
                            fused_eval: bool = False,
                            cfg: Optional[Dict[str, Any]] = None,
                            model_name: str = "",
                            extra_manifest: Optional[Dict[str, Any]] = None
                            ) -> Dict[str, Any]:
    """Write ``manifest.json`` and ``weights.pt``; returns the manifest.

    ``cfg`` is the model cfg (default: ``model.model_cfg``, which
    ``build_model_from_cfg`` records)."""
    cfg = cfg if cfg is not None else getattr(model, "model_cfg", None)
    if cfg is None:
        raise ValueError("need the model cfg to export an artifact")
    batch_sizes = sorted(set(int(b) for b in batch_sizes))
    if not batch_sizes or batch_sizes[0] < 1:
        raise ValueError(f"batch_sizes must be positive: {batch_sizes}")
    os.makedirs(out_dir, exist_ok=True)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save(state, os.path.join(out_dir, _WEIGHTS))
    manifest = {
        "format": FORMAT,
        "model_name": model_name or str(cfg.get("NAME", "")),
        "cfg": json.loads(json.dumps(cfg)),
        "num_points": int(num_points),
        "in_channels": int(in_channels),
        "num_classes": int(model.num_classes),
        "batch_sizes": batch_sizes,
        "fused_eval": bool(fused_eval),
        "torch_version": torch.__version__,
    }
    if extra_manifest:
        manifest.update(extra_manifest)
    with open(os.path.join(out_dir, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


class ServingModel:
    """Batching front-end over an artifact directory.

    ``predict(x)`` takes ``(n, N, C)`` float32 clouds (or one ``(N, C)``
    cloud) and returns ``(n, num_classes)`` logits as numpy. ``device``
    ``None`` means the card and raises without one.
    """

    def __init__(self, path: str, device: Optional[str] = None):
        self.path = path
        with open(os.path.join(path, _MANIFEST)) as f:
            self.manifest = json.load(f)
        if self.manifest.get("format") != FORMAT:
            raise ValueError(f"not a serving artifact: {path}")
        self.device = resolve_device(device)
        self.batch_sizes = list(self.manifest["batch_sizes"])
        self.num_points = int(self.manifest["num_points"])
        self.in_channels = int(self.manifest["in_channels"])
        self.num_classes = int(self.manifest["num_classes"])
        self.fused_eval = bool(self.manifest.get("fused_eval", False))
        model = MODELS.build(self.manifest["cfg"])
        state = torch.load(os.path.join(path, _WEIGHTS), map_location="cpu",
                           weights_only=True)
        model.load_state_dict(state)
        self.model = model.to(self.device).eval()

    @torch.inference_mode()
    def infer(self, x: torch.Tensor) -> torch.Tensor:
        """Eval forward of a ``(b, >=num_points, >=in_channels)`` batch on
        the model's device; returns logits on that device."""
        pts = x[:, :self.num_points]
        pos = pts[..., :3].contiguous()
        feat = pts[..., :self.in_channels].contiguous()
        return self.model(pos, feat, fused_eval=self.fused_eval)

    def warmup(self) -> None:
        """Run every bucket once (builds the kernels before requests)."""
        for b in self.batch_sizes:
            x = torch.zeros((b, self.num_points, self.in_channels),
                            device=self.device)
            self.infer(x)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run_bucket(self, x: np.ndarray) -> np.ndarray:
        n = x.shape[0]
        b = next((bs for bs in self.batch_sizes if bs >= n),
                 self.batch_sizes[-1])
        if n < b:  # pad by repeating the first cloud
            x = np.concatenate([x, np.repeat(x[:1], b - n, axis=0)], axis=0)
        xt = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        return self.infer(xt).cpu().numpy()[:n]

    def predict(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float32)
        single = x.ndim == 2
        if single:
            x = x[None]
        if x.ndim != 3 or x.shape[1] < self.num_points \
                or x.shape[2] < self.in_channels:
            raise ValueError(
                f"expected (n, >={self.num_points}, >={self.in_channels}) "
                f"clouds, got {x.shape}")
        x = x[:, :self.num_points, :self.in_channels]
        bmax = self.batch_sizes[-1]
        outs = [self._run_bucket(x[i:i + bmax])
                for i in range(0, x.shape[0], bmax)]
        logits = np.concatenate(outs, axis=0)
        return logits[0] if single else logits

    def predict_labels(self, x: np.ndarray) -> np.ndarray:
        return np.argmax(self.predict(x), axis=-1)


def load_serving_artifact(path: str, device: Optional[str] = None
                          ) -> ServingModel:
    return ServingModel(path, device)


def preprocess_clouds(xyz: np.ndarray, *, gravity_dim: int = 1,
                      append_height: bool = True) -> np.ndarray:
    """Raw ``(n, N, 3)`` clouds -> model input ``(n, N, 3[+1])``.

    Mirrors the eval pipeline for the classification benchmarks:
    per-cloud height feature from the PRE-centering gravity axis
    (``h - h.min()``), then center + unit-sphere normalize (parity:
    transforms/point_transforms.py PointCloudCenterAndNormalize and the
    ScanObjectNN loader's height append, scanobjectnn.py:81-98).
    """
    xyz = np.asarray(xyz, np.float32)
    single = xyz.ndim == 2
    if single:
        xyz = xyz[None]
    h = xyz[:, :, gravity_dim:gravity_dim + 1]
    heights = h - h.min(axis=1, keepdims=True)
    pos = xyz - xyz.mean(axis=1, keepdims=True)
    scale = np.sqrt((pos ** 2).sum(-1, keepdims=True)).max(
        axis=1, keepdims=True)
    pos = pos / scale
    out = np.concatenate([pos, heights], -1) if append_height else pos
    return out[0] if single else out
