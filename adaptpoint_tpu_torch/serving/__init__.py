"""Serving: artifacts (cfg + weights) and a batching HTTP server.

Counterpart of ``adaptpoint_tpu/serving``. ``python -m
adaptpoint_tpu_torch.serving export|run`` is the command line.
"""
from .artifact import (FORMAT, ServingModel, export_serving_artifact,
                       load_serving_artifact, preprocess_clouds)

__all__ = ["export_serving_artifact", "load_serving_artifact",
           "ServingModel", "preprocess_clouds", "FORMAT"]
