from .build import MODELS, build_model_from_cfg
from . import backbone, classification, segmentation  # noqa: F401

__all__ = ["MODELS", "build_model_from_cfg"]
