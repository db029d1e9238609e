from .build import MODELS, build_model_from_cfg
from . import backbone, classification  # noqa: F401  (registers the models)

__all__ = ["MODELS", "build_model_from_cfg"]
