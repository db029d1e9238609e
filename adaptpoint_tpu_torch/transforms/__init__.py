"""Per-sample point-cloud transforms of the port (host-side numpy)."""
from . import point_transforms  # noqa: F401  (register transforms)
from .transforms_factory import (Compose, DataTransforms,
                                 build_transforms_from_cfg)

__all__ = ["DataTransforms", "Compose", "build_transforms_from_cfg"]
