from .config import EasyConfig
from .registry import Registry, build_from_cfg

__all__ = ["EasyConfig", "Registry", "build_from_cfg"]
