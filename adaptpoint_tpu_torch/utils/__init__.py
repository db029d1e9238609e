from .config import EasyConfig
from .metrics import AverageMeter, ConfusionMatrix
from .registry import Registry, build_from_cfg

__all__ = ["EasyConfig", "Registry", "build_from_cfg", "AverageMeter",
           "ConfusionMatrix"]
