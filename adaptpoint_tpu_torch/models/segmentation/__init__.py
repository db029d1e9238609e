from .base_seg import BasePartSeg, BaseSeg, SegHead

__all__ = ["BaseSeg", "BasePartSeg", "SegHead"]
