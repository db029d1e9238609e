from .cls_base import BaseCls, ClsHead

__all__ = ["BaseCls", "ClsHead"]
