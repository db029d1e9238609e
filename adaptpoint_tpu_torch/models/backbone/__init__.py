from .pointnext import PointNextEncoder, SetAbstraction

__all__ = ["PointNextEncoder", "SetAbstraction"]
