from .pointnext import (FeaturePropagation, PointNextDecoder, PointNextEncoder,
                        PointNextPartDecoder, SetAbstraction)

__all__ = ["PointNextEncoder", "SetAbstraction", "FeaturePropagation",
           "PointNextDecoder", "PointNextPartDecoder"]
