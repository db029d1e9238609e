from .dgcnn import DGCNN, BallDGCNN, EdgeConv, graph_tape
from .pointmlp import LocalGrouper, PointMLP, PointMLPEncoder
from .pointnet import PointNetEncoder, TNet
from .pointnetv2 import PointNet2Encoder, PointNet2SA
from .pointnext import (FeaturePropagation, PointNextDecoder, PointNextEncoder,
                        PointNextPartDecoder, SetAbstraction)
from .pointvit import (Attention, KMeansEmbed, P3Embed, PointPatchEmbed,
                       PointViT, PointViTDecoder, PointViTPartDecoder,
                       TransformerBlock, ViTGraph)

__all__ = ["PointNextEncoder", "SetAbstraction", "FeaturePropagation",
           "PointNextDecoder", "PointNextPartDecoder", "DGCNN", "BallDGCNN",
           "EdgeConv", "graph_tape", "PointNet2Encoder", "PointNet2SA",
           "PointNetEncoder", "TNet", "PointMLPEncoder", "PointMLP",
           "LocalGrouper", "Attention", "TransformerBlock",
           "PointPatchEmbed", "PointViT", "PointViTDecoder",
           "PointViTPartDecoder", "KMeansEmbed", "ViTGraph", "P3Embed"]
