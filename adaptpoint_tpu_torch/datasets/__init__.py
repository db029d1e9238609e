"""Datasets and the numpy batch loader of the port: ScanObjectNN (with
ScanObjectNN-C), ModelNet40 (with ModelNet-C), ShapeNetPart (with
ShapeNet-C), S3DIS and the synthetic sets.
Counterpart of ``adaptpoint_tpu/datasets``: the same registry names, the
same per-sample randomness, so the two packages' loaders give the same
batches bit for bit."""
from . import (modelnet, s3dis, scanobjectnn, shapenetpart,  # noqa: F401
               synthetic)
from .build import DATASETS, build_dataloader_from_cfg, build_dataset_from_cfg
from .loader import NumpyLoader
from .modelnet import (DGCNN_OA_MODELNET_C, ModelNetC, calculate_ce,
                       eval_corrupt_wrapper_modelnetc)
from .s3dis import S3DIS, SyntheticScene
from .scanobjectnn import (CORRUPTIONS, DGCNN_OA_SCANOBJECTNN_C,
                           ScanObjectNNC, eval_corrupt_wrapper)
from .shapenetpart import (CLS2PARTS, ShapeNetPart, ShapeNetPartC,
                           eval_corrupt_wrapper_shapenetc)

__all__ = ["DATASETS", "build_dataset_from_cfg", "build_dataloader_from_cfg",
           "NumpyLoader", "ScanObjectNNC", "CORRUPTIONS",
           "DGCNN_OA_SCANOBJECTNN_C", "eval_corrupt_wrapper", "ModelNetC",
           "DGCNN_OA_MODELNET_C", "calculate_ce",
           "eval_corrupt_wrapper_modelnetc", "CLS2PARTS", "ShapeNetPart",
           "ShapeNetPartC", "eval_corrupt_wrapper_shapenetc", "S3DIS",
           "SyntheticScene"]
