"""Datasets and the numpy batch loader of the port (the classifier's
``mode: train`` path). Counterpart of ``adaptpoint_tpu/datasets``: the same
registry names, the same per-sample randomness, so the two packages' loaders
give the same batches bit for bit."""
from . import scanobjectnn, synthetic  # noqa: F401  (register datasets)
from .build import DATASETS, build_dataloader_from_cfg, build_dataset_from_cfg
from .loader import NumpyLoader
from .scanobjectnn import (CORRUPTIONS, DGCNN_OA_SCANOBJECTNN_C,
                           ScanObjectNNC, eval_corrupt_wrapper)

__all__ = ["DATASETS", "build_dataset_from_cfg", "build_dataloader_from_cfg",
           "NumpyLoader", "ScanObjectNNC", "CORRUPTIONS",
           "DGCNN_OA_SCANOBJECTNN_C", "eval_corrupt_wrapper"]
