"""Dataset registry and dataloader factory.

Counterpart of ``adaptpoint_tpu/datasets/build.py`` (reference
openpoints/dataset/build.py:10-98): ``DATASETS``, ``build_dataset_from_cfg``
and ``build_dataloader_from_cfg``, which merges the split's cfg into
``common``, builds the split's transform and returns a :class:`NumpyLoader`.
"""
from __future__ import annotations

import copy

from ..transforms import build_transforms_from_cfg
from ..utils.registry import Registry, build_from_cfg
from .loader import NumpyLoader

__all__ = ["DATASETS", "build_dataset_from_cfg", "build_dataloader_from_cfg"]

DATASETS = Registry("datasets")


def build_dataset_from_cfg(common_cfg, split_cfg=None):
    cfg = copy.deepcopy(dict(common_cfg))
    if split_cfg:
        cfg.update(dict(split_cfg))
    return build_from_cfg(cfg, DATASETS)


def build_dataloader_from_cfg(batch_size: int, dataset_cfg=None,
                              dataloader_cfg=None, datatransforms_cfg=None,
                              split: str = "train", dataset=None,
                              seed: int = 0) -> NumpyLoader:
    """A loader over ``split`` (shuffled, last batch dropped for train; in
    order, last batch padded for the others). ``dataset`` overrides the
    one the cfg would build."""
    if dataset is None:
        transform = None
        if datatransforms_cfg is not None:
            # vote transforms apply only when asked for (build.py:60-66)
            transform = build_transforms_from_cfg(
                "train" if split == "train" else "val", datatransforms_cfg)
        split_cfg = dict(dataset_cfg.get(split, {}))
        if split_cfg.get("split") is None:
            split_cfg["split"] = split
        split_cfg["transform"] = transform
        dataset = build_dataset_from_cfg(dataset_cfg["common"], split_cfg)
    shuffle = split == "train"
    return NumpyLoader(dataset, batch_size, shuffle=shuffle,
                       drop_last=shuffle, seed=seed,
                       num_workers=(dataloader_cfg or {}).get("num_workers",
                                                              0))
