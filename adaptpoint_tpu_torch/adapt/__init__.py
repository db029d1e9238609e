"""AdaptPoint models: the learned augmentor, the discriminator, PointWOLF,
the feedback loss, the fake-cloud dataset and RSMix."""
from . import augmentor, discriminator  # noqa: F401  (register the models)
from .augmentor import gumbel_softmax
from .build import ADAPTMODELS, build_adaptpointmodels_from_cfg
from .common import (WolfDraws, draw_wolf, kernel_regression, normalize_cloud,
                     pointwolf_transform, random_axis)
from .feedback import feedback_loss, update_hardratio
from .form_dataset import (FormDatasetCls, FormDatasetShapeNet,
                           Form_dataset_cls, Form_dataset_shapenet)
from .pointwolf import PointWOLF, pointwolf
from .rsmix import rsmix

__all__ = ["ADAPTMODELS", "build_adaptpointmodels_from_cfg", "gumbel_softmax",
           "WolfDraws", "draw_wolf", "pointwolf_transform",
           "kernel_regression", "normalize_cloud", "random_axis",
           "feedback_loss", "update_hardratio", "FormDatasetCls",
           "Form_dataset_cls", "FormDatasetShapeNet", "Form_dataset_shapenet",
           "PointWOLF", "pointwolf", "rsmix"]
