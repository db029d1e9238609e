"""Training engines of the port (classifier training so far)."""
from .cls_trainer import (TrainState, build_train_tools, make_eval_step,
                          make_train_step, resample_points, set_lr,
                          train_one_epoch, validate)

__all__ = ["TrainState", "build_train_tools", "make_train_step",
           "make_eval_step", "train_one_epoch", "validate", "resample_points",
           "set_lr"]
