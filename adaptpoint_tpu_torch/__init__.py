"""PyTorch / CUDA port of adaptpoint-tpu for NVIDIA Hopper (H100).

The package mirrors ``adaptpoint_tpu``'s module paths so each counterpart is
easy to find, but it imports only ``torch`` (plus numpy and yaml): the JAX
package is its reference and is never imported here.

Ported so far: the serving path (PointNeXt-S eval forwards behind the
batching HTTP server), classifier training (``engine.cls_trainer`` with
the loss, optimizer, scheduler and metrics modules) and phase A of the
AdaptPoint protocol, the adversarial step (``adapt`` and
``engine.adapt_trainer``) in f32. The hand-written CUDA kernels are in
``ops/csrc``: furthest point sampling, ball grouping forward and backward,
the fused eval SetAbstraction stage, the row gather with its scatter-add
backward, flash self-attention forward and backward, and exact kNN. Every entry point runs on ``cuda`` unless the
caller passes ``device="cpu"`` (see :mod:`adaptpoint_tpu_torch.device`).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
