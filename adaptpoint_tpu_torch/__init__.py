"""PyTorch / CUDA port of adaptpoint-tpu for NVIDIA Hopper (H100).

The package mirrors ``adaptpoint_tpu``'s module paths so each counterpart is
easy to find, but it imports only ``torch`` (plus numpy and yaml): the JAX
package is its reference and is never imported here.

This slice covers the serving path: PointNeXt-S eval forwards behind the
batching HTTP server, with hand-written CUDA kernels for furthest point
sampling, ball grouping and the fused eval SetAbstraction stage
(``ops/csrc``). Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"`` (see :mod:`adaptpoint_tpu_torch.device`).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
