"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

The JAX package (``paddle_tpu``) stays the reference; this package serves
and trains the same models on an NVIDIA H100: GPT (``models``) and the
ResNet family (``vision.models``).  Plain tensor code is
PyTorch, and every Pallas kernel on a ported path is a CUDA C++ kernel
written for Hopper (``kernels/csrc``), built with ``nvcc`` at first use.

Module names and the ``[B, T, H, D]`` attention layout follow the JAX
package, so each function has an obvious counterpart there.  Entry points
take ``device=`` and default to ``"cuda"``; without a card they raise
rather than fall back to the CPU (``device.resolve_device``).

This package never imports ``jax`` or ``paddle_tpu``; only the tests
import both, to hold the port against the reference.
"""
from . import distributed, models, nn, optimizer, vision
from .device import resolve_device

__all__ = ["resolve_device", "distributed", "models", "nn", "optimizer",
           "vision"]
