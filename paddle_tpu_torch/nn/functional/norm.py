"""Normalisation functionals (``paddle_tpu.nn.functional.norm``
counterparts).

``layer_norm`` routes as the JAX package does: when the opt-in fused path
applies (``kernels.layer_norm.layer_norm_fused_ok``: affine, last axis,
C a multiple of 128) it runs ``layer_norm_fused`` (the CUDA kernels for
CUDA tensors, their plain versions for CPU tensors); otherwise it is
``torch.nn.functional.layer_norm``, exactly what ``torch.nn.LayerNorm``
runs, so the default path's numbers do not move.
"""
from __future__ import annotations

import torch

from ...kernels.layer_norm import layer_norm_fused, layer_norm_fused_ok

__all__ = ["layer_norm"]


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    normalized_shape = tuple(normalized_shape)
    axes = tuple(range(x.dim() - len(normalized_shape), x.dim()))
    if layer_norm_fused_ok(x, axes, weight, bias):
        return layer_norm_fused(x, weight, bias, epsilon)
    return torch.nn.functional.layer_norm(x, normalized_shape, weight, bias,
                                          epsilon)
