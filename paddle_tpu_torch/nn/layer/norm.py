"""``LayerNorm`` (``paddle_tpu.nn.layer.norm.LayerNorm``): parameters
``weight`` (ones) and ``bias`` (zeros) of ``normalized_shape``, the
epsilon kept as ``_epsilon``, the forward through ``F.layer_norm`` (so
the opt-in fused kernels apply).  The state-dict names are those of
``torch.nn.LayerNorm`` and of the JAX layer: ``weight`` and ``bias``."""
from __future__ import annotations

import torch
from torch import nn

from .. import functional as F

__all__ = ["LayerNorm"]


class LayerNorm(nn.Module):
    def __init__(self, normalized_shape, epsilon=1e-5):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self._normalized_shape = tuple(normalized_shape)
        self._epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(self._normalized_shape))
        self.bias = nn.Parameter(torch.zeros(self._normalized_shape))

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight, self.bias,
                            self._epsilon)

    def extra_repr(self):
        return (f"normalized_shape={list(self._normalized_shape)}, "
                f"epsilon={self._epsilon}")
