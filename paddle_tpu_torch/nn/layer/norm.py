"""Normalisation layers (``paddle_tpu.nn.layer.norm`` counterparts).

``LayerNorm``: parameters ``weight`` (ones) and ``bias`` (zeros) of
``normalized_shape``, the epsilon kept as ``_epsilon``, the forward
through ``F.layer_norm`` (so the opt-in fused kernels apply).  The
state-dict names are those of ``torch.nn.LayerNorm`` and of the JAX layer:
``weight`` and ``bias``.

``BatchNorm2D`` (``_BatchNormBase``): parameters ``weight`` (ones) and
``bias`` (zeros), and the running statistics as f32 buffers named as the
JAX layer names them, ``_mean`` (zeros) and ``_variance`` (ones); there is
no ``num_batches_tracked``.  The forward is ``F.batch_norm`` with batch
statistics in training mode (paddle's momentum, 0.9 by default)."""
from __future__ import annotations

import torch
from torch import nn

from .. import functional as F
from .common import _check_attrs

__all__ = ["LayerNorm", "BatchNorm2D"]


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


class _BatchNormBase(nn.Module):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        _check_attrs(weight_attr, bias_attr)
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = nn.Parameter(torch.ones(num_features))
        if bias_attr is False:
            self.register_parameter("bias", None)
        else:
            self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("_mean", torch.zeros(num_features))
        self.register_buffer("_variance", torch.ones(num_features))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return (f"num_features={self._num_features}, "
                f"momentum={self._momentum}")


class BatchNorm2D(_BatchNormBase):
    pass
