"""Normalisation layers (``paddle_tpu.nn.layer.norm`` counterparts).

``LayerNorm``: parameters ``weight`` (ones) and ``bias`` (zeros) of
``normalized_shape`` (``weight_attr`` / ``bias_attr=False`` drops one),
the epsilon kept as ``_epsilon``, the forward through ``F.layer_norm`` (so
the opt-in fused kernels apply).  The state-dict names are those of
``torch.nn.LayerNorm`` and of the JAX layer: ``weight`` and ``bias``.

The batch norms (``_BatchNormBase``: ``BatchNorm``, ``BatchNorm1D``,
``BatchNorm2D``, ``BatchNorm3D`` and ``SyncBatchNorm``): parameters
``weight`` (ones) and ``bias`` (zeros), and the running statistics as f32
buffers named as the JAX layer names them, ``_mean`` (zeros) and
``_variance`` (ones); there is no ``num_batches_tracked``.  The forward is
``F.batch_norm`` with batch statistics in training mode (paddle's
momentum, 0.9 by default).  ``SyncBatchNorm`` is one device's batch norm
(the JAX package's is the same layer, its statistics global only under a
jitted mesh step).

``GroupNorm``, the instance norms (affine unless ``weight_attr`` or
``bias_attr`` is False; no running statistics), ``LocalResponseNorm``
and ``SpectralNorm`` (its ``weight_u`` / ``weight_v`` buffers drawn from
the port's generator) call their functionals.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import functional as F
from .. import initializer as I
from ..layer_base import Layer, creation_device, param
from ..layout import resolve_data_format

__all__ = ["LayerNorm", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "BatchNorm3D", "SyncBatchNorm", "GroupNorm", "InstanceNorm1D",
           "InstanceNorm2D", "InstanceNorm3D", "LocalResponseNorm",
           "SpectralNorm"]


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self._normalized_shape = tuple(normalized_shape)
        self._epsilon = epsilon
        self.weight = None if weight_attr is False else self.create_parameter(
            self._normalized_shape, attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            self._normalized_shape, attr=bias_attr, is_bias=True)

    def forward(self, x):
        p = self._parameters
        return F.layer_norm(x, self._normalized_shape, param(self, "weight"),
                            p.get("bias"), self._epsilon)

    def extra_repr(self):
        return (f"normalized_shape={list(self._normalized_shape)}, "
                f"epsilon={self._epsilon}")


def _stats(n, fill):
    return torch.full((n,), fill, dtype=torch.float32,
                      device=creation_device())


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = resolve_data_format(data_format)
        self._use_global_stats = use_global_stats
        self.weight = self.create_parameter(
            (num_features,), attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter((num_features,), attr=bias_attr,
                                          is_bias=True)
        self.register_buffer("_mean", _stats(num_features, 0.0))
        self.register_buffer("_variance", _stats(num_features, 1.0))

    def forward(self, x):
        p, b = self._parameters, self._buffers
        return F.batch_norm(x, b["_mean"], b["_variance"], param(self, "weight"),
                            p.get("bias"), training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return (f"num_features={self._num_features}, "
                f"momentum={self._momentum}")


class BatchNorm(_BatchNormBase):
    """Legacy fluid BatchNorm (acts like BatchNorm1D/2D/3D by input
    rank)."""


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


class SyncBatchNorm(_BatchNormBase):
    """One device's batch norm (see the module docstring)."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        for sub_layer in layer.sublayers(include_self=True):
            for name, sub in list(sub_layer._modules.items()):
                if isinstance(sub, _BatchNormBase) and \
                        not isinstance(sub, SyncBatchNorm):
                    new = SyncBatchNorm.__new__(SyncBatchNorm)
                    new.__dict__.update(sub.__dict__)
                    sub_layer._modules[name] = new
        return layer


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self._data_format = resolve_data_format(data_format)
        self.weight = None if weight_attr is False else self.create_parameter(
            (num_channels,), attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            (num_channels,), attr=bias_attr, is_bias=True)

    def forward(self, x):
        p = self._parameters
        return F.group_norm(x, self._num_groups, self._epsilon,
                            param(self, "weight"), p.get("bias"),
                            self._data_format)


class _InstanceNormBase(Layer):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._epsilon = epsilon
        if weight_attr is False or bias_attr is False:
            self.weight = None
            self.bias = None
        else:
            self.weight = self.create_parameter(
                (num_features,), attr=weight_attr,
                default_initializer=I.Constant(1.0))
            self.bias = self.create_parameter((num_features,),
                                              attr=bias_attr, is_bias=True)

    def forward(self, x):
        p = self._parameters
        return F.instance_norm(x, weight=param(self, "weight"), bias=p.get("bias"),
                               eps=self._epsilon)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self._args = (size, alpha, beta, k, data_format)

    def forward(self, x):
        return F.local_response_norm(x, *self._args)


class SpectralNorm(Layer):
    def __init__(self, weight_shape, dim=0, power_iters=1, epsilon=1e-12,
                 name=None):
        super().__init__()
        self._dim = dim
        self._power_iters = power_iters
        self._epsilon = epsilon
        h = weight_shape[dim]
        w = int(np.prod(weight_shape)) // h
        dev = creation_device()
        self.register_buffer("weight_u", I.Normal()((h,), device=dev))
        self.register_buffer("weight_v", I.Normal()((w,), device=dev))

    def forward(self, weight):
        b = self._buffers
        return F.spectral_norm(weight, b["weight_u"], b["weight_v"],
                               self._dim, self._power_iters, self._epsilon)
