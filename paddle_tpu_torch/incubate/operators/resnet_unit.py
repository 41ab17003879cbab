"""``ResNetUnit`` and ``resnet_unit`` (``paddle_tpu.incubate.operators.
resnet_unit`` counterparts): the fused conv + batch norm (+ add) + relu
block of performance ResNets, composed from the port's ``F.conv2d``,
``F.batch_norm`` and ``F.relu``, NHWC by default as in the JAX package.
In training the batch statistics normalise and the running statistics
update in place."""
from __future__ import annotations

import torch

from ... import nn
from ...nn import functional as F
from ...nn.layer_base import creation_device

__all__ = ["ResNetUnit", "resnet_unit"]


def resnet_unit(x, filter_x, scale_x, bias_x, mean_x, var_x, z=None,
                filter_z=None, scale_z=None, bias_z=None, mean_z=None,
                var_z=None, stride=1, stride_z=1, padding=0, dilation=1,
                groups=1, momentum=0.9, eps=1e-5, data_format="NHWC",
                fuse_add=False, has_shortcut=False, use_global_stats=False,
                is_test=False, act="relu"):
    """``act(BN(conv(x)) [+ BN(conv(z)) | + z])``."""
    def branch(inp, w, scale, bias, mean, var, s, pad):
        out = F.conv2d(inp, w, stride=s, padding=pad, dilation=dilation,
                       groups=groups, data_format=data_format)
        return F.batch_norm(out, mean, var, scale, bias,
                            training=not is_test, momentum=momentum,
                            epsilon=eps, data_format=data_format,
                            use_global_stats=use_global_stats)

    out = branch(x, filter_x, scale_x, bias_x, mean_x, var_x, stride,
                 padding)
    if has_shortcut:
        # the shortcut conv is 1 x 1: no spatial padding
        out = out + branch(z, filter_z, scale_z, bias_z, mean_z, var_z,
                           stride_z, 0)
    elif fuse_add:
        out = out + z
    if act == "relu":
        out = F.relu(out)
    return out


class ResNetUnit(nn.Layer):
    """The layer form: owns the main branch's filter and BN parameters and
    running statistics, and with ``has_shortcut`` the shortcut's."""

    def __init__(self, num_channels_x, num_filters, filter_size, stride=1,
                 momentum=0.9, eps=1e-5, data_format="NHWC", act="relu",
                 fuse_add=False, has_shortcut=False, use_global_stats=False,
                 is_test=False, filter_x_attr=None, scale_x_attr=None,
                 bias_x_attr=None, moving_mean_x_name=None,
                 moving_var_x_name=None, num_channels_z=1, stride_z=1,
                 filter_z_attr=None, scale_z_attr=None, bias_z_attr=None,
                 moving_mean_z_name=None, moving_var_z_name=None):
        super().__init__()
        self._stride = stride
        self._stride_z = stride_z
        self._padding = (filter_size - 1) // 2
        self._momentum = momentum
        self._eps = eps
        self._data_format = data_format
        self._act = act
        self._fuse_add = fuse_add
        self._has_shortcut = has_shortcut
        self._use_global_stats = use_global_stats
        self._is_test = is_test
        dev = creation_device()
        one = nn.initializer.Constant(1.0)

        def stats(tag):
            self.register_buffer(f"mean_{tag}", torch.zeros(
                num_filters, dtype=torch.float32, device=dev))
            self.register_buffer(f"var_{tag}", torch.ones(
                num_filters, dtype=torch.float32, device=dev))

        k = (filter_size, filter_size)
        self.filter_x = self.create_parameter(
            (num_filters, num_channels_x) + k, attr=filter_x_attr)
        self.scale_x = self.create_parameter(
            (num_filters,), attr=scale_x_attr, default_initializer=one)
        self.bias_x = self.create_parameter(
            (num_filters,), attr=bias_x_attr, is_bias=True)
        stats("x")
        if has_shortcut:
            self.filter_z = self.create_parameter(
                (num_filters, num_channels_z, 1, 1), attr=filter_z_attr)
            self.scale_z = self.create_parameter(
                (num_filters,), attr=scale_z_attr, default_initializer=one)
            self.bias_z = self.create_parameter(
                (num_filters,), attr=bias_z_attr, is_bias=True)
            stats("z")

    def forward(self, x, z=None):
        own = {**self._parameters, **self._buffers}
        parts = ("filter", "scale", "bias", "mean", "var")
        return resnet_unit(
            x, *(own[f"{n}_x"] for n in parts), z,
            *(own.get(f"{n}_z") for n in parts), self._stride,
            self._stride_z, self._padding, 1, 1, self._momentum, self._eps,
            self._data_format, self._fuse_add, self._has_shortcut,
            self._use_global_stats, self._is_test, self._act)
