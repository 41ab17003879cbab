"""Conv layers (``paddle_tpu.nn.layer.conv`` counterparts): ``Conv1D``,
``Conv2D``, ``Conv3D`` and the three transposed convs.

Weights are ``[out_c, in_c / groups, *k]`` (transposed: ``[in_c, out_c /
groups, *k]``) and a bias ``[out_c]`` unless ``bias_attr=False`` (then
``bias`` is None and not in the state dict), initialised as paddle and
torch do: Kaiming-uniform with a = sqrt(5) over fan-in ``in_c / groups *
prod(k)`` and a bias uniform in +-1/sqrt(fan_in), drawn from the port's
generator.  The forwards are the ``F`` convolutions (torch's, cuDNN on the
card; the JAX package's run in XLA, outside any Pallas kernel).
``padding_mode`` other than ``"zeros"`` raises, as the JAX layers read
only zeros.
"""
from __future__ import annotations

import math

from .. import functional as F
from .. import initializer as I
from ..layer_base import Layer

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose"]


def _tuplize(v, n):
    if isinstance(v, int):
        return (v,) * n
    v = tuple(int(x) for x in v)
    return v * n if len(v) == 1 else v


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, n, transpose,
                 stride=1, padding=0, output_padding=0, dilation=1, groups=1,
                 padding_mode="zeros", weight_attr=None, bias_attr=None,
                 data_format="NCHW"):
        super().__init__()
        if padding_mode != "zeros":
            raise NotImplementedError(f"padding_mode={padding_mode!r} is "
                                      f"not ported (zeros only)")
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _tuplize(kernel_size, n)
        self._stride = stride
        self._padding = padding
        self._output_padding = output_padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        if transpose:
            w_shape = (in_channels, out_channels // groups) + \
                self._kernel_size
        else:
            w_shape = (out_channels, in_channels // groups) + \
                self._kernel_size
        fan_in = in_channels // groups * math.prod(self._kernel_size)
        bound = 1.0 / math.sqrt(fan_in)
        self.weight = self.create_parameter(
            w_shape, attr=weight_attr,
            default_initializer=I.KaimingUniform(
                fan_in=fan_in, negative_slope=math.sqrt(5.0),
                nonlinearity="leaky_relu"))
        self.bias = self.create_parameter(
            (out_channels,), attr=bias_attr, is_bias=True,
            default_initializer=I.Uniform(-bound, bound))

    def _wb(self):
        p = self._parameters
        return p["weight"], p.get("bias")

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={list(self._kernel_size)}, "
                f"stride={self._stride}")


class _Conv(_ConvNd):
    _n, _fn, _format = 2, "conv2d", "NCHW"

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format=None):
        super().__init__(in_channels, out_channels, kernel_size, self._n,
                         False, stride, padding, 0, dilation, groups,
                         padding_mode, weight_attr, bias_attr,
                         data_format or self._format)

    def forward(self, x):
        w, b = self._wb()
        return getattr(F, self._fn)(x, w, b, self._stride, self._padding,
                                    self._dilation, self._groups,
                                    self._data_format)


class _ConvTranspose(_ConvNd):
    _n, _fn, _format = 2, "conv2d_transpose", "NCHW"

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format=None):
        super().__init__(in_channels, out_channels, kernel_size, self._n,
                         True, stride, padding, output_padding, dilation,
                         groups, "zeros", weight_attr, bias_attr,
                         data_format or self._format)

    def forward(self, x, output_size=None):
        w, b = self._wb()
        return getattr(F, self._fn)(x, w, b, self._stride, self._padding,
                                    self._output_padding, self._groups,
                                    self._dilation, output_size,
                                    self._data_format)


class Conv1D(_Conv):
    _n, _fn, _format = 1, "conv1d", "NCL"


class Conv2D(_Conv):
    _n, _fn, _format = 2, "conv2d", "NCHW"


class Conv3D(_Conv):
    _n, _fn, _format = 3, "conv3d", "NCDHW"


class Conv1DTranspose(_ConvTranspose):
    _n, _fn, _format = 1, "conv1d_transpose", "NCL"


class Conv2DTranspose(_ConvTranspose):
    _n, _fn, _format = 2, "conv2d_transpose", "NCHW"


class Conv3DTranspose(_ConvTranspose):
    _n, _fn, _format = 3, "conv3d_transpose", "NCDHW"
