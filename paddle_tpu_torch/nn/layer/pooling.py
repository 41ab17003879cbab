"""Pooling layers (``paddle_tpu.nn.layer.pooling`` counterparts): the max,
average, adaptive-average and adaptive-max pools in 1, 2 and 3 dims over
their ``F`` functionals.  The 1-D pools and the adaptive max pools take no
``data_format`` (channel-first), as the JAX layers; the adaptive max
pools raise on ``return_mask=True``, as there.  Every pool resolves its
layout when built (``nn.layout``): inside ``nn.channels_last()`` each
one, those without a ``data_format`` argument included, is channel-last."""
from __future__ import annotations

from .. import functional as F
from ..layer_base import Layer
from ..layout import resolve_data_format

__all__ = ["MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D", "AvgPool2D",
           "AvgPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
           "AdaptiveAvgPool3D", "AdaptiveMaxPool1D", "AdaptiveMaxPool2D",
           "AdaptiveMaxPool3D"]


class _Pool(Layer):
    _fn = None      # the functional's name in ``F``

    def __init__(self, **kw):
        super().__init__()
        self._kw = {k: v for k, v in kw.items() if k != "name"}
        if "data_format" in self._kw:
            self._kw["data_format"] = resolve_data_format(
                self._kw["data_format"])

    def forward(self, x):
        return getattr(F, self._fn)(x, **self._kw)

    def extra_repr(self):
        return ", ".join(f"{k}={v}" for k, v in self._kw.items())


class MaxPool1D(_Pool):
    _fn = "max_pool1d"

    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, name=None):
        super().__init__(kernel_size=kernel_size, stride=stride,
                         padding=padding, return_mask=return_mask,
                         ceil_mode=ceil_mode, data_format="NCL")


class MaxPool2D(_Pool):
    _fn = "max_pool2d"

    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format="NCHW", name=None):
        super().__init__(kernel_size=kernel_size, stride=stride,
                         padding=padding, return_mask=return_mask,
                         ceil_mode=ceil_mode, data_format=data_format)


class MaxPool3D(_Pool):
    _fn = "max_pool3d"

    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format="NCDHW", name=None):
        super().__init__(kernel_size=kernel_size, stride=stride,
                         padding=padding, return_mask=return_mask,
                         ceil_mode=ceil_mode, data_format=data_format)


class AvgPool1D(_Pool):
    _fn = "avg_pool1d"

    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None):
        super().__init__(kernel_size=kernel_size, stride=stride,
                         padding=padding, exclusive=exclusive,
                         ceil_mode=ceil_mode, data_format="NCL")


class AvgPool2D(_Pool):
    _fn = "avg_pool2d"

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__(kernel_size=kernel_size, stride=stride,
                         padding=padding, ceil_mode=ceil_mode,
                         exclusive=exclusive,
                         divisor_override=divisor_override,
                         data_format=data_format)


class AvgPool3D(_Pool):
    _fn = "avg_pool3d"

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCDHW",
                 name=None):
        super().__init__(kernel_size=kernel_size, stride=stride,
                         padding=padding, ceil_mode=ceil_mode,
                         exclusive=exclusive,
                         divisor_override=divisor_override,
                         data_format=data_format)


class AdaptiveAvgPool1D(_Pool):
    _fn = "adaptive_avg_pool1d"

    def __init__(self, output_size, name=None):
        super().__init__(output_size=output_size, data_format="NCL")


class AdaptiveAvgPool2D(_Pool):
    _fn = "adaptive_avg_pool2d"

    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__(output_size=output_size, data_format=data_format)


class AdaptiveAvgPool3D(_Pool):
    _fn = "adaptive_avg_pool3d"

    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__(output_size=output_size, data_format=data_format)


class _AdaptiveMax(_Pool):
    _format = "NCHW"

    def __init__(self, output_size, return_mask=False, name=None):
        if return_mask:
            raise NotImplementedError(
                f"{type(self).__name__}(return_mask=True) is not supported: "
                f"the adaptive bins carry no window-argmax path")
        super().__init__(output_size=output_size, data_format=self._format)


class AdaptiveMaxPool1D(_AdaptiveMax):
    _fn, _format = "adaptive_max_pool1d", "NCL"


class AdaptiveMaxPool2D(_AdaptiveMax):
    _fn, _format = "adaptive_max_pool2d", "NCHW"


class AdaptiveMaxPool3D(_AdaptiveMax):
    _fn, _format = "adaptive_max_pool3d", "NCDHW"
