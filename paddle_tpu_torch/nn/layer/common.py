"""Common layers (``paddle_tpu.nn.layer.common`` counterparts): ``Linear``,
``Flatten``, ``Upsample`` and ``UpsamplingNearest2D``.

``Linear`` is a ``torch.nn.Linear``: its weight is ``[out, in]`` where
paddle's is ``[in, out]``, and ``models.convert`` transposes it on the way
in and out, as for GPT's projections.  Initialised as paddle does: a
Xavier-uniform weight and a zero bias; ``bias_attr=False`` drops the
bias.

``Upsample`` calls ``F.interpolate`` with its settings (see there for
what each mode computes); ``UpsamplingNearest2D`` is its nearest mode."""
from __future__ import annotations

from torch import nn

from .. import functional as F

__all__ = ["Linear", "Flatten", "Upsample", "UpsamplingNearest2D"]


def _check_attrs(weight_attr, bias_attr):
    if weight_attr is not None or bias_attr not in (None, False):
        raise NotImplementedError(
            "weight_attr / bias_attr other than None (and bias_attr=False) "
            "are not ported yet (nn/initializer.py, ROADMAP module item 3)")


class Linear(nn.Linear):
    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None):
        _check_attrs(weight_attr, bias_attr)
        super().__init__(in_features, out_features,
                         bias=bias_attr is not False)
        nn.init.xavier_uniform_(self.weight)
        if self.bias is not None:
            nn.init.zeros_(self.bias)


class Flatten(nn.Flatten):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__(start_axis, stop_axis)


class Upsample(nn.Module):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners
        self.align_mode = align_mode
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest", False, 0,
                         data_format)
