"""Common layers (``paddle_tpu.nn.layer.common`` counterparts): ``Linear``
and ``Flatten``.

``Linear`` is a ``torch.nn.Linear``: its weight is ``[out, in]`` where
paddle's is ``[in, out]``, and ``models.convert`` transposes it on the way
in and out, as for GPT's projections.  Initialised as paddle does: a
Xavier-uniform weight and a zero bias; ``bias_attr=False`` drops the
bias."""
from __future__ import annotations

from torch import nn

__all__ = ["Linear", "Flatten"]


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
