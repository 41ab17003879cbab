"""``LSTM`` (``paddle_tpu.nn.layer.rnn.LSTM``): a ``torch.nn.LSTM`` under
paddle's constructor.

The JAX layer's parameters are torch's, by name, shape and gate order:
``weight_ih_l{k}`` ``[4 H, in]``, ``weight_hh_l{k}`` ``[4 H, H]``,
``bias_ih_l{k}`` and ``bias_hh_l{k}`` ``[4 H]`` (``_reverse`` for the
backward direction), gates ``i, f, g, o``, both biases added; drawn
uniform in ``+-1/sqrt(H)`` as both libraries draw them (from the port's
generator), or by the ``initializer`` of ``weight_ih_attr`` /
``weight_hh_attr`` / ``bias_ih_attr`` / ``bias_hh_attr``, which also set
each parameter's paddle fields (``trainable``, ``learning_rate``,
``need_clip``, ...; read through ``nn.Parameter.of``).  Both bias attrs
``False`` drop the biases; a weight attr ``False`` raises.  So a JAX state
loads by name with nothing transposed.  The JAX layer runs each layer and
direction as a ``lax.scan`` (no Pallas kernel); the port runs torch's
LSTM (cuDNN on the card).

``direction`` is ``"forward"`` or ``"bidirect"`` (``"bidirectional"``);
``time_major`` picks ``[T, B, C]`` over ``[B, T, C]``; ``dropout``
applies between layers in training.  ``forward(inputs,
initial_states=None, sequence_length=None)`` returns ``(outputs, (h,
c))`` with ``h`` and ``c`` ``[layers * directions, B, H]``.
``sequence_length`` is accepted and not read, as in the JAX layer.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import initializer as I
from ..layer_base import ParamAttr, _default_attrs

__all__ = ["LSTM"]

_KINDS = ("weight_ih", "weight_hh", "bias_ih", "bias_hh")


class LSTM(nn.LSTM):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        if direction not in ("forward", "bidirect", "bidirectional"):
            raise ValueError(f"direction must be 'forward' or 'bidirect', "
                             f"got {direction!r}")
        attrs = dict(zip(_KINDS, map(ParamAttr._to_attr, (
            weight_ih_attr, weight_hh_attr, bias_ih_attr, bias_hh_attr))))
        if attrs["weight_ih"] is False or attrs["weight_hh"] is False:
            raise ValueError("LSTM weights cannot be dropped (attr False)")
        if (attrs["bias_ih"] is False) != (attrs["bias_hh"] is False):
            raise ValueError("LSTM drops both biases or neither")
        super().__init__(input_size, hidden_size, num_layers,
                         bias=attrs["bias_ih"] is not False,
                         batch_first=not time_major, dropout=dropout,
                         bidirectional=direction != "forward")
        std = 1.0 / hidden_size ** 0.5
        with torch.no_grad():
            for name, leaf in self.named_parameters():
                attr = attrs[name.split("_l")[0]]
                init = attr.initializer or I.Uniform(-std, std)
                leaf.copy_(init(tuple(leaf.shape), leaf.dtype, leaf.device))
                leaf.requires_grad_(bool(attr.trainable))
                leaf._paddle_attrs = _default_attrs(
                    attr.name, attr.learning_rate, attr.regularizer,
                    attr.need_clip)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        return super().forward(inputs, initial_states)
