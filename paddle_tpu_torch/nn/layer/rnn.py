"""``LSTM`` (``paddle_tpu.nn.layer.rnn.LSTM``): a ``torch.nn.LSTM`` under
paddle's constructor.

The JAX layer's parameters are torch's, by name, shape and gate order:
``weight_ih_l{k}`` ``[4 H, in]``, ``weight_hh_l{k}`` ``[4 H, H]``,
``bias_ih_l{k}`` and ``bias_hh_l{k}`` ``[4 H]`` (``_reverse`` for the
backward direction), gates ``i, f, g, o``, both biases added; drawn
uniform in ``+-1/sqrt(H)`` as both libraries draw them.  So a JAX state
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

from torch import nn

__all__ = ["LSTM"]


class LSTM(nn.LSTM):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        if direction not in ("forward", "bidirect", "bidirectional"):
            raise ValueError(f"direction must be 'forward' or 'bidirect', "
                             f"got {direction!r}")
        if any(a is not None for a in (weight_ih_attr, weight_hh_attr,
                                       bias_ih_attr, bias_hh_attr)):
            raise NotImplementedError(
                "LSTM weight / bias attrs are not ported yet "
                "(nn/initializer.py, ROADMAP module item 3)")
        super().__init__(input_size, hidden_size, num_layers, bias=True,
                         batch_first=not time_major, dropout=dropout,
                         bidirectional=direction != "forward")

    def forward(self, inputs, initial_states=None, sequence_length=None):
        return super().forward(inputs, initial_states)
