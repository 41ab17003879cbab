"""Recurrent layers (``paddle_tpu.nn.layer.rnn`` counterparts).

The cells ``SimpleRNNCell``, ``LSTMCell`` and ``GRUCell`` (one step, as
the ``apply_op`` ops ``simple_rnn_cell``, ``lstm_cell``, ``gru_cell``),
``RNNCellBase.get_initial_states``, the multi-layer ``SimpleRNN``,
``LSTM`` and ``GRU`` (``_RNNBase``), ``RNN`` (a cell over time) and
``BiRNN``.  All are ``Layer``s.

Parameters and gates are the JAX layers', which are torch's: a cell owns
``weight_ih`` ``[G H, in]``, ``weight_hh`` ``[G H, H]``, ``bias_ih`` and
``bias_hh`` ``[G H]`` (G = 1, 4, 3); a multi-layer class owns
``weight_ih_l{k}``, ``weight_hh_l{k}``, ``bias_ih_l{k}``, ``bias_hh_l{k}``
per layer k (``_reverse`` for the backward direction).  The LSTM's gates
are i, f, g, o; the GRU's r, z, n with ``n = tanh(W_in x + b_in + r *
(W_hn h + b_hn))``.  So a JAX state dict loads by name with nothing
transposed.  Every parameter starts uniform in ``+-1/sqrt(H)`` (the
port's generator), or from its ``*_attr`` initializer; a weight attr
``False`` raises, and the two biases are dropped together or not at all.

The JAX package runs each layer and direction as a ``lax.scan`` (no
Pallas kernel).  The port runs the whole stack as one call of torch's
fused recurrent op (cuDNN on the card), as the op ``<mode>_layer``, so
``amp.auto_cast`` decides its dtype by that name as the JAX package does
for each of its scans.  The torch op copies the weights into one buffer
on the card every call (torch warns once).  ``dropout`` applies between
layers in training.  As in the JAX package, ``sequence_length`` is
accepted and not read.
"""
from __future__ import annotations

import torch

from ...core.dtype import convert_dtype, get_default_dtype
from ...core.op import apply_op
from ...core.tensor import Tensor
from .. import initializer as I
from ..layer_base import Layer

__all__ = ["RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell", "RNN",
           "BiRNN", "SimpleRNN", "LSTM", "GRU"]

_DIRECTIONS = ("forward", "bidirect", "bidirectional")
_KINDS = ("weight_ih", "weight_hh", "bias_ih", "bias_hh")


class RNNCellBase(Layer):
    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        """States filled with ``init_value`` for ``batch_ref``'s batch:
        ``[batch, *state_shape]`` (a tuple of them for the LSTM), of
        ``dtype`` (the default dtype when None), on ``batch_ref``'s device;
        surface Tensors for a surface ``batch_ref``, else torch tensors."""
        ref = batch_ref._value if isinstance(batch_ref, Tensor) else batch_ref
        batch = ref.shape[batch_dim_idx]
        dt = get_default_dtype() if dtype is None else convert_dtype(dtype)
        state_shape = self.state_shape if shape is None else shape

        def full(s):
            t = torch.full((batch,) + tuple(s), init_value, dtype=dt,
                           device=ref.device)
            return Tensor._wrap(t) if isinstance(batch_ref, Tensor) else t

        if isinstance(state_shape[0], (list, tuple)):
            return tuple(full(s) for s in state_shape)
        return full(state_shape)


def _attrs(weight_ih_attr, weight_hh_attr, bias_ih_attr, bias_hh_attr):
    if weight_ih_attr is False or weight_hh_attr is False:
        raise ValueError("recurrent weights cannot be dropped (attr False)")
    if (bias_ih_attr is False) != (bias_hh_attr is False):
        raise ValueError("a recurrent layer drops both biases or neither")
    return weight_ih_attr, weight_hh_attr, bias_ih_attr, bias_hh_attr


def _make_params(layer, in_size, hidden_size, gates, attrs):
    """``(weight_ih, weight_hh, bias_ih, bias_hh)`` Parameters (biases
    None when dropped), drawn uniform in +-1/sqrt(H) by default."""
    std = 1.0 / hidden_size ** 0.5
    u = I.Uniform(-std, std)
    wi_attr, wh_attr, bi_attr, bh_attr = attrs
    g = gates * hidden_size
    return (layer.create_parameter((g, in_size), attr=wi_attr,
                                   default_initializer=u),
            layer.create_parameter((g, hidden_size), attr=wh_attr,
                                   default_initializer=u),
            layer.create_parameter((g,), attr=bi_attr, is_bias=True,
                                   default_initializer=u),
            layer.create_parameter((g,), attr=bh_attr, is_bias=True,
                                   default_initializer=u))


def _project(x, h, w_ih, w_hh, b_ih, b_hh):
    z = x @ w_ih.T + h @ w_hh.T
    if b_ih is not None:
        z = z + b_ih + b_hh
    return z


def _simple_rnn_step(x, h, w_ih, w_hh, b_ih, b_hh, activation):
    z = _project(x, h, w_ih, w_hh, b_ih, b_hh)
    return torch.tanh(z) if activation == "tanh" else torch.relu(z)


def _lstm_step(x, h, c, w_ih, w_hh, b_ih, b_hh):
    i, f, g, o = _project(x, h, w_ih, w_hh, b_ih, b_hh).chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def _gru_step(x, h, w_ih, w_hh, b_ih, b_hh):
    xz = x @ w_ih.T
    hz = h @ w_hh.T
    if b_ih is not None:
        xz, hz = xz + b_ih, hz + b_hh
    xr, xu, xn = xz.chunk(3, dim=-1)
    hr, hu, hn = hz.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    u = torch.sigmoid(xu + hu)
    n = torch.tanh(xn + r * hn)
    return (1 - u) * n + u * h


class _Cell(RNNCellBase):
    _gates = 1

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        for kind, p in zip(_KINDS, _make_params(
                self, input_size, hidden_size, self._gates,
                _attrs(weight_ih_attr, weight_hh_attr, bias_ih_attr,
                       bias_hh_attr))):
            self.add_parameter(kind, p)

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def _weights(self):
        p = self._parameters
        return tuple(p[k] for k in _KINDS)

    def extra_repr(self):
        return f"{self.input_size}, {self.hidden_size}"


class SimpleRNNCell(_Cell):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__(input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr)
        self.activation = activation

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        act = self.activation
        out = apply_op(
            lambda x, h, wi, wh, bi, bh: _simple_rnn_step(
                x, h, wi, wh, bi, bh, act),
            "simple_rnn_cell", (inputs, states, *self._weights()), {})
        return out, out


class LSTMCell(_Cell):
    _gates = 4

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h, c = states
        h_new, c_new = apply_op(_lstm_step, "lstm_cell",
                                (inputs, h, c, *self._weights()), {})
        return h_new, (h_new, c_new)


class GRUCell(_Cell):
    _gates = 3

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        out = apply_op(_gru_step, "gru_cell",
                       (inputs, states, *self._weights()), {})
        return out, out


_FUSED = {"LSTM": torch._VF.lstm, "GRU": torch._VF.gru,
          "RNN_TANH": torch._VF.rnn_tanh, "RNN_RELU": torch._VF.rnn_relu}


class _RNNBase(Layer):
    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__()
        if direction not in _DIRECTIONS:
            raise ValueError(f"direction must be 'forward' or 'bidirect', "
                             f"got {direction!r}")
        attrs = _attrs(weight_ih_attr, weight_hh_attr, bias_ih_attr,
                       bias_hh_attr)
        self.mode = mode
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        self.bidirect = direction != "forward"
        self.num_directions = 2 if self.bidirect else 1
        self._has_bias = attrs[2] is not False
        gates = {"LSTM": 4, "GRU": 3}.get(mode, 1)
        self._flat_names = []
        for k in range(num_layers):
            for d in range(self.num_directions):
                in_size = input_size if k == 0 else \
                    hidden_size * self.num_directions
                sfx = "_reverse" if d else ""
                for kind, p in zip(_KINDS, _make_params(
                        self, in_size, hidden_size, gates, attrs)):
                    self.add_parameter(f"{kind}_l{k}{sfx}", p)
                    if p is not None:
                        self._flat_names.append(f"{kind}_l{k}{sfx}")

    def forward(self, inputs, initial_states=None, sequence_length=None):
        n_state = self.num_layers * self.num_directions
        batch = inputs.shape[1 if self.time_major else 0]
        lstm = self.mode == "LSTM"
        if initial_states is None:
            h0 = torch.zeros((n_state, batch, self.hidden_size),
                             dtype=inputs.dtype, device=inputs.device)
            c0 = h0
        elif lstm:
            h0, c0 = initial_states
        else:
            h0 = c0 = initial_states
        p = self._parameters
        weights = tuple(p[n] for n in self._flat_names)
        fused = _FUSED[self.mode]
        cfg = (self._has_bias, self.num_layers,
               float(self.dropout) if self.training else 0.0, self.training,
               self.bidirect, not self.time_major)

        def run(x, h, c, ws):
            if lstm:
                return tuple(fused(x, (h, c), list(ws), *cfg))
            return tuple(fused(x, h, list(ws), *cfg))

        out = apply_op(run, f"{self.mode.lower()}_layer",
                       (inputs, h0, c0, weights), {})
        if lstm:
            return out[0], (out[1], out[2])
        return out[0], out[1]

    def extra_repr(self):
        return (f"{self.input_size}, {self.hidden_size}, num_layers="
                f"{self.num_layers}, bidirect={self.bidirect}")


class SimpleRNN(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kwargs):
        mode = "RNN_TANH" if activation == "tanh" else "RNN_RELU"
        super().__init__(mode, input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kwargs)


class LSTM(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 **kwargs):
        super().__init__("LSTM", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kwargs)


class GRU(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 **kwargs):
        super().__init__("GRU", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kwargs)


class RNN(Layer):
    """A cell run over the time axis, one step a call (reverse order when
    ``is_reverse``); returns ``(outputs, final states)``."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None,
                **kwargs):
        time_axis = 0 if self.time_major else 1
        T = inputs.shape[time_axis]
        steps = range(T - 1, -1, -1) if self.is_reverse else range(T)
        states = initial_states
        outs = [None] * T
        for t in steps:
            xt = inputs[t] if self.time_major else inputs[:, t]
            outs[t], states = self.cell(xt, states)
        return torch.stack(outs, dim=time_axis), states


class BiRNN(Layer):
    """A forward and a reverse ``RNN``; outputs concatenated on the last
    axis, states ``(forward, backward)``."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, False, time_major)
        self.rnn_bw = RNN(cell_bw, True, time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None,
                **kwargs):
        states_fw, states_bw = (initial_states if initial_states is not None
                                else (None, None))
        out_fw, st_fw = self.rnn_fw(inputs, states_fw)
        out_bw, st_bw = self.rnn_bw(inputs, states_bw)
        return torch.cat([out_fw, out_bw], dim=-1), (st_fw, st_bw)
