"""The port's recurrent layers against the JAX package's, on the CPU.

The same call builds each layer in both packages; the JAX layer's numpy
``state_dict()`` loads into the port's by name (nothing missing, nothing
unexpected, nothing transposed), and both run on the same seeded inputs
as surface Tensors (f32; the JAX side at ``jax_default_matmul_precision``
"highest").

* ``SimpleRNN`` (tanh, relu), ``LSTM`` and ``GRU``: forward and
  bidirectional, batch-first and time-major, one and two layers, with and
  without initial states;
* ``SimpleRNNCell``, ``LSTMCell`` and ``GRUCell``: one step, with and
  without states; ``get_initial_states``;
* ``RNN`` over each cell, forward and reversed, and ``BiRNN``.

Outputs and final states agree to 1e-5 relative (1e-6 absolute); the
gradients of a fixed random projection of them with respect to the input,
the initial states and every parameter to 1e-4 relative (1e-5 absolute).
"""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.nn as jnn
import paddle_tpu_torch
import paddle_tpu_torch.nn as pnn
from _torch_cpu_place import cpu_place  # noqa: F401

OUT_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
C, H, B, T = 6, 5, 3, 7


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    return [out]


def _run(pkg, layer, arrays, call):
    """Outputs (numpy) and the gradients of sum(out_i * proj_i) with
    respect to the float inputs and the parameters, by name."""
    ts = [pkg.to_tensor(a, stop_gradient=False) for a in arrays]
    outs = _flat(call(layer, ts))
    rs = np.random.RandomState(11)
    loss = None
    for o in outs:
        proj = pkg.to_tensor(rs.standard_normal(o.shape).astype(np.float32))
        s = (o * proj).sum()
        loss = s if loss is None else loss + s
    loss.backward()
    grads = {f"input {i}": t.grad.numpy() for i, t in enumerate(ts)}
    grads.update({n: p.grad.numpy() for n, p in layer.named_parameters()})
    return [o.numpy() for o in outs], grads


def _compare(jl, pl, arrays, call):
    jstate = {k: v.numpy() for k, v in jl.state_dict().items()}
    assert sorted(pl.state_dict()) == sorted(jstate)
    assert pl.set_state_dict(jstate) == ([], [])
    want = _run(paddle_tpu, jl, arrays, call)
    got = _run(paddle_tpu_torch, pl, arrays, call)
    assert len(got[0]) == len(want[0])
    for i, (g, w) in enumerate(zip(got[0], want[0])):
        assert g.shape == w.shape, i
        np.testing.assert_allclose(g, w, err_msg=f"output {i}", **OUT_TOL)
    assert sorted(got[1]) == sorted(want[1])
    for k, w in want[1].items():
        np.testing.assert_allclose(got[1][k], w, err_msg=k, **GRAD_TOL)


MODES = {"simple_tanh": ("SimpleRNN", {}),
         "simple_relu": ("SimpleRNN", {"activation": "relu"}),
         "lstm": ("LSTM", {}), "gru": ("GRU", {})}
SHAPES = [dict(layers=1, time_major=False, init=False),
          dict(layers=2, time_major=True, init=False),
          dict(layers=2, time_major=False, init=True)]


@pytest.mark.parametrize("shape", SHAPES,
                         ids=["1layer", "2layers-time_major", "2layers-init"])
@pytest.mark.parametrize("direction", ["forward", "bidirect"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_multilayer_matches_jax(mode, direction, shape):
    cls, kw = MODES[mode]
    kw = dict(kw, num_layers=shape["layers"], direction=direction,
              time_major=shape["time_major"])
    paddle_tpu.seed(1)
    jl = getattr(jnn, cls)(C, H, **kw)
    pl = getattr(pnn, cls)(C, H, **kw)
    rs = np.random.RandomState(len(mode) + shape["layers"])
    x = rs.standard_normal((T, B, C) if shape["time_major"] else (B, T, C))
    arrays = [x.astype(np.float32)]
    n = shape["layers"] * (2 if direction == "bidirect" else 1)
    if shape["init"]:
        arrays += [rs.standard_normal((n, B, H)).astype(np.float32)
                   for _ in range(2 if cls == "LSTM" else 1)]

    def call(layer, ts):
        if len(ts) == 1:
            return layer(ts[0])
        return layer(ts[0], tuple(ts[1:]) if cls == "LSTM" else ts[1])

    _compare(jl, pl, arrays, call)


CELLS = {"simple_tanh": ("SimpleRNNCell", {}, 1),
         "simple_relu": ("SimpleRNNCell", {"activation": "relu"}, 1),
         "lstm": ("LSTMCell", {}, 2), "gru": ("GRUCell", {}, 1)}


@pytest.mark.parametrize("with_states", [False, True])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_step_matches_jax(cell, with_states):
    cls, kw, n_states = CELLS[cell]
    paddle_tpu.seed(2)
    jl = getattr(jnn, cls)(C, H, **kw)
    pl = getattr(pnn, cls)(C, H, **kw)
    rs = np.random.RandomState(3 + n_states)
    arrays = [rs.standard_normal((B, C)).astype(np.float32)]
    if with_states:
        arrays += [rs.standard_normal((B, H)).astype(np.float32)
                   for _ in range(n_states)]

    def call(layer, ts):
        if len(ts) == 1:
            return layer(ts[0])
        return layer(ts[0], tuple(ts[1:]) if n_states == 2 else ts[1])

    _compare(jl, pl, arrays, call)


@pytest.mark.parametrize("time_major", [False, True])
@pytest.mark.parametrize("wrapper", ["RNN", "RNN-reverse", "BiRNN"])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_rnn_wrappers_match_jax(cell, wrapper, time_major):
    cls, kw, _ = CELLS[cell]

    def build(nn):
        if wrapper == "BiRNN":
            return nn.BiRNN(getattr(nn, cls)(C, H, **kw),
                            getattr(nn, cls)(C, H, **kw), time_major)
        return nn.RNN(getattr(nn, cls)(C, H, **kw),
                      is_reverse=wrapper.endswith("reverse"),
                      time_major=time_major)

    paddle_tpu.seed(3)
    jl, pl = build(jnn), build(pnn)
    rs = np.random.RandomState(5)
    x = rs.standard_normal((T, B, C) if time_major else (B, T, C))
    _compare(jl, pl, [x.astype(np.float32)], lambda layer, ts: layer(ts[0]))


def test_get_initial_states_and_torch_boundary():
    cell = pnn.LSTMCell(C, H)
    x = paddle_tpu_torch.zeros([B, C])
    h, c = cell.get_initial_states(x, init_value=0.5)
    assert isinstance(h, paddle_tpu_torch.Tensor) and h.shape == [B, H]
    np.testing.assert_array_equal(c.numpy(), np.full((B, H), 0.5))
    jh, _ = jnn.LSTMCell(C, H).get_initial_states(paddle_tpu.zeros([B, C]),
                                                  init_value=0.5)
    assert jh.shape == h.shape
    # torch tensors in give torch tensors out (CRNN calls LSTM so)
    lstm = pnn.LSTM(C, H, direction="bidirect")
    out, (hn, cn) = lstm(torch.zeros(B, T, C))
    assert type(out) is torch.Tensor and tuple(out.shape) == (B, T, 2 * H)
    assert tuple(hn.shape) == (2, B, H) and type(cn) is torch.Tensor
    gru = pnn.GRU(C, H)
    assert sorted(dict(gru.named_parameters())) == [
        "bias_hh_l0", "bias_ih_l0", "weight_hh_l0", "weight_ih_l0"]


def test_attrs_and_refusals():
    no_bias = pnn.GRU(C, H, bias_ih_attr=False, bias_hh_attr=False)
    assert sorted(dict(no_bias.named_parameters())) == [
        "weight_hh_l0", "weight_ih_l0"]
    jl = jnn.GRU(C, H, bias_ih_attr=False, bias_hh_attr=False)
    x = np.random.RandomState(0).standard_normal((B, T, C)).astype(np.float32)
    assert no_bias.set_state_dict(
        {k: v.numpy() for k, v in jl.state_dict().items()}) == ([], [])
    np.testing.assert_allclose(
        no_bias(paddle_tpu_torch.to_tensor(x))[0].numpy(),
        jl(paddle_tpu.to_tensor(x))[0].numpy(), **OUT_TOL)
    frozen = pnn.LSTMCell(C, H, weight_ih_attr=pnn.ParamAttr(
        trainable=False))
    assert frozen.weight_ih.stop_gradient and not frozen.weight_hh.stop_gradient
    with pytest.raises(ValueError):
        pnn.LSTM(C, H, direction="backward")
    with pytest.raises(ValueError):
        pnn.GRU(C, H, bias_ih_attr=False)
    with pytest.raises(ValueError):
        pnn.SimpleRNNCell(C, H, weight_hh_attr=False)
