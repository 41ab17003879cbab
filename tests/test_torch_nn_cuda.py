"""The port's ``nn`` Layers on the card against the same Layers on the CPU.

Every test here is marked ``cuda`` and skips without a card (decided in a
fixture at run time, so every worker collects the same tests); this file
imports no JAX.  Run on the chip: ``python -m pytest -m cuda
tests/test_torch_*.py``.

Each spec of ``tests/_torch_nn_specs.py`` (the attention ones at head
size 16, ``CARD_SPECS``) is built on the CPU and on ``CUDAPlace(0)``, the
CPU layer's state carried into the card's with ``set_state_dict``, and
both run on the same inputs: outputs, input and parameter gradients and
the state after the call agree to 1e-4 relative (1e-5 absolute) in f32
with TF32 off (the card's reductions sum in another order); every output,
gradient and parameter of the card's run lies on the card.  The slice's
training script (``build``, 2 layers at d_model 64) trains 3 AdamW steps
on both (AdamW's epsilon 1e-6): losses within 1e-4 relative,
parameters within 1e-4.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as paddle
from _torch_nn_specs import CARD_SPECS, SPECS, batch, build, run, state, train


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the chip)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    paddle.set_device("cpu")


def _close(got, want, what):
    assert (got is None) == (want is None), what
    if want is not None:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                   err_msg=what)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SPECS))
def test_layer_on_the_card_matches_the_cpu(cuda, name):
    specs = {**SPECS, **CARD_SPECS}
    paddle.set_device("cpu")
    cpu = specs[name].make(paddle)
    start = state(cpu)
    paddle.set_device("gpu")
    card = specs[name].make(paddle)
    assert card.set_state_dict(start) == ([], [])
    paddle.set_device("cpu")
    want = run(paddle, cpu, name, specs)
    paddle.set_device("gpu")
    got = run(paddle, card, name, specs)
    assert {str(p.place) for p in card.parameters()} <= {
        str(paddle.CUDAPlace(0))}
    for what, g, w in (("outputs", got[0], want[0]),
                       ("input grads", got[1], want[1])):
        for i, (a, b) in enumerate(zip(g, w)):
            _close(a, b, f"{name} {what} {i}")
    assert sorted(got[2]) == sorted(want[2])
    for k in want[2]:
        _close(got[2][k], want[2][k], f"{name} grad of {k}")
    for k in want[3]:
        _close(got[3][k], want[3][k], f"{name} state {k}")


@pytest.mark.cuda
def test_training_script_on_the_card_matches_the_cpu(cuda):
    paddle.set_device("cpu")
    cpu = build(paddle)
    paddle.set_device("gpu")
    card = build(paddle)
    assert card.set_state_dict(state(cpu)) == ([], [])
    data = batch()
    # AdamW's epsilon 1e-6: Adam moves a weight by +-lr whatever its
    # gradient's size, so an entry whose terms cancel to rounding level
    # (summed in another order on the card) would flip its step
    paddle.set_device("cpu")
    want = train(paddle, cpu, 3, data, epsilon=1e-6)
    paddle.set_device("gpu")
    got = train(paddle, card, 3, data, epsilon=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    sd = card.state_dict()
    assert {str(v.place) for v in sd.values()} == {str(paddle.CUDAPlace(0))}
    for k, v in cpu.state_dict().items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=k)


# -- the rest of nn and amp on the card ---------------------------------------

RNN_BUILDS = {
    "LSTM": lambda nn: nn.LSTM(16, 32, num_layers=2, direction="bidirect"),
    "GRU": lambda nn: nn.GRU(16, 32, num_layers=2, time_major=True),
    "SimpleRNN": lambda nn: nn.SimpleRNN(16, 32, direction="bidirect",
                                         activation="relu"),
    "RNN-LSTMCell": lambda nn: nn.RNN(nn.LSTMCell(16, 32), is_reverse=True),
    "BiRNN-GRUCell": lambda nn: nn.BiRNN(nn.GRUCell(16, 32),
                                         nn.GRUCell(16, 32)),
}


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    return [out]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(RNN_BUILDS))
def test_recurrent_layer_on_the_card_matches_the_cpu(cuda, name):
    x = np.random.RandomState(0).standard_normal((3, 7, 16)).astype(
        np.float32)
    res = {}
    start = None
    for where in ("cpu", "gpu"):
        paddle.set_device(where)
        paddle.seed(1)
        layer = RNN_BUILDS[name](paddle.nn)
        if start is None:
            start = state(layer)
        else:
            assert layer.set_state_dict(start) == ([], [])
        xt = paddle.to_tensor(x, stop_gradient=False)
        outs = _flat(layer(xt))
        loss = sum(((o * o).sum() for o in outs), paddle.zeros([]))
        loss.backward()
        res[where] = [o.numpy() for o in outs] + [xt.grad.numpy()] + [
            p.grad.numpy() for p in layer.parameters()]
        if where == "gpu":
            assert {str(o.place) for o in outs} == {str(paddle.CUDAPlace(0))}
    for i, (g, w) in enumerate(zip(res["gpu"], res["cpu"])):
        _close(g, w, f"{name} tensor {i}")


@pytest.mark.cuda
def test_auto_cast_launches_bf16_attention_and_f32_layer_norm(cuda):
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import layer_norm as ln
    import paddle_tpu_torch.nn.functional as F

    rs = np.random.RandomState(2)
    q, k, v = (torch.tensor(rs.standard_normal((2, 64, 2, 64)),
                            dtype=torch.float32, device="cuda",
                            requires_grad=True) for _ in range(3))
    # the fused LayerNorm takes affine rows of a multiple of 128
    x = torch.tensor(rs.standard_normal((128, 256)), dtype=torch.bfloat16,
                     device="cuda", requires_grad=True)
    w, b = (torch.tensor(rs.standard_normal(256), dtype=torch.float32,
                         device="cuda", requires_grad=True) for _ in range(2))
    fa.flash_attention_bthd.launches_by_dtype = {}
    fa.flash_attention_bwd.launches_by_dtype = {}
    ln.layer_norm_fused.launches_by_dtype = {}
    ln.enable_fused_layernorm("full")
    try:
        with paddle.amp.auto_cast(level="O1"):
            out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
            y = F.layer_norm(x, 256, w, b)
        assert out.dtype == torch.bfloat16 and y.dtype == torch.float32
        (out.float().sum() + y.sum()).backward()
    finally:
        ln.enable_fused_layernorm("off")
    assert q.grad.dtype == torch.float32 and x.grad.dtype == torch.bfloat16
    assert w.grad.dtype == torch.float32
    assert fa.flash_attention_bthd.launches_by_dtype == {
        ("launches", "bfloat16"): 1}
    assert fa.flash_attention_bwd.launches_by_dtype == {
        (w, "bfloat16"): 1 for w in ("launches_delta", "launches_dkv",
                                     "launches_dq")}
    assert ln.layer_norm_fused.launches_by_dtype == {
        (w, "float32"): 1 for w in ("launches_fwd", "launches_bwd",
                                    "launches_bwd_reduce")}


@pytest.mark.cuda
def test_grad_scaler_on_the_card(cuda):
    paddle.set_device("gpu")
    net = paddle.nn.Linear(4, 3)
    opt = paddle.optimizer.AdamW(1e-3, parameters=net.parameters())
    scaler = paddle.amp.GradScaler(init_loss_scaling=1024.0,
                                   incr_every_n_steps=2)
    x = paddle.to_tensor(np.ones((2, 4), np.float32))
    w0 = net.weight.numpy().copy()
    with paddle.amp.auto_cast():
        loss = net(x).sum()
    scaler.scale(loss).backward()
    g = net.weight.grad.numpy().copy()
    scaler.step(opt)
    opt.clear_grad()
    np.testing.assert_allclose(g, 1024.0 * np.full((4, 3), 2.0), rtol=1e-2)
    assert not np.array_equal(net.weight.numpy(), w0)
    bad = paddle.to_tensor(np.array([[np.inf, 1, 1, 1]], np.float32))
    scaler.scale(net(bad).sum()).backward()
    w1 = net.weight.numpy().copy()
    scaler.step(opt)
    np.testing.assert_array_equal(net.weight.numpy(), w1)
    assert scaler.state_dict()["scale"] == 512.0


@pytest.mark.cuda
def test_beam_search_and_channels_last_on_the_card(cuda):
    import chip_smoke

    dev = torch.device("cuda", 0)
    beam = chip_smoke._amp_beam_check(paddle, dev, 0, V=32, E=16, H=32, k=3,
                                      b=2, steps=6)
    assert beam["ids_shape"][0] == 2
    assert chip_smoke._amp_sparse_attention_check(paddle, dev, 1, B=1, H=2,
                                                  L=64, D=16) < 1e-4
    assert chip_smoke._amp_channels_last_check(paddle, dev, 2, N=2, C=16,
                                               S=8) < 1e-3
