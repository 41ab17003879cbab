"""The slice whole: a paddle-style training script of ``nn`` Layers on
surface Tensors, run unchanged on both packages on the CPU.

The script is the card's phase 40 (``chip_smoke.py``) cut to 2 layers at
d_model 64 (4 heads, feed-forward 128, vocabulary 97, 16 positions): a
word and a position ``nn.Embedding``, ``nn.LayerNorm``, an
``nn.TransformerEncoder`` of GELU ``nn.TransformerEncoderLayer``s, a bias
made by ``create_parameter``, an ``nn.Linear`` head whose weight has a
``ParamAttr`` initializer, ``nn.CrossEntropyLoss``; ``AdamW(parameters=
net.parameters(), grad_clip=ClipGradByGlobalNorm(1.0))`` and ``loss.backward();
opt.step(); opt.clear_grad()``.  The port's net takes the JAX net's numpy
state through ``set_state_dict`` (same keys, shapes, no transposes).
Over 3 steps with dropout 0 the losses agree to 1e-5 relative and every
parameter to 1e-4.  A second run in training mode with dropout 0.1 on the
port: the loss falls on one fixed batch.
"""
import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch
from _torch_cpu_place import cpu_place  # noqa: F401
from _torch_nn_specs import D, FFN, V, build
from _torch_nn_specs import batch as _batch
from _torch_nn_specs import train as _train


def test_script_matches_jax_for_three_adamw_steps():
    paddle_tpu.seed(0)
    jnet = build(paddle_tpu)
    pnet = build(paddle_tpu_torch)
    state = {k: np.asarray(v.numpy()) for k, v in jnet.state_dict().items()}
    assert list(pnet.state_dict()) == list(state)
    assert pnet.set_state_dict(state) == ([], [])
    for net in (jnet, pnet):
        assert net.head.weight.shape == [D, V]
        assert net.encoder.layers[1].linear1.weight.shape == [D, FFN]
    batch = _batch()
    want = _train(paddle_tpu, jnet, 3, batch)
    got = _train(paddle_tpu_torch, pnet, 3, batch)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    psd = pnet.state_dict()
    for k, v in jnet.state_dict().items():
        np.testing.assert_allclose(psd[k].numpy(), v.numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=k)


@pytest.mark.parametrize("steps", [5])
def test_loss_falls_in_training_mode_with_dropout(steps):
    paddle_tpu_torch.seed(1)
    net = build(paddle_tpu_torch, dropout=0.1)
    net.train()
    losses = _train(paddle_tpu_torch, net, steps, _batch(1))
    assert losses[-1] < losses[0], losses
    assert all(np.isfinite(losses))
