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
