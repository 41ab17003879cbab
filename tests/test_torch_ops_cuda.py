"""The port's registered ops on the card against the same ops on the CPU.

Every test here is marked ``cuda`` and skips without a card (decided in
a fixture at run time, so every worker collects the same tests); this
file imports no JAX.  Run on the chip: ``python -m pytest -m cuda
tests/test_torch_*.py``.

The inputs are the registry sweep's ``SPECS`` (``_torch_op_specs``, read
from its source without importing JAX), the same numpy arrays on both
sides; f32 with TF32 off.  Forward values, dtypes and, where the spec
marks the op differentiable, gradients agree to 1e-4 relative (1e-5
absolute): the card's reductions and linear algebra sum in another order
than the CPU's.  The attention ops take head size 16 here (the spec's
4 is below the flash kernels' smallest, and a CUDA tensor launches the
kernel or raises).
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as paddle
from _torch_op_specs import PORT_ARGS, SPECS, assert_same, inputs, run_op
from paddle_tpu_torch.core.dtype import dtype_name
from paddle_tpu_torch.core.op import OP_REGISTRY

_rs = np.random.RandomState(16)
CARD_ARGS = {
    "scaled_dot_product_attention": lambda: tuple(
        _rs.standard_normal((2, 8, 2, 16)).astype("float32")
        for _ in range(3)),
    "fused_qkv_attention": lambda: (
        _rs.standard_normal((2, 8, 2, 3, 16)).astype("float32"),),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the chip)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    paddle.set_device("cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(set(OP_REGISTRY) & set(SPECS)))
def test_op_on_the_card_matches_the_cpu(cuda, name):
    _, kwargs, check_grad = SPECS[name]
    raw = CARD_ARGS[name]() if name in CARD_ARGS else \
        PORT_ARGS.get(name, lambda a: a)(inputs(name))
    op = OP_REGISTRY[name]
    paddle.set_device("cpu")
    want = run_op(paddle, op, raw, kwargs, check_grad, dtype_name)
    paddle.set_device("gpu")
    got = run_op(paddle, op, raw, kwargs, check_grad, dtype_name)
    assert_same(name, want, got, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_places_on_the_card(cuda):
    paddle.set_device("gpu")
    x = paddle.to_tensor([1.0, 2.0], stop_gradient=False)
    assert x.place == paddle.CUDAPlace(0) and paddle.get_device() == "gpu:0"
    y = (x * x).sum()
    y.backward()
    assert x.grad.place == paddle.CUDAPlace(0)
    np.testing.assert_array_equal(x.grad.numpy(), [2.0, 4.0])
    pinned = paddle.to_tensor([1.0], place=paddle.CUDAPinnedPlace())
    assert pinned.place == paddle.CUDAPinnedPlace() and pinned.value.is_pinned()
    assert x.cpu().place == paddle.CPUPlace()
    assert paddle.to_tensor([3.0], place=paddle.CPUPlace()).to(
        "gpu:0").place == paddle.CUDAPlace(0)
    assert paddle.device.cuda.memory_allocated() > 0
    b = paddle.ones([4], "bfloat16")
    assert b.numpy().dtype == np.float32       # no numpy bf16: f32 values
