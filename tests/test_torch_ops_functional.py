"""The port's ``nn.functional`` at the Tensor boundary.

* Parity sweep of the F functions the port registers against the JAX
  package's (same seeded inputs from the registry sweep's ``SPECS``):
  values and dtypes, gradients where the spec marks the op
  differentiable; f32 to 1e-5 relative (1e-6 absolute).
* The boundary rule: a ``torch.Tensor`` in gives a ``torch.Tensor`` out
  (the models' path, no wrapping), a surface ``Tensor`` in gives a
  ``Tensor`` out; gradients through ``F.scaled_dot_product_attention``
  (the flash wrapper's plain version on the CPU) and ``F.layer_norm``
  on surface Tensors equal the bare-torch call's to 1e-6.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as paddle
import paddle_tpu_torch.nn.functional as F
from _torch_op_parity import check, family

FUNCTIONAL = ("activation", "attention", "norm", "loss", "common", "conv",
              "pooling", "extra")


@pytest.mark.parametrize("name", family(*(f"nn.functional.{m}"
                                          for m in FUNCTIONAL)))
def test_functional_matches_jax(name):
    check(name)


def _inputs(seed=0):
    rs = np.random.RandomState(seed)
    q, k, v = (rs.standard_normal((2, 16, 2, 8)).astype(np.float32)
               for _ in range(3))
    x = rs.standard_normal((4, 6, 32)).astype(np.float32)
    w = rs.standard_normal(32).astype(np.float32)
    b = rs.standard_normal(32).astype(np.float32)
    return q, k, v, x, w, b


def test_torch_in_torch_out_tensor_in_tensor_out():
    paddle.set_device("cpu")
    x = np.random.RandomState(1).standard_normal((3, 5)).astype(np.float32)
    for fn, args in ((F.gelu, ()), (F.relu, ()), (F.layer_norm, (5,)),
                     (F.softplus, ()), (F.batch_norm, (torch.zeros(5),
                                                       torch.ones(5)))):
        out = fn(torch.from_numpy(x), *args)
        assert type(out) is torch.Tensor, fn.__name__
        tout = fn(paddle.to_tensor(x), *args)
        assert isinstance(tout, paddle.Tensor), fn.__name__
        np.testing.assert_array_equal(tout.numpy(), out.numpy())
    q, k, v, *_ = _inputs()
    out = F.scaled_dot_product_attention(*map(torch.from_numpy, (q, k, v)),
                                         is_causal=True)
    assert type(out) is torch.Tensor
    tout = F.scaled_dot_product_attention(*map(paddle.to_tensor, (q, k, v)),
                                          is_causal=True)
    assert isinstance(tout, paddle.Tensor) and tout.place == paddle.CPUPlace()
    np.testing.assert_array_equal(tout.numpy(), out.numpy())


def test_grads_through_attention_and_layer_norm_match_bare_torch():
    paddle.set_device("cpu")
    q, k, v, x, w, b = _inputs(2)

    def surface():
        ts = [paddle.to_tensor(a, stop_gradient=False)
              for a in (q, k, v, x, w, b)]
        att = F.scaled_dot_product_attention(*ts[:3], is_causal=True)
        ln = F.layer_norm(ts[3], 32, ts[4], ts[5])
        loss = (att * att).sum() + (ln * ln.tanh()).mean()
        loss.backward()
        return loss.item(), [t.grad.numpy() for t in ts]

    def bare():
        ts = [torch.tensor(a, requires_grad=True)
              for a in (q, k, v, x, w, b)]
        att = F.scaled_dot_product_attention(*ts[:3], is_causal=True)
        ln = F.layer_norm(ts[3], 32, ts[4], ts[5])
        loss = (att * att).sum() + (ln * ln.tanh()).mean()
        loss.backward()
        return loss.item(), [t.grad.numpy() for t in ts]

    (l1, g1), (l2, g2) = surface(), bare()
    assert l1 == pytest.approx(l2, rel=1e-6)
    for a, c in zip(g1, g2):
        np.testing.assert_allclose(a, c, rtol=1e-6, atol=1e-6)
