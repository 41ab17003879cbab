"""Every Layer class of the port's ``nn`` against the JAX package's, on the
CPU, from the spec table in ``tests/_torch_nn_specs.py``.

For each spec the same call builds the layer in both packages, the JAX
layer's numpy ``state_dict()`` goes into the port's through
``set_state_dict`` (same keys and shapes, nothing transposed: nothing
missing, nothing unexpected), and both run on the same seeded inputs as
surface Tensors.  Outputs, the gradients of a fixed random projection of
the outputs with respect to the float inputs and every parameter, and the
state after the call (batch norm's running statistics) agree to 1e-5
relative and 2e-5 absolute in f32 (the port's reductions and products sum
in another order than XLA's).  The JAX side runs with
``jax_default_matmul_precision`` "highest" (``tests/conftest.py``).
"""
import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch
from _torch_cpu_place import cpu_place  # noqa: F401
from _torch_nn_specs import SPECS, run, state

TOL = dict(rtol=1e-5, atol=2e-5)


def _close(got, want, what):
    assert (got is None) == (want is None), what
    if want is not None:
        assert np.shape(got) == np.shape(want), what
        np.testing.assert_allclose(got, want, err_msg=what, **TOL)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_layer_matches_jax(name):
    paddle_tpu.seed(0)
    jl = SPECS[name].make(paddle_tpu)
    pl = SPECS[name].make(paddle_tpu_torch)
    jstate = state(jl)
    assert {k: v.shape for k, v in state(pl).items()} == \
        {k: v.shape for k, v in jstate.items()}
    assert pl.set_state_dict(jstate) == ([], [])
    want = run(paddle_tpu, jl, name)
    got = run(paddle_tpu_torch, pl, name)
    for what, g, w in (("outputs", got[0], want[0]),
                       ("input grads", got[1], want[1])):
        assert len(g) == len(w), what
        for i, (a, b) in enumerate(zip(g, w)):
            _close(a, b, f"{name} {what} {i}")
    assert sorted(got[2]) == sorted(want[2]), name
    for k in want[2]:
        _close(got[2][k], want[2][k], f"{name} grad of {k}")
    for k in want[3]:
        _close(got[3][k], want[3][k], f"{name} state {k} after the call")
