"""The CPU parity sweep of the port's registered ops against the JAX
package's, by family (the module that defines each port op), shared by
``tests/test_torch_ops_*.py``: both packages get the same seeded numpy
inputs from the registry sweep's ``SPECS``."""
from __future__ import annotations

import paddle_tpu as jpaddle
from paddle_tpu.core.dtype import dtype_name as jax_dtype_name
from paddle_tpu.core.op import OP_REGISTRY as JAX_OPS

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.core.dtype import dtype_name as port_dtype_name
from paddle_tpu_torch.core.op import OP_REGISTRY as PORT_OPS

from _torch_op_specs import (PORT_ARGS, PORT_GRADS, SPECS, assert_same,
                             inputs, run_op, tolerance)


def family(*modules):
    """The port's registered ops defined in ``paddle_tpu_torch.<module>``
    for any of ``modules``, sorted."""
    return sorted(n for n, op in PORT_OPS.items()
                  if op.raw.__module__.split("paddle_tpu_torch.", 1)[1]
                  in modules)


def check(name):
    tpaddle.set_device("cpu")
    _, kwargs, check_grad = SPECS[name]
    raw = inputs(name)
    want = run_op(jpaddle, JAX_OPS[name], raw, kwargs, check_grad,
                  jax_dtype_name)
    port_raw = PORT_ARGS.get(name, lambda a: a)(raw)
    outs, grads = run_op(tpaddle, PORT_OPS[name], port_raw, kwargs,
                         check_grad, port_dtype_name)
    assert_same(name, want, (outs, PORT_GRADS.get(name, list)(grads)),
                *tolerance(name))
