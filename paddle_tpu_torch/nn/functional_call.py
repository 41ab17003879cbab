"""Functional execution of stateful Layers (``paddle_tpu.nn.functional_call``
counterparts), on ``torch.func.functional_call``.

The JAX package swaps each parameter's and buffer's value for a (traced)
one, runs the Layer's forward and reads back the buffers it replaced,
which is how ``jax.jit`` / ``jax.grad`` reach a Layer.  The port hands
the values to ``torch.func.functional_call``, so ``torch.func.grad`` /
``vjp`` / ``vmap`` (or plain autograd on values that require grad)
differentiate through them.  Buffers are passed as copies, so a forward
that updates a buffer in place (batch norm's running statistics) leaves
the caller's values as they were and returns the updated ones.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from ..core.tensor import Tensor
from .layer_base import Parameter

__all__ = ["state_values", "trainable_mask", "functional_call", "module_fn"]


def state_values(layer) -> dict[str, Any]:
    """name -> torch value of every parameter and persistable buffer."""
    return {k: v._value for k, v in layer.state_dict().items()}


def trainable_mask(layer) -> dict[str, bool]:
    """name -> whether the entry is a trainable parameter."""
    return {k: isinstance(v, Parameter) and v.trainable
            for k, v in layer.state_dict().items()}


def functional_call(layer, values: dict[str, Any], args=(), kwargs=None,
                    mutable_buffers: bool = True):
    """Run ``layer(*args, **kwargs)`` with parameter and buffer values
    taken from ``values`` (torch tensors or surface Tensors; missing names
    keep the layer's own).  Returns ``(output, new_buffer_values)``: the
    buffers the call updated, by name (empty without
    ``mutable_buffers``)."""
    kwargs = kwargs or {}
    raw = {k: v._value if isinstance(v, Tensor) else v
           for k, v in values.items()}
    params = {k for k, _ in torch.nn.Module.named_parameters(layer)}
    buffers = {k: t.clone() for k, t in raw.items()
               if k not in params and isinstance(t, torch.Tensor)}
    raw.update(buffers)
    versions = {k: t._version for k, t in buffers.items()}
    out = torch.func.functional_call(layer, raw, tuple(args), kwargs)
    new_buffers = {k: t for k, t in buffers.items()
                   if mutable_buffers and t._version != versions[k]}
    return out, new_buffers


def module_fn(layer) -> Callable:
    """layer -> ``fn(values, *raw_args) -> (raw_out, new_buffers)`` on
    torch tensors."""
    def fn(values, *raw_args):
        out, new_buffers = functional_call(layer, values, raw_args)
        return out, new_buffers
    return fn
