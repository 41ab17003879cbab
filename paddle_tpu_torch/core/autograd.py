"""Eager autograd of the port (``paddle_tpu.core.autograd``
counterpart), over ``torch.autograd``.

The JAX package records a vjp closure per op and walks its own tape; the
port's ops run torch operations on ``Tensor._value``, so torch's engine
is the tape.  ``no_grad`` / ``enable_grad`` / ``set_grad_enabled`` are
torch's grad mode (thread-local, as the JAX package's), so they govern
the port's models as well.
"""
from __future__ import annotations

import contextlib

from typing import Any, Sequence

import torch

from .tensor import Tensor

__all__ = ["backward", "grad", "no_grad", "enable_grad", "set_grad_enabled",
           "is_grad_enabled", "saved_tensors_hooks"]

no_grad = torch.no_grad
enable_grad = torch.enable_grad
is_grad_enabled = torch.is_grad_enabled
saved_tensors_hooks = torch.autograd.graph.saved_tensors_hooks


def set_grad_enabled(mode: bool):
    torch.set_grad_enabled(bool(mode))


def _raw(g, like: torch.Tensor):
    if g is None or isinstance(g, torch.Tensor):
        return g
    if isinstance(g, Tensor):
        return g._value
    return torch.as_tensor(g, dtype=like.dtype, device=like.device)


def backward(tensors: Sequence[Tensor],
             grad_tensors: Sequence[Any] | None = None,
             retain_graph: bool = False):
    """Accumulate into ``.grad`` of the leaves that ``tensors`` depend on
    (≈ egr::Backward).  A root that needs no grad is skipped, as the JAX
    package skips it; a root with more than one element needs its grad
    tensor."""
    tensors = list(tensors)
    grad_tensors = [None] * len(tensors) if grad_tensors is None \
        else list(grad_tensors)
    roots, seeds = [], []
    for t, g in zip(tensors, grad_tensors):
        if t._value.requires_grad:
            roots.append(t._value)
            seeds.append(_raw(g, t._value))
    if roots:
        torch.autograd.backward(roots, seeds, retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, allow_unused=False):
    """paddle.grad — the gradients of ``outputs`` with respect to
    ``inputs``, mutating no ``.grad`` (reference dygraph/base.py:432-465).
    With ``create_graph=True`` the returned grads are differentiable
    (grad mode is forced on for the pass, as in the JAX package)."""
    outputs = outputs if isinstance(outputs, (list, tuple)) else [outputs]
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    if grad_outputs is not None and not isinstance(grad_outputs,
                                                   (list, tuple)):
        grad_outputs = [grad_outputs]
    outs = [o._value for o in outputs]
    seeds = None if grad_outputs is None else \
        [_raw(g, o) for g, o in zip(grad_outputs, outs)]
    with torch.enable_grad() if create_graph else contextlib.nullcontext():
        res = torch.autograd.grad(
            outs, [t._value for t in inputs], grad_outputs=seeds,
            retain_graph=create_graph if retain_graph is None
            else bool(retain_graph),
            create_graph=create_graph, allow_unused=allow_unused)
    return [None if g is None else Tensor._wrap(g) for g in res]
