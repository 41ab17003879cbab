"""Op definition machinery of the port (``paddle_tpu.core.op``
counterpart).

``@defop`` turns a function of torch tensors into a paddle op: a call
with a surface ``Tensor`` among its positional or keyword arguments (or
in a list or tuple there) runs on their ``_value``s and wraps the result
back into Tensors; a call with none runs the function as it is, so the
port's models call the same functions on bare ``torch.Tensor``s with no
wrapping.  Autograd needs nothing here: torch records the operations on
``_value``.  ``OP_REGISTRY`` names the ops (a subset of the JAX
package's, name for name) and ``op.raw`` is the function itself.

``CHECK_NAN_INF`` is ``FLAGS_check_nan_inf``: every op's floating
outputs are scanned and a NaN or Inf raises.

Mixed precision (``amp.auto_cast``) acts here, on both branches, as the
JAX package's ``apply_op`` does: inside a scope, the op's name picks the
dtype its float arguments are cast to (``amp.auto_cast.should_cast``),
whether they came as surface Tensors or as bare torch tensors (a Layer's
forward calls ``nn.functional`` on unwrapped values, a nested op on its
callers').  The cast is a torch op, so gradients return to the leaves in
their own dtype.  Outside a scope the hook is one thread-local read.

``TELEMETRY`` (op-dispatch timing) is not ported yet (ROADMAP module
entry 9): the flag is read by nothing.
"""
from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch

from ..amp.auto_cast import _state as _AMP
from ..amp.auto_cast import should_cast
from .tensor import Tensor

__all__ = ["OP_REGISTRY", "CHECK_NAN_INF", "TELEMETRY", "apply_op", "defop",
           "register_tensor_method"]

OP_REGISTRY: dict[str, Callable] = {}

# FLAGS_check_nan_inf: per-op output scan, parity with
# framework/details/nan_inf_utils_detail.cc:341 CheckVarHasNanOrInf
CHECK_NAN_INF = False

# op-dispatch telemetry: read once observability/dispatch.py is ported
TELEMETRY = False

_SEQ = (list, tuple)


def _scan_nan_inf(name, out):
    vals = out if isinstance(out, _SEQ) else (out,)
    for i, v in enumerate(vals):
        if isinstance(v, Tensor):
            v = v._value
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            bad = ~torch.isfinite(v)
            # the sync IS the feature: decide whether to crash
            if bool(bad.any()):
                n_nan = int(torch.isnan(v).sum())
                n_inf = int(torch.isinf(v).sum())
                from ..observability import flight
                flight.record("nan_inf", name, output=i, nan=n_nan,
                              inf=n_inf, shape=str(tuple(v.shape)))
                raise RuntimeError(
                    f"Operator {name} output {i} contains "
                    f"{n_nan} NaN and {n_inf} Inf values "
                    f"(FLAGS_check_nan_inf is set)")


def _first_tensor(args, kwargs):
    """The first surface Tensor among the arguments (one level into
    lists and tuples), or None."""
    for a in args:
        if isinstance(a, Tensor):
            return a
        if isinstance(a, _SEQ):
            for b in a:
                if isinstance(b, Tensor):
                    return b
    for a in kwargs.values():
        if isinstance(a, Tensor):
            return a
        if isinstance(a, _SEQ):
            for b in a:
                if isinstance(b, Tensor):
                    return b
    return None


def _unwrap(a, first):
    """``a`` as the op's raw function takes it: a Tensor's value, a numpy
    array as a tensor on ``first``'s device."""
    if isinstance(a, Tensor):
        return a._value
    if isinstance(a, np.ndarray):
        return torch.as_tensor(a, device=first._value.device)
    if isinstance(a, list):
        return [_unwrap(b, first) for b in a]
    if isinstance(a, tuple):
        return tuple(_unwrap(b, first) for b in a)
    return a


def _wrap(out):
    if isinstance(out, torch.Tensor):
        return Tensor._wrap(out)
    if isinstance(out, tuple):          # torch.return_types become tuples
        return tuple(_wrap(o) for o in out)
    if isinstance(out, list):
        return [_wrap(o) for o in out]
    return out


def _amp_cast(name, args, kwargs):
    """The arguments with their float tensors cast as the active
    ``auto_cast`` scope decides for op ``name`` (unchanged without a
    decision)."""
    mode = should_cast(name)
    if mode is None:
        return args, kwargs
    if mode == "low":
        low = _AMP.dtype

        def cast(v):
            return v.to(low) if v.dtype == torch.float32 else v
    else:
        def cast(v):
            return v.float() if v.dtype in (torch.float16, torch.bfloat16) \
                else v

    def each(a):
        if isinstance(a, torch.Tensor):
            return cast(a)
        if isinstance(a, _SEQ) and any(isinstance(b, torch.Tensor)
                                       for b in a):
            return type(a)(cast(b) if isinstance(b, torch.Tensor) else b
                           for b in a)
        return a

    return [each(a) for a in args], {k: each(v) for k, v in kwargs.items()}


def apply_op(fn, name, args, kwargs):
    """Run ``fn`` on the arguments' values; Tensors in give Tensors out."""
    first = _first_tensor(args, kwargs)
    if first is None:
        if _AMP.enabled:
            args, kwargs = _amp_cast(name, args, kwargs)
        out = fn(*args, **kwargs)
        if CHECK_NAN_INF:
            _scan_nan_inf(name, out)
        return out
    raw = [a._value if isinstance(a, Tensor) else _unwrap(a, first)
           for a in args]
    if kwargs:
        kwargs = {k: _unwrap(v, first) for k, v in kwargs.items()}
    if _AMP.enabled:
        raw, kwargs = _amp_cast(name, raw, kwargs)
    out = fn(*raw, **kwargs) if kwargs else fn(*raw)
    if CHECK_NAN_INF:
        _scan_nan_inf(name, out)
    return _wrap(out)


def defop(fn=None, *, name=None, tensor_method=None, register=True):
    """Declare an op from a function of torch tensors.

    tensor_method: name (or list of names) to also install as Tensor
    method(s).  register=False gives the Tensor boundary without an
    ``OP_REGISTRY`` entry (functions the JAX package does not register).
    """
    if fn is None:
        return functools.partial(defop, name=name,
                                 tensor_method=tensor_method,
                                 register=register)
    op_name = name or fn.__name__

    @functools.wraps(fn)
    def op(*args, **kwargs):
        return apply_op(fn, op_name, args, kwargs)

    op.raw = fn
    op.op_name = op_name
    if register:
        OP_REGISTRY[op_name] = op
    if tensor_method:
        names = tensor_method if isinstance(tensor_method, _SEQ) \
            else [tensor_method]
        for m in names:
            setattr(Tensor, m, op)
    return op


def register_tensor_method(name):
    """Install an already-built callable as a Tensor method."""
    def deco(f):
        setattr(Tensor, name, f)
        return f
    return deco
