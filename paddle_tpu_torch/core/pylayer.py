"""PyLayer — user-defined autograd ops (``paddle_tpu.core.pylayer``
counterpart; reference python/paddle/autograd/py_layer.py), on
``torch.autograd.Function``.

``forward(ctx, *args, **kwargs)`` and ``backward(ctx, *grads)`` take and
return surface Tensors.  ``backward`` returns one grad per Tensor input,
or one per input that requires grad (as the JAX package accepts); a
``None`` grad is a zero.  Tensors given to ``ctx.save_for_backward`` go
through torch's saved-tensor machinery, so a ``backward`` built from
paddle ops is itself differentiable (``paddle.grad(...,
create_graph=True)`` through a PyLayer).
"""
from __future__ import annotations

import torch

from .tensor import Tensor

__all__ = ["PyLayer", "PyLayerContext", "PyLayerMeta"]


class PyLayerContext:
    def __init__(self):
        self._fn_ctx = None
        self._saved_meta = self._others = ()
        self.not_inplace_tensors = ()

    def save_for_backward(self, *tensors):
        self._saved_meta = tuple(isinstance(t, Tensor) for t in tensors)
        self._fn_ctx.save_for_backward(
            *[t._value if isinstance(t, Tensor) else None for t in tensors])
        self._others = tuple(None if isinstance(t, Tensor) else t
                             for t in tensors)

    def saved_tensor(self):
        vals = self._fn_ctx.saved_tensors
        return tuple(Tensor._wrap(v) if is_t else o for v, is_t, o in
                     zip(vals, self._saved_meta, self._others))


class PyLayerMeta(type):
    pass


_N_META = 4          # layer, kw_names, n_args, meta


class _Function(torch.autograd.Function):
    """The torch Function under every PyLayer: ``apply(layer, kw_names,
    n_args, meta, *args_and_kwarg_values)``; ``meta["single"]`` tells
    whether the layer returned one output."""

    @staticmethod
    def forward(fn_ctx, layer, kw_names, n_args, meta, *flat):
        ctx = PyLayerContext()
        ctx._fn_ctx = fn_ctx
        wrapped = [Tensor._wrap(v) if isinstance(v, torch.Tensor) else v
                   for v in flat]
        out = layer.forward(ctx, *wrapped[:n_args],
                            **dict(zip(kw_names, wrapped[n_args:])))
        fn_ctx.layer, fn_ctx.ctx = layer, ctx
        fn_ctx.tensor_pos = [i for i, v in enumerate(flat)
                             if isinstance(v, torch.Tensor)]
        meta["single"] = not isinstance(out, (tuple, list))
        outs = [out] if meta["single"] else list(out)
        return tuple(o._value if isinstance(o, Tensor) else torch.as_tensor(o)
                     for o in outs)

    @staticmethod
    def backward(fn_ctx, *grads):
        gin = fn_ctx.layer.backward(fn_ctx.ctx,
                                    *[Tensor._wrap(g) for g in grads])
        gin = [gin] if isinstance(gin, Tensor) or gin is None else list(gin)
        pos = fn_ctx.tensor_pos
        if len(gin) != len(pos):
            # one grad per input that requires grad
            pos = [p for p, need in zip(pos, (
                fn_ctx.needs_input_grad[_N_META + p] for p in pos)) if need]
        out = [None] * (len(fn_ctx.needs_input_grad) - _N_META)
        for p, g in zip(pos, gin):
            out[p] = g._value if isinstance(g, Tensor) else g
        return (None,) * _N_META + tuple(out)


class PyLayer(metaclass=PyLayerMeta):
    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        flat = [a._value if isinstance(a, Tensor) else a
                for a in (*args, *kwargs.values())]
        meta = {}
        outs = _Function.apply(cls, tuple(kwargs), len(args), meta, *flat)
        wrapped = tuple(Tensor._wrap(o) for o in outs)
        return wrapped[0] if meta["single"] else wrapped
