"""Comparison / logical / bitwise ops (``paddle_tpu.ops.logic``
counterpart; reference python/paddle/tensor/logic.py)."""
from __future__ import annotations

import numpy as np
import torch

from ..core.dtype import operands
from ..core.op import apply_op, defop
from ..core.tensor import Tensor

__all__ = ["equal", "not_equal", "less_than", "less_equal", "greater_than",
           "greater_equal", "logical_and", "logical_or", "logical_xor",
           "logical_not", "bitwise_and", "bitwise_or", "bitwise_xor",
           "bitwise_not", "equal_all", "allclose", "isclose", "is_empty",
           "is_tensor", "where"]


def _binary(name, fn):
    def f(x, y, *args, name=None, **kwargs):
        return fn(*operands(x, y))
    f.__name__ = f.__qualname__ = name
    return defop(f, tensor_method=name)


equal = _binary("equal", torch.eq)
not_equal = _binary("not_equal", torch.ne)
less_than = _binary("less_than", torch.lt)
less_equal = _binary("less_equal", torch.le)
greater_than = _binary("greater_than", torch.gt)
greater_equal = _binary("greater_equal", torch.ge)
logical_and = _binary("logical_and", torch.logical_and)
logical_or = _binary("logical_or", torch.logical_or)
logical_xor = _binary("logical_xor", torch.logical_xor)
bitwise_and = _binary("bitwise_and", torch.bitwise_and)
bitwise_or = _binary("bitwise_or", torch.bitwise_or)
bitwise_xor = _binary("bitwise_xor", torch.bitwise_xor)


@defop(tensor_method="logical_not")
def logical_not(x, out=None, name=None):
    return torch.logical_not(x)


@defop(tensor_method="bitwise_not")
def bitwise_not(x, name=None):
    return torch.bitwise_not(x)


@defop(tensor_method="equal_all")
def equal_all(x, y, name=None):
    if x.shape != y.shape:
        return torch.tensor(False, device=x.device)
    return torch.eq(*operands(x, y)).all()


@defop(tensor_method="allclose")
def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return torch.isclose(*operands(x, y), rtol=rtol, atol=atol,
                         equal_nan=equal_nan).all()


@defop(tensor_method="isclose")
def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return torch.isclose(*operands(x, y), rtol=rtol, atol=atol,
                         equal_nan=equal_nan)


def is_empty(x, name=None):
    return Tensor._wrap(torch.tensor(x._value.numel() == 0,
                                     device=x._value.device))


def is_tensor(x):
    return isinstance(x, Tensor)


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        from .search import nonzero
        return nonzero(condition, as_tuple=True)
    return apply_op(lambda c, a, b: torch.where(c, *operands(a, b)), "where",
                    (condition, x, y), {})


# operator overloads -----------------------------------------------------------

def _cmp(op):
    def method(self, other):
        if isinstance(other, (list, tuple, np.ndarray)):
            other = Tensor._wrap(torch.as_tensor(np.asarray(other),
                                                 device=self._value.device))
        return op(self, other)
    return method


Tensor.__eq__ = _cmp(equal)
Tensor.__ne__ = _cmp(not_equal)
Tensor.__lt__ = _cmp(less_than)
Tensor.__le__ = _cmp(less_equal)
Tensor.__gt__ = _cmp(greater_than)
Tensor.__ge__ = _cmp(greater_equal)
Tensor.__and__ = _cmp(bitwise_and)
Tensor.__or__ = _cmp(bitwise_or)
Tensor.__xor__ = _cmp(bitwise_xor)
Tensor.__invert__ = lambda self: bitwise_not(self)
