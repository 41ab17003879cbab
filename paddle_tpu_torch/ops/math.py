"""Elementwise / scalar math ops + Tensor operator overloads
(``paddle_tpu.ops.math`` counterpart; reference python/paddle/tensor/
math.py).  Binary ops promote as the JAX package does
(``core.dtype.operands``); float functions take integer inputs as
``core.dtype.inexact`` says."""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.dtype import as_inexact, operands, result_type
from ..core.op import apply_op, defop, register_tensor_method
from ..core.tensor import Tensor

__all__ = [
    "add", "subtract", "multiply", "divide", "floor_divide", "remainder",
    "pow", "maximum", "minimum", "fmax", "fmin", "atan2", "logaddexp",
    "lerp", "kron", "inner", "outer", "abs", "neg", "exp", "expm1", "log",
    "log2", "log10", "log1p", "sqrt", "rsqrt", "square", "sin", "cos",
    "tan", "asin", "acos", "atan", "sinh", "cosh", "tanh", "asinh", "acosh",
    "atanh", "floor", "ceil", "round", "trunc", "frac", "sign", "sgn",
    "reciprocal", "erf", "erfinv", "lgamma", "digamma", "deg2rad",
    "rad2deg", "angle", "conj", "real", "imag", "isnan", "isinf",
    "isfinite", "nan_to_num", "stanh", "scale", "clip", "increment",
    "add_n", "multiplex", "cumsum", "cumprod", "cummax", "cummin",
    "logcumsumexp", "trace", "add_", "subtract_", "multiply_", "scale_",
    "clip_", "exp_", "sqrt_", "rsqrt_", "floor_", "ceil_", "round_",
    "reciprocal_", "tanh_", "remainder_", "zero_", "fill_"]


# --- binary arithmetic --------------------------------------------------------

@defop(tensor_method="add")
def add(x, y, name=None):
    return torch.add(*operands(x, y))


@defop(tensor_method="subtract")
def subtract(x, y, name=None):
    return torch.sub(*operands(x, y))


@defop(tensor_method="multiply")
def multiply(x, y, name=None):
    return torch.mul(*operands(x, y))


@defop(tensor_method="divide")
def divide(x, y, name=None):
    x, y = operands(x, y)
    return torch.true_divide(as_inexact(x), as_inexact(y))


@defop(tensor_method="floor_divide")
def floor_divide(x, y, name=None):
    return torch.floor_divide(*operands(x, y))


@defop(tensor_method=["mod", "remainder"])
def remainder(x, y, name=None):
    return torch.remainder(*operands(x, y))


@defop(tensor_method="pow")
def pow(x, y, name=None):  # noqa: A001
    return torch.pow(*operands(x, y))


@defop(tensor_method="maximum")
def maximum(x, y, name=None):
    return torch.maximum(*operands(x, y))


@defop(tensor_method="minimum")
def minimum(x, y, name=None):
    return torch.minimum(*operands(x, y))


@defop(tensor_method="fmax")
def fmax(x, y, name=None):
    return torch.fmax(*operands(x, y))


@defop(tensor_method="fmin")
def fmin(x, y, name=None):
    return torch.fmin(*operands(x, y))


@defop
def atan2(x, y, name=None):
    x, y = operands(x, y)
    return torch.atan2(as_inexact(x), as_inexact(y))


@defop
def logaddexp(x, y, name=None):
    x, y = operands(x, y)
    return torch.logaddexp(as_inexact(x), as_inexact(y))


@defop(tensor_method="lerp")
def lerp(x, y, weight, name=None):
    x, y, weight = operands(x, y, weight)
    return x + weight * (y - x)


@defop(tensor_method="kron")
def kron(x, y, name=None):
    return torch.kron(*operands(x, y))


@defop(tensor_method="inner")
def inner(x, y, name=None):
    return torch.inner(*operands(x, y))


@defop(tensor_method="outer")
def outer(x, y, name=None):
    x, y = operands(x, y)
    return torch.outer(x.reshape(-1), y.reshape(-1))


# --- unary --------------------------------------------------------------------

def _unary(name, fn):
    """A float function: integer and bool inputs computed in
    ``inexact(dtype)``."""
    def f(x, name=None):
        return fn(as_inexact(x))
    f.__name__ = f.__qualname__ = name
    return defop(f, tensor_method=name)


@defop(tensor_method="abs")
def abs(x, name=None):  # noqa: A001
    return x if x.dtype == torch.bool else torch.abs(x)


@defop(tensor_method="neg")
def neg(x, name=None):
    return torch.neg(x)


exp = _unary("exp", torch.exp)
expm1 = _unary("expm1", torch.expm1)
log = _unary("log", torch.log)
log2 = _unary("log2", torch.log2)
log10 = _unary("log10", torch.log10)
log1p = _unary("log1p", torch.log1p)
sqrt = _unary("sqrt", torch.sqrt)
rsqrt = _unary("rsqrt", torch.rsqrt)
sin = _unary("sin", torch.sin)
cos = _unary("cos", torch.cos)
tan = _unary("tan", torch.tan)
asin = _unary("asin", torch.asin)
acos = _unary("acos", torch.acos)
atan = _unary("atan", torch.atan)
sinh = _unary("sinh", torch.sinh)
cosh = _unary("cosh", torch.cosh)
tanh = _unary("tanh", torch.tanh)
asinh = _unary("asinh", torch.asinh)
acosh = _unary("acosh", torch.acosh)
atanh = _unary("atanh", torch.atanh)
reciprocal = _unary("reciprocal", torch.reciprocal)
erf = _unary("erf", torch.erf)
erfinv = _unary("erfinv", torch.erfinv)
lgamma = _unary("lgamma", torch.lgamma)
digamma = _unary("digamma", torch.digamma)
deg2rad = _unary("deg2rad", torch.deg2rad)
rad2deg = _unary("rad2deg", torch.rad2deg)
angle = _unary("angle", torch.angle)


@defop(tensor_method="square")
def square(x, name=None):
    return torch.square(x)


def _rounding(name, fn):
    """Rounding keeps integer inputs as they are, as jax.numpy does."""
    def f(x, name=None):
        return fn(x) if x.is_floating_point() else x
    f.__name__ = f.__qualname__ = name
    return defop(f, tensor_method=name)


floor = _rounding("floor", torch.floor)
ceil = _rounding("ceil", torch.ceil)
round = _rounding("round", torch.round)  # noqa: A001
trunc = _rounding("trunc", torch.trunc)


@defop(tensor_method="frac")
def frac(x, name=None):
    return x - torch.trunc(x)


@defop(tensor_method="sign")
def sign(x, name=None):
    return torch.sgn(x)


@defop(tensor_method="sgn")
def sgn(x, name=None):
    return torch.sgn(x)


@defop(tensor_method="conj")
def conj(x, name=None):
    return torch.conj_physical(x)


@defop(tensor_method="real")
def real(x, name=None):
    return torch.real(x)


@defop(tensor_method="imag")
def imag(x, name=None):
    if x.is_complex():
        return torch.imag(x)
    # zeros that keep x's graph (a zero grad), as jnp.imag of a real array
    return (x * 0).nan_to_num(nan=0.0)


@defop(tensor_method="isnan")
def isnan(x, name=None):
    return torch.isnan(x)


@defop(tensor_method="isinf")
def isinf(x, name=None):
    return torch.isinf(x)


@defop(tensor_method="isfinite")
def isfinite(x, name=None):
    return torch.isfinite(x)


@defop(tensor_method="nan_to_num")
def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


@defop(tensor_method="stanh")
def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    x = as_inexact(x.to(result_type(x, scale_a, scale_b)))
    return scale_b * torch.tanh(scale_a * x)


# --- scaling / clipping / fused-ish -------------------------------------------

@defop(tensor_method="scale")
def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    x = x.to(result_type(x, scale, bias))
    out = x * scale + bias if bias_after_scale else (x + bias) * scale
    if act == "relu":
        out = torch.clamp(out, min=0)
    elif act == "tanh":
        out = torch.tanh(out)
    return out


@defop(tensor_method="clip")
def clip(x, min=None, max=None, name=None):  # noqa: A002
    x = x.to(result_type(x, *(v for v in (min, max) if v is not None)))
    return torch.clamp(x, min, max)


@defop(tensor_method="increment")
def increment(x, value=1.0, name=None):
    x, value = operands(x, value)
    return x + value


def _add_n(*xs):
    return functools.reduce(lambda a, b: torch.add(*operands(a, b)), xs)


def add_n(inputs, name=None):
    if isinstance(inputs, Tensor):
        return inputs
    return apply_op(_add_n, "add_n", tuple(inputs), {})


@defop(tensor_method="multiplex")
def multiplex(inputs, index, name=None):
    stacked = torch.stack(list(inputs), dim=0)
    idx = index.reshape(-1)
    return stacked[idx, torch.arange(stacked.shape[1], device=idx.device)]


# --- cumulative ---------------------------------------------------------------

def _scan_dtype(x, dtype):
    """jax.numpy's accumulator: integers keep their dtype, bool is int64."""
    if dtype is not None:
        from ..core.dtype import convert_dtype
        return convert_dtype(dtype)
    return torch.int64 if x.dtype == torch.bool else x.dtype


@defop(tensor_method="cumsum")
def cumsum(x, axis=None, dtype=None, name=None):
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.cumsum(x, dim=int(axis), dtype=_scan_dtype(x, dtype))


@defop(tensor_method="cumprod")
def cumprod(x, dim=None, dtype=None, name=None):
    if dim is None:
        x, dim = x.reshape(-1), 0
    return torch.cumprod(x, dim=int(dim), dtype=_scan_dtype(x, dtype))


def _cum_extreme(fn, x, axis, dtype):
    if axis is None:
        x, axis = x.reshape(-1), 0
    vals, idx = fn(x, dim=int(axis))
    from ..core.dtype import convert_dtype
    return vals, idx.to(convert_dtype(dtype) if dtype else torch.int64)


@defop(tensor_method="cummax")
def cummax(x, axis=None, dtype="int64", name=None):
    return _cum_extreme(torch.cummax, x, axis, dtype)


@defop(tensor_method="cummin")
def cummin(x, axis=None, dtype="int64", name=None):
    return _cum_extreme(torch.cummin, x, axis, dtype)


@defop
def logcumsumexp(x, axis=None, dtype=None, name=None):
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.logcumsumexp(as_inexact(x), dim=int(axis))


@defop(tensor_method="trace")
def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(x, offset, axis1, axis2).sum(-1)


# --- in-place variants --------------------------------------------------------

def _make_inplace(op, method_name):
    """The in-place form of ``op``: ``_value`` rebinds to the op's result
    (never written in place), the graph carried on it."""
    def inplace(self, *args, **kwargs):
        return self._rebind(op(self, *args, **kwargs)._value)
    inplace.__name__ = method_name
    setattr(Tensor, method_name, inplace)
    return inplace


add_ = _make_inplace(add, "add_")
subtract_ = _make_inplace(subtract, "subtract_")
multiply_ = _make_inplace(multiply, "multiply_")
scale_ = _make_inplace(scale, "scale_")
clip_ = _make_inplace(clip, "clip_")
exp_ = _make_inplace(exp, "exp_")
sqrt_ = _make_inplace(sqrt, "sqrt_")
rsqrt_ = _make_inplace(rsqrt, "rsqrt_")
floor_ = _make_inplace(floor, "floor_")
ceil_ = _make_inplace(ceil, "ceil_")
round_ = _make_inplace(round, "round_")
reciprocal_ = _make_inplace(reciprocal, "reciprocal_")
tanh_ = _make_inplace(tanh, "tanh_")
remainder_ = _make_inplace(remainder, "remainder_")


@register_tensor_method("zero_")
def zero_(self):
    return self._rebind(torch.zeros_like(self._value))


@register_tensor_method("fill_")
def fill_(self, value):
    value = value._value if isinstance(value, Tensor) else value
    with torch.no_grad():
        new = torch.empty_like(self._value).copy_(torch.as_tensor(value))
    return self._rebind(new)


# --- operator overloads -------------------------------------------------------

def _as_operand(self, other):
    if isinstance(other, (list, tuple, np.ndarray)):
        return Tensor._wrap(torch.as_tensor(np.asarray(other),
                                            device=self._value.device))
    return other


def _binop(op):
    def method(self, other):
        return op(self, _as_operand(self, other))
    return method


def _rbinop(op):
    def method(self, other):
        return op(_as_operand(self, other), self)
    return method


Tensor.__add__ = _binop(add)
Tensor.__radd__ = _rbinop(add)
Tensor.__sub__ = _binop(subtract)
Tensor.__rsub__ = _rbinop(subtract)
Tensor.__mul__ = _binop(multiply)
Tensor.__rmul__ = _rbinop(multiply)
Tensor.__truediv__ = _binop(divide)
Tensor.__rtruediv__ = _rbinop(divide)
Tensor.__floordiv__ = _binop(floor_divide)
Tensor.__rfloordiv__ = _rbinop(floor_divide)
Tensor.__mod__ = _binop(remainder)
Tensor.__rmod__ = _rbinop(remainder)
Tensor.__pow__ = _binop(pow)
Tensor.__rpow__ = _rbinop(pow)


def _matmul_op(self, other):
    from .linalg import matmul as _mm
    return _mm(self, _as_operand(self, other))


def _rmatmul_op(self, other):
    from .linalg import matmul as _mm
    return _mm(_as_operand(self, other), self)


Tensor.__matmul__ = _matmul_op
Tensor.__rmatmul__ = _rmatmul_op
Tensor.__neg__ = lambda self: neg(self)
Tensor.__abs__ = lambda self: abs(self)
Tensor.__pos__ = lambda self: self
