"""Value-wise sparse ops (``paddle_tpu.sparse``'s ``_valuewise`` family,
``cast``, ``scale``, ``pow``, ``leaky_relu``, ``divide_scalar``): each
applies to the stored values only and keeps the index structure, so
implicit zeros stay zero by construction (``sparse_ops.yaml``)."""
from __future__ import annotations

import torch

from ..core import dtype as dtype_mod
from ..core.tensor import Tensor
from .tensor import SparseCooTensor, as_coo

__all__ = ["abs", "sin", "sinh", "asin", "asinh", "tan", "tanh", "atan",
           "atanh", "acos", "acosh", "sqrt", "square", "log1p", "expm1",
           "relu", "relu6", "leaky_relu", "pow", "scale", "cast",
           "divide_scalar"]


def _valuewise(fn):
    def op(x, name=None):
        x = as_coo(x)
        return SparseCooTensor(x._idx, Tensor._wrap(fn(x._vt._value)),
                               x._shape)
    op.__name__ = getattr(fn, "__name__", "valuewise")
    return op


abs = _valuewise(torch.abs)          # noqa: A001
sin = _valuewise(torch.sin)
sinh = _valuewise(torch.sinh)
asin = _valuewise(torch.asin)
asinh = _valuewise(torch.asinh)
tan = _valuewise(torch.tan)
tanh = _valuewise(torch.tanh)
atan = _valuewise(torch.atan)
atanh = _valuewise(torch.atanh)
acos = _valuewise(torch.acos)
acosh = _valuewise(torch.acosh)
sqrt = _valuewise(torch.sqrt)
square = _valuewise(torch.square)
log1p = _valuewise(torch.log1p)
expm1 = _valuewise(torch.expm1)
relu = _valuewise(torch.relu)
relu6 = _valuewise(lambda v: v.clamp(0, 6))


def leaky_relu(x, negative_slope=0.01, name=None):
    return _valuewise(
        lambda v: torch.where(v > 0, v, negative_slope * v))(x)


def pow(x, factor, name=None):  # noqa: A001
    return _valuewise(lambda v: v ** factor)(x)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, name=None):
    """``v * scale + bias`` (or ``(v + bias) * scale``) on the stored
    values only."""
    return _valuewise(lambda v: v * scale + bias if bias_after_scale
                      else (v + bias) * scale)(x)


def divide_scalar(x, scalar, name=None):
    return _valuewise(lambda v: v / scalar)(x)


def cast(x, index_dtype=None, value_dtype=None, name=None):
    x = as_coo(x)
    idx = x._idx.to(dtype_mod.convert_dtype(index_dtype)) if index_dtype \
        else x._idx
    vals = x._vt.astype(value_dtype) if value_dtype else x._vt
    return SparseCooTensor(idx, vals, x._shape)
