"""Tensor creation ops (``paddle_tpu.ops.creation`` counterpart;
reference python/paddle/tensor/creation.py).  A tensor made from shapes
or host data lands on the current place (``set_device``): without a card
and with the default place, creation raises."""
from __future__ import annotations

import numpy as np
import torch

from ..core.dtype import convert_dtype, get_default_dtype, operands
from ..core.op import apply_op, defop
from ..core.place import current_device
from ..core.tensor import Tensor, to_tensor  # noqa: F401  (re-export)

__all__ = ["to_tensor", "zeros", "ones", "full", "empty", "zeros_like",
           "ones_like", "full_like", "empty_like", "arange", "linspace",
           "logspace", "eye", "tril", "triu", "diag", "diagflat", "diagonal",
           "meshgrid", "assign", "clone", "numel", "one_hot", "complex",
           "as_complex", "as_real"]


def _shape(shape):
    if isinstance(shape, Tensor):
        return tuple(int(s) for s in shape._value.reshape(-1).tolist())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s._value) if isinstance(s, Tensor) else int(s)
                 for s in shape)


def _dt(dtype):
    return get_default_dtype() if dtype is None else convert_dtype(dtype)


def _val(x):
    """A torch tensor for a Tensor, torch tensor or host data."""
    if isinstance(x, Tensor):
        return x._value
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), device=current_device())


def zeros(shape, dtype=None, name=None) -> Tensor:
    return Tensor._wrap(torch.zeros(_shape(shape), dtype=_dt(dtype),
                                    device=current_device()))


def ones(shape, dtype=None, name=None) -> Tensor:
    return Tensor._wrap(torch.ones(_shape(shape), dtype=_dt(dtype),
                                   device=current_device()))


def _fill_dtype(fill_value):
    """The JAX package's dtype for a fill value with no dtype given."""
    if isinstance(fill_value, bool):
        return torch.bool
    if isinstance(fill_value, int):
        return torch.int64
    if isinstance(fill_value, float):
        return get_default_dtype()
    if isinstance(fill_value, np.generic):
        return convert_dtype(fill_value.dtype)
    return None


def full(shape, fill_value, dtype=None, name=None) -> Tensor:
    if isinstance(fill_value, Tensor):
        # a device fill stays on the device: no .item() round-trip
        fv = fill_value._value
        if dtype is None:
            dtype = (get_default_dtype() if fv.is_floating_point()
                     else (torch.bool if fv.dtype == torch.bool
                           else torch.int64))
        return Tensor._wrap(fv.reshape(()).to(_dt(dtype)).expand(
            _shape(shape)).clone())
    dt = _dt(dtype) if dtype is not None else _fill_dtype(fill_value)
    return Tensor._wrap(torch.full(_shape(shape), fill_value, dtype=dt,
                                   device=current_device()))


def empty(shape, dtype=None, name=None) -> Tensor:
    return zeros(shape, dtype)


def _like(fn, x, dtype, *args):
    v = _val(x)
    return Tensor._wrap(fn(v, *args, dtype=convert_dtype(dtype)
                           if dtype else v.dtype))


def zeros_like(x, dtype=None, name=None) -> Tensor:
    return _like(torch.zeros_like, x, dtype)


def ones_like(x, dtype=None, name=None) -> Tensor:
    return _like(torch.ones_like, x, dtype)


def full_like(x, fill_value, dtype=None, name=None) -> Tensor:
    return _like(torch.full_like, x, dtype, fill_value)


def empty_like(x, dtype=None, name=None) -> Tensor:
    return zeros_like(x, dtype)


def _host(v):
    return v.item() if isinstance(v, Tensor) else v


def arange(start=0, end=None, step=1, dtype=None, name=None) -> Tensor:
    start, end, step = _host(start), _host(end), _host(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        dtype = ("int64" if all(isinstance(v, (int, np.integer))
                                for v in (start, end, step))
                 else get_default_dtype())
    return Tensor._wrap(torch.arange(start, end, step, dtype=_dt(dtype),
                                     device=current_device()))


def linspace(start, stop, num, dtype=None, name=None) -> Tensor:
    return Tensor._wrap(torch.linspace(
        _host(start), _host(stop), int(num), dtype=_dt(dtype),
        device=current_device()))


def logspace(start, stop, num, base=10.0, dtype=None, name=None) -> Tensor:
    return Tensor._wrap(torch.logspace(
        _host(start), _host(stop), int(num), base=base, dtype=_dt(dtype),
        device=current_device()))


def eye(num_rows, num_columns=None, dtype=None, name=None) -> Tensor:
    n = int(num_rows)
    m = int(num_columns) if num_columns is not None else n
    return Tensor._wrap(torch.eye(n, m, dtype=_dt(dtype),
                                  device=current_device()))


@defop(tensor_method="tril")
def tril(x, diagonal=0, name=None):
    return torch.tril(x, int(diagonal))


@defop(tensor_method="triu")
def triu(x, diagonal=0, name=None):
    return torch.triu(x, int(diagonal))


@defop
def diag(x, offset=0, padding_value=0, name=None):
    if x.ndim == 1 and padding_value != 0:
        d = torch.diag(x, int(offset))
        mask = torch.diag(torch.ones_like(x, dtype=torch.bool), int(offset))
        return torch.where(mask, *operands(d, padding_value))
    return torch.diag(x, int(offset))


@defop
def diagflat(x, offset=0, name=None):
    return torch.diagflat(x, int(offset))


@defop(tensor_method="diagonal")
def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(x, int(offset), int(axis1), int(axis2))


def meshgrid(*args, name=None):
    args = args[0] if len(args) == 1 and isinstance(args[0], (list, tuple)) \
        else args
    return list(apply_op(lambda *xs: tuple(torch.meshgrid(*xs, indexing="ij")),
                         "meshgrid", tuple(args), {}))


def assign(x, output=None) -> Tensor:
    src = _val(x).detach()
    if output is None:
        return Tensor._wrap(src)
    return output._rebind(src.to(output._value.dtype))


def clone(x, name=None) -> Tensor:
    return x.clone()


def numel(x, name=None) -> Tensor:
    return Tensor._wrap(torch.tensor(x._value.numel(), dtype=torch.int64,
                                     device=x._value.device))


def one_hot(x, num_classes, name=None) -> Tensor:
    return apply_op(lambda v: torch.nn.functional.one_hot(
        v.long(), int(num_classes)).to(get_default_dtype()),
        "one_hot", (x,), {})


def complex(real, imag, name=None) -> Tensor:  # noqa: A001
    return apply_op(lambda r, i: torch.complex(*operands(r, i)), "complex",
                    (real, imag), {})


def as_complex(x, name=None) -> Tensor:
    return apply_op(lambda v: torch.complex(v[..., 0], v[..., 1]),
                    "as_complex", (x,), {})


def as_real(x, name=None) -> Tensor:
    return apply_op(lambda v: torch.stack([v.real, v.imag], dim=-1),
                    "as_real", (x,), {})
