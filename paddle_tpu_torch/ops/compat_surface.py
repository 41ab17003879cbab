"""The top-level long tail (``paddle_tpu.ops.compat_surface``
counterpart): ``gcd`` / ``lcm`` / ``heaviside`` / ``diff`` /
``bucketize`` / ``take`` / ``nanquantile`` (registered ops), ``vsplit``,
``rank``, ``shape``, the ``is_*`` dtype predicates, the legacy aliases
(``cast``, ``mm``, ``mod``, ``floor_mod``, ``reverse``, ``tolist``), the
in-place forms ``squeeze_`` ... ``index_add_`` (they rebind the Tensor's
``_value``, as every surface in-place form does), ``set_printoptions``
and ``create_parameter``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import dtype as dtype_mod
from ..core.op import defop
from ..core.tensor import Tensor

__all__ = ["gcd", "lcm", "heaviside", "diff", "bucketize", "take",
           "nanquantile", "vsplit", "rank", "shape", "is_complex",
           "is_floating_point", "is_integer", "cast", "mm", "mod",
           "floor_mod", "reverse", "tolist", "squeeze_", "unsqueeze_",
           "reshape_", "scatter_", "index_add_", "set_printoptions",
           "create_parameter"]


@defop
def gcd(x, y, name=None):
    return torch.gcd(x, y)


@defop
def lcm(x, y, name=None):
    return torch.lcm(x, y)


@defop
def heaviside(x, y, name=None):
    """0 where x < 0, 1 where x > 0, y elsewhere (x gets a zero gradient,
    as through the JAX package's selects)."""
    s = torch.sign(x)
    return torch.where(x < 0, s * 0, torch.where(x > 0, s * 0 + 1, y))


def _edge(v, x, axis):
    """A ``prepend`` / ``append`` value as a tensor ``torch.diff`` takes:
    x's dtype and device, size 1 along ``axis`` for a scalar."""
    v = torch.as_tensor(v, dtype=x.dtype, device=x.device)
    if v.ndim == 0:
        shape = list(x.shape)
        shape[axis] = 1
        v = v.expand(shape)
    return v


@defop
def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    return torch.diff(
        x, n=n, dim=axis,
        prepend=None if prepend is None else _edge(prepend, x, axis),
        append=None if append is None else _edge(append, x, axis))


@defop
def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    """The bucket of each x over a sorted 1-D boundary sequence."""
    return torch.searchsorted(sorted_sequence, x, out_int32=out_int32,
                              right=right)


@defop
def take(x, index, mode="raise", name=None):
    """Flat-index gather (x read as 1-D).  ``"wrap"`` wraps, ``"clip"``
    clamps; ``"raise"`` cannot raise on device values: negative indices
    count from the end, the rest clamp."""
    flat = x.reshape(-1)
    idx = index.long()
    n = flat.shape[0]
    if mode == "wrap":
        idx = ((idx % n) + n) % n
    elif mode == "clip":
        idx = idx.clamp(0, n - 1)
    else:
        idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    return flat[idx]


@defop
def nanquantile(x, q, axis=None, keepdim=False, name=None):
    x = x if x.dtype == torch.float64 else x.float()
    q = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    return torch.nanquantile(x, q, dim=axis, keepdim=keepdim)


def vsplit(x, num_or_indices, name=None):
    """Split along dim 0.  An int divides evenly; a list holds split
    indices (``tensor_split``'s meaning, not section sizes)."""
    from .manipulation import split
    ndim = x.ndim
    if ndim < 2:
        raise ValueError(
            f"vsplit expects a tensor with at least 2 dims, got {ndim}")
    if isinstance(num_or_indices, int):
        return split(x, num_or_indices, axis=0)
    idx = list(num_or_indices)
    n = x.shape[0]
    bounds = [0] + [min(int(i) + n if int(i) < 0 else int(i), n)
                    for i in idx] + [n]
    sizes = [b - a for a, b in zip(bounds[:-1], bounds[1:])]
    if any(s < 0 for s in sizes):
        raise ValueError(f"split indices {idx} must be increasing")
    return split(x, sizes, axis=0)


def _torch(x):
    if isinstance(x, Tensor):
        return x._value
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


def rank(input, name=None):  # noqa: A002
    """A 0-D int32 Tensor: ``input``'s number of dims."""
    v = _torch(input)
    return Tensor._wrap(torch.tensor(v.ndim, dtype=torch.int32,
                                     device=v.device))


def shape(input, name=None):  # noqa: A002
    """A 1-D int32 Tensor: ``input``'s shape."""
    v = _torch(input)
    return Tensor._wrap(torch.tensor(list(v.shape), dtype=torch.int32,
                                     device=v.device))


def is_complex(x) -> bool:
    return _torch(x).is_complex()


def is_floating_point(x) -> bool:
    return _torch(x).is_floating_point()


def is_integer(x) -> bool:
    return _torch(x).dtype in dtype_mod._INTEGRAL


def cast(x, dtype):
    """The Tensor method ``cast`` as a function."""
    return (x if isinstance(x, Tensor) else Tensor(x)).cast(dtype)


def mm(input, mat2, name=None):  # noqa: A002
    from .linalg import matmul
    return matmul(input, mat2)


def mod(x, y, name=None):
    from .math import remainder
    return remainder(x, y)


floor_mod = mod


def reverse(x, axis, name=None):
    """The legacy name of ``flip``."""
    from .manipulation import flip
    return flip(x, axis)


def tolist(x):
    return x.tolist() if isinstance(x, (Tensor, torch.Tensor)) \
        else np.asarray(x).tolist()


# -- in-place forms: the Tensor rebinds to the op's result ------------------

def _inplace(x, new_value):
    return x._rebind(new_value._value if isinstance(new_value, Tensor)
                     else new_value)


def squeeze_(x, axis=None, name=None):
    from .manipulation import squeeze
    return _inplace(x, squeeze(x, axis))


def unsqueeze_(x, axis, name=None):
    from .manipulation import unsqueeze
    return _inplace(x, unsqueeze(x, axis))


def reshape_(x, shape, name=None):
    from .manipulation import reshape
    return _inplace(x, reshape(x, shape))


def scatter_(x, index, updates, overwrite=True, name=None):
    from .manipulation import scatter
    return _inplace(x, scatter(x, index, updates, overwrite))


def index_add_(x, index, axis, value, name=None):
    from .manipulation import index_add
    return _inplace(x, index_add(x, index, axis, value))


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """Tensor repr formatting: numpy's print options, which the repr
    uses."""
    kw = {}
    if precision is not None:
        kw["precision"] = precision
    if threshold is not None:
        kw["threshold"] = threshold
    if edgeitems is not None:
        kw["edgeitems"] = edgeitems
    if linewidth is not None:
        kw["linewidth"] = linewidth
    if sci_mode is not None:
        kw["suppress"] = not sci_mode
    np.set_printoptions(**kw)


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """A standalone Parameter, made by ``Layer.create_parameter`` (so
    ``ParamAttr`` and ``nn.abstract_init`` act as on a layer's)."""
    from ..nn.layer_base import Layer, ParamAttr

    if name is not None and attr is None:
        attr = ParamAttr(name=name)
    holder = Layer(dtype=dtype)
    return holder.create_parameter(tuple(shape), attr=attr, dtype=dtype,
                                   is_bias=is_bias,
                                   default_initializer=default_initializer)
