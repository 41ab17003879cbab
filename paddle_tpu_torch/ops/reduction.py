"""Reduction ops (``paddle_tpu.ops.reduction`` counterpart; reference
python/paddle/tensor/math.py + stat.py reduce family).  Result dtypes
follow the JAX package: integer sums and products in int64 (unsigned
ones too: torch has no uint64 sum, the JAX package gives uint64), float
statistics of integers as ``core.dtype.inexact`` says, ``median`` the
mean of the two middle values."""
from __future__ import annotations

import torch

from ..core.dtype import as_inexact, convert_dtype, half_in_single
from ..core.op import defop

__all__ = ["sum", "mean", "max", "min", "amax", "amin", "prod", "logsumexp",
           "all", "any", "std", "var", "median", "nanmedian", "nansum",
           "nanmean", "count_nonzero", "quantile"]


def _axes(x, axis):
    """The reduced dims as a tuple (all of them for ``None``)."""
    if axis is None:
        return tuple(range(x.ndim))
    if isinstance(axis, torch.Tensor):
        return tuple(int(a) for a in axis.reshape(-1).tolist())
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return (int(axis),)


def _acc_dtype(x):
    return torch.int64 if not (x.is_floating_point() or x.is_complex()) \
        else None


@defop(tensor_method="sum")
def sum(x, axis=None, dtype=None, keepdim=False, name=None):  # noqa: A001
    out = torch.sum(x, dim=_axes(x, axis), keepdim=keepdim,
                    dtype=_acc_dtype(x))
    return out if dtype is None else out.to(convert_dtype(dtype))


@defop(tensor_method="mean")
def mean(x, axis=None, keepdim=False, name=None):
    return torch.mean(as_inexact(x), dim=_axes(x, axis), keepdim=keepdim)


@defop(tensor_method="max")
def max(x, axis=None, keepdim=False, name=None):  # noqa: A001
    return torch.amax(x, dim=_axes(x, axis), keepdim=keepdim)


@defop(tensor_method="min")
def min(x, axis=None, keepdim=False, name=None):  # noqa: A001
    return torch.amin(x, dim=_axes(x, axis), keepdim=keepdim)


@defop(tensor_method="amax")
def amax(x, axis=None, keepdim=False, name=None):
    return torch.amax(x, dim=_axes(x, axis), keepdim=keepdim)


@defop(tensor_method="amin")
def amin(x, axis=None, keepdim=False, name=None):
    return torch.amin(x, dim=_axes(x, axis), keepdim=keepdim)


@defop(tensor_method="prod")
def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    out = x if dtype is None else x.to(convert_dtype(dtype))
    acc = _acc_dtype(out)
    for a in sorted((a % x.ndim for a in _axes(x, axis)), reverse=True):
        out = torch.prod(out, dim=a, keepdim=keepdim, dtype=acc)
    return out if x.ndim or acc is None else out.to(acc)


@defop(tensor_method="logsumexp")
def logsumexp(x, axis=None, keepdim=False, name=None):
    return torch.logsumexp(as_inexact(x), dim=_axes(x, axis), keepdim=keepdim)


@defop(tensor_method="all")
def all(x, axis=None, keepdim=False, name=None):  # noqa: A001
    return torch.all(x, dim=_axes(x, axis), keepdim=keepdim)


@defop(tensor_method="any")
def any(x, axis=None, keepdim=False, name=None):  # noqa: A001
    return torch.any(x, dim=_axes(x, axis), keepdim=keepdim)


@defop(tensor_method="std")
def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return torch.std(as_inexact(x), dim=_axes(x, axis),
                     correction=1 if unbiased else 0, keepdim=keepdim)


@defop(tensor_method="var")
def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return torch.var(as_inexact(x), dim=_axes(x, axis),
                     correction=1 if unbiased else 0, keepdim=keepdim)


@half_in_single
def _quantile(fn, x, q, axis, keepdim):
    """``fn`` (torch.quantile / nanquantile, linear interpolation) over
    any set of axes: the reduced axes moved last and flattened."""
    x = as_inexact(x)
    axes = sorted(a % x.ndim for a in _axes(x, axis)) if x.ndim else []
    keep = [a for a in range(x.ndim) if a not in axes]
    flat = x.permute(*keep, *axes).reshape(*[x.shape[a] for a in keep], -1)
    qt = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    out = fn(flat, qt, dim=-1)
    if keepdim:
        lead = out.ndim - len(keep)
        out = out.reshape(*out.shape[:lead], *[
            1 if a in axes else x.shape[a] for a in range(x.ndim)])
    return out


@defop(tensor_method="median")
def median(x, axis=None, keepdim=False, name=None):
    return _quantile(torch.quantile, x, 0.5, axis, keepdim)


@defop(tensor_method="nanmedian")
def nanmedian(x, axis=None, keepdim=False, name=None):
    return _quantile(torch.nanquantile, x, 0.5, axis, keepdim)


@defop(tensor_method="nansum")
def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    return torch.nansum(x, dim=_axes(x, axis), keepdim=keepdim,
                        dtype=convert_dtype(dtype) if dtype
                        else _acc_dtype(x))


@defop(tensor_method="nanmean")
def nanmean(x, axis=None, keepdim=False, name=None):
    return torch.nanmean(as_inexact(x), dim=_axes(x, axis), keepdim=keepdim)


@defop(tensor_method="count_nonzero")
def count_nonzero(x, axis=None, keepdim=False, name=None):
    return torch.sum((x != 0).to(torch.int64), dim=_axes(x, axis),
                     keepdim=keepdim)


@defop(tensor_method="quantile")
def quantile(x, q, axis=None, keepdim=False, name=None):
    return _quantile(torch.quantile, x, q, axis, keepdim)
