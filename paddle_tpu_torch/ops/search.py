"""Search / sort ops (``paddle_tpu.ops.search`` counterpart; reference
python/paddle/tensor/search.py).  Sorts are stable, as jax.numpy's."""
from __future__ import annotations

import torch

from ..core.dtype import convert_dtype
from ..core.op import defop

__all__ = ["argmax", "argmin", "argsort", "sort", "topk", "kthvalue", "mode",
           "nonzero", "searchsorted", "unique", "unique_consecutive"]


def _arg(fn, x, axis, keepdim, dtype):
    if axis is None:
        out = fn(x.reshape(-1))
        if keepdim:
            out = out.reshape([1] * x.ndim)
    else:
        out = fn(x, dim=int(axis), keepdim=keepdim)
    return out.to(convert_dtype(dtype))


@defop(tensor_method="argmax")
def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmax, x, axis, keepdim, dtype)


@defop(tensor_method="argmin")
def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmin, x, axis, keepdim, dtype)


@defop(tensor_method="argsort")
def argsort(x, axis=-1, descending=False, name=None):
    return torch.argsort(x, dim=int(axis), descending=descending, stable=True)


@defop(tensor_method="sort")
def sort(x, axis=-1, descending=False, name=None):
    out = torch.sort(x, dim=int(axis), stable=True).values
    return torch.flip(out, (int(axis),)) if descending else out


@defop(tensor_method="topk")
def topk(x, k, axis=None, largest=True, sorted=True, name=None):  # noqa: A002
    if isinstance(k, torch.Tensor):
        k = int(k.item())
    axis = -1 if axis is None else int(axis)
    vals, idx = torch.topk(x, int(k), dim=axis, largest=largest, sorted=True)
    return vals, idx


@defop(tensor_method="kthvalue")
def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    axis = int(axis) % x.ndim
    vals, idx = torch.sort(x, dim=axis, stable=True)
    take = vals.select(axis, int(k) - 1)
    take_i = idx.select(axis, int(k) - 1)
    if keepdim:
        take, take_i = take.unsqueeze(axis), take_i.unsqueeze(axis)
    return take, take_i


@defop(tensor_method="mode")
def mode(x, axis=-1, keepdim=False, name=None):
    axis = int(axis) % x.ndim
    xm = x.movedim(axis, -1)
    # O(n^2) one-vs-all count; fine for the sizes this op sees
    counts = (xm[..., :, None] == xm[..., None, :]).sum(-1)
    # break count ties toward the larger value, like the reference kernel
    best = counts == counts.amax(-1, keepdim=True)
    floor = xm.amin(-1, keepdim=True).expand_as(xm)
    vals = torch.where(best, xm, floor).amax(-1, keepdim=True)
    idx = torch.argmax((xm == vals).to(torch.int8), dim=-1, keepdim=True)
    vals, idx = vals.movedim(-1, axis), idx.movedim(-1, axis)
    if not keepdim:
        vals, idx = vals.squeeze(axis), idx.squeeze(axis)
    return vals, idx


@defop(tensor_method="nonzero")
def nonzero(x, as_tuple=False, name=None):
    # dynamic output shape — eager only, like masked_select
    idx = torch.nonzero(x)
    if as_tuple:
        return tuple(idx[:, i:i + 1] for i in range(idx.shape[1]))
    return idx


@defop(tensor_method="searchsorted")
def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    return torch.searchsorted(sorted_sequence, values, right=right,
                              out_int32=out_int32)


@defop(tensor_method="unique")
def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    # dynamic output shape — eager only
    if axis is None:
        x = x.reshape(-1)
    out, inverse, counts = torch.unique(x, sorted=True, return_inverse=True,
                                        return_counts=True, dim=axis)
    res = [out]
    if return_index:
        n = x.shape[0 if axis is None else int(axis)]
        first = torch.full((out.shape[0 if axis is None else int(axis)],), n,
                           dtype=torch.int64, device=x.device)
        res.append(first.scatter_reduce(0, inverse, torch.arange(
            n, device=x.device), "amin"))
    if return_inverse:
        res.append(inverse)
    if return_counts:
        res.append(counts)
    return res[0] if len(res) == 1 else tuple(res)


@defop(tensor_method="unique_consecutive")
def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    res = torch.unique_consecutive(x, return_inverse=return_inverse,
                                   return_counts=return_counts, dim=axis)
    return res
