"""Shape / layout manipulation ops (``paddle_tpu.ops.manipulation``
counterpart; reference python/paddle/tensor/manipulation.py).  Scatter
forms return new tensors (``index_put``, ``scatter``, ``index_add``
out of place), as the JAX package's ``.at[]`` updates do."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as tF

from ..core.dtype import operands
from ..core.op import apply_op, defop
from ..core.tensor import Tensor, _positive_steps

__all__ = ["reshape", "flatten", "transpose", "t", "moveaxis", "squeeze",
           "unsqueeze", "concat", "stack", "split", "chunk", "unbind", "tile",
           "expand", "expand_as", "broadcast_to", "broadcast_tensors",
           "broadcast_shape", "flip", "rot90", "roll", "gather",
           "index_select", "gather_nd", "scatter", "scatter_nd_add",
           "scatter_nd", "take_along_axis", "put_along_axis", "masked_select",
           "masked_fill", "index_sample", "index_add", "index_put",
           "repeat_interleave", "slice", "strided_slice", "crop", "unfold",
           "pad", "tensordot"]


def _ints(v):
    if isinstance(v, Tensor):
        v = v._value
    if isinstance(v, torch.Tensor):
        return tuple(int(x) for x in v.reshape(-1).tolist())
    if isinstance(v, (int, np.integer)):
        return (int(v),)
    return tuple(int(x) for x in v)


def _int(v):
    return int(v.item()) if isinstance(v, (Tensor, torch.Tensor)) else int(v)


@defop(tensor_method="reshape")
def reshape(x, shape, name=None):
    return torch.reshape(x, _ints(shape))


@defop(tensor_method="flatten")
def flatten(x, start_axis=0, stop_axis=-1, name=None):
    nd = x.ndim
    if nd == 0:
        return x.reshape(1)
    start, stop = start_axis % nd, stop_axis % nd
    return x.reshape(tuple(x.shape[:start]) + (-1,)
                     + tuple(x.shape[stop + 1:]))


@defop(tensor_method="transpose")
def transpose(x, perm=None, name=None):
    return x.permute(*(_ints(perm) if perm is not None
                       else range(x.ndim - 1, -1, -1)))


@defop(tensor_method="t")
def t(x, name=None):
    if x.ndim > 2:
        raise ValueError("paddle.t only supports ndim <= 2; use transpose")
    return x.t() if x.ndim == 2 else x


@defop(tensor_method="moveaxis")
def moveaxis(x, source, destination, name=None):
    return torch.movedim(x, _ints(source), _ints(destination))


@defop(tensor_method="squeeze")
def squeeze(x, axis=None, name=None):
    if axis is None:
        return torch.squeeze(x)
    axes = tuple(a % x.ndim for a in _ints(axis) if x.shape[a] == 1)
    return torch.squeeze(x, axes) if axes else x


@defop(tensor_method="unsqueeze")
def unsqueeze(x, axis, name=None):
    axes = _ints(axis)
    out_nd = x.ndim + len(axes)
    for a in sorted(a % out_nd for a in axes):
        x = x.unsqueeze(a)
    return x


def concat(x, axis=0, name=None):
    axis = _int(axis)
    return apply_op(lambda *xs: torch.cat(operands(*xs), dim=axis), "concat",
                    tuple(x), {})


def stack(x, axis=0, name=None):
    axis = _int(axis)
    return apply_op(lambda *xs: torch.stack(operands(*xs), dim=axis), "stack",
                    tuple(x), {})


def split(x, num_or_sections, axis=0, name=None):
    axis = _int(axis)
    v = x._value if isinstance(x, Tensor) else x
    dim = v.shape[axis]
    if isinstance(num_or_sections, int):
        sizes = [dim // num_or_sections] * num_or_sections
    else:
        sizes = list(_ints(num_or_sections))
        if any(s < 0 for s in sizes):
            known = sum(s for s in sizes if s >= 0)
            sizes = [s if s >= 0 else dim - known for s in sizes]
    offsets = np.cumsum([0] + sizes[:-1])

    def impl(v):
        return tuple(v.narrow(axis, int(o), int(s))
                     for o, s in zip(offsets, sizes))
    return list(apply_op(impl, "split", (x,), {}))


def chunk(x, chunks, axis=0, name=None):
    return split(x, int(chunks), axis)


def unbind(x, axis=0, name=None):
    return list(apply_op(lambda v: torch.unbind(v, _int(axis)), "unbind",
                         (x,), {}))


@defop(tensor_method="tile")
def tile(x, repeat_times, name=None):
    return torch.tile(x, _ints(repeat_times))


@defop(tensor_method="expand")
def expand(x, shape, name=None):
    target = list(_ints(shape))
    src = list(x.shape)
    # paddle allows -1 meaning "keep this dim" — but only for dims that exist
    # in the input, not for newly added leading dims
    offset = len(target) - len(src)
    for i, s in enumerate(target):
        if s == -1:
            if i < offset:
                raise ValueError(
                    f"expand: -1 at position {i} refers to a new leading "
                    f"dimension that does not exist in the input shape {src}")
            target[i] = src[i - offset]
    return torch.broadcast_to(x, tuple(target))


def expand_as(x, y, name=None):
    return expand(x, y.shape)


@defop(tensor_method="broadcast_to")
def broadcast_to(x, shape, name=None):
    return torch.broadcast_to(x, _ints(shape))


def broadcast_tensors(inputs, name=None):
    return list(apply_op(lambda *xs: tuple(torch.broadcast_tensors(*xs)),
                         "broadcast_tensors", tuple(inputs), {}))


def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


@defop(tensor_method="flip")
def flip(x, axis, name=None):
    return torch.flip(x, _ints(axis))


@defop(tensor_method="rot90")
def rot90(x, k=1, axes=(0, 1), name=None):
    return torch.rot90(x, int(k), tuple(axes))


@defop(tensor_method="roll")
def roll(x, shifts, axis=None, name=None):
    if axis is None:
        return torch.roll(x, _int(shifts) if not isinstance(
            shifts, (list, tuple)) else _ints(shifts))
    return torch.roll(x, _ints(shifts), _ints(axis))


@defop(tensor_method="gather")
def gather(x, index, axis=0, name=None):
    axis = _int(axis)
    if index.ndim == 0:
        return x.index_select(axis, index.reshape(1)).squeeze(axis)
    return x.index_select(axis, index.reshape(-1))


@defop(tensor_method="index_select")
def index_select(x, index, axis=0, name=None):
    return x.index_select(_int(axis), index.reshape(-1))


@defop(tensor_method="gather_nd")
def gather_nd(x, index, name=None):
    return x[tuple(index.movedim(-1, 0))]


def _like_x(x, v):
    """``v`` (a tensor or a Python scalar) as x's dtype and device."""
    return torch.as_tensor(v, dtype=x.dtype, device=x.device)


def _set(x, index, values):
    """``x.index_put(index, values)`` where a destination written more
    than once keeps its last writer and the others get no gradient, as the
    JAX package's ``.at[].set`` (torch leaves the winner unspecified)."""
    idx = torch.broadcast_tensors(*index)
    k, shape = len(idx), idx[0].shape
    flat = torch.zeros(shape, dtype=torch.int64, device=x.device)
    for i, t in enumerate(idx):
        flat = flat * x.shape[i] + t % x.shape[i]
    flat = flat.reshape(-1)
    uniq, inv = torch.unique(flat, return_inverse=True)
    last = torch.full(uniq.shape, -1, dtype=torch.int64,
                      device=x.device).scatter_reduce(
        0, inv, torch.arange(flat.numel(), device=x.device), "amax")
    vals = torch.broadcast_to(_like_x(x, values), (*shape, *x.shape[k:]))
    return x.index_put(tuple(t.reshape(-1)[last] for t in idx),
                       vals.reshape(-1, *x.shape[k:])[last])


@defop(tensor_method="scatter")
def scatter(x, index, updates, overwrite=True, name=None):
    idx = (index.reshape(-1),)
    updates = _like_x(x, updates)
    if overwrite:
        return _set(x, idx, updates)
    # paddle: non-overwrite first zeroes the destination rows then accumulates
    zeroed = x.index_put(idx, torch.zeros_like(updates))
    return zeroed.index_put(idx, updates, accumulate=True)


@defop(tensor_method="scatter_nd_add")
def scatter_nd_add(x, index, updates, name=None):
    return x.index_put(tuple(index.movedim(-1, 0)), _like_x(x, updates),
                       accumulate=True)


def scatter_nd(index, updates, shape, name=None):
    zero = apply_op(lambda u: torch.zeros(_ints(shape), dtype=u.dtype,
                                          device=u.device),
                    "zeros", (updates,), {})
    return scatter_nd_add(zero, index, updates)


@defop(tensor_method="take_along_axis")
def take_along_axis(x, indices, axis, name=None):
    return torch.take_along_dim(x, indices, dim=_int(axis))


@defop(tensor_method="put_along_axis")
def put_along_axis(x, indices, values, axis, reduce="assign", name=None):  # noqa: A002
    axis = _int(axis)
    values = torch.broadcast_to(_like_x(x, values), indices.shape)
    if reduce == "assign":
        grid = list(torch.meshgrid(*[torch.arange(s, device=x.device)
                                     for s in indices.shape], indexing="ij"))
        grid[axis % x.ndim] = indices
        return _set(x, tuple(grid), values)
    if reduce in ("add", "sum"):
        return x.scatter_add(axis, indices, values)
    if reduce in ("mul", "multiply"):
        return x.scatter_reduce(axis, indices, values, "prod")
    raise ValueError(f"unsupported reduce {reduce}")


@defop(tensor_method="masked_select")
def masked_select(x, mask, name=None):
    # dynamic-shape: eager only (like the reference's CPU/GPU kernel)
    return x[mask]


@defop(tensor_method="masked_fill")
def masked_fill(x, mask, value, name=None):
    return torch.where(mask, *operands(value, x))


@defop(tensor_method="index_sample")
def index_sample(x, index, name=None):
    return torch.take_along_dim(x, index, dim=1)


@defop(tensor_method="index_add")
def index_add(x, index, axis, value, name=None):
    return x.index_add(_int(axis) % x.ndim, index, _like_x(x, value))


@defop(tensor_method="index_put")
def index_put(x, indices, value, accumulate=False, name=None):
    if accumulate:
        return x.index_put(tuple(indices), _like_x(x, value),
                           accumulate=True)
    return _set(x, tuple(indices), value)


@defop(tensor_method="repeat_interleave")
def repeat_interleave(x, repeats, axis=None, name=None):
    return torch.repeat_interleave(x, repeats,
                                   dim=None if axis is None else _int(axis))


_py_slice = slice  # saved before the paddle-named `slice` op shadows the builtin


def slice(x, axes, starts, ends, name=None):  # noqa: A001
    axes, starts, ends = _ints(axes), _ints(starts), _ints(ends)

    def impl(v):
        idx = [_py_slice(None)] * v.ndim
        for a, s, e in zip(axes, starts, ends):
            dim = v.shape[a]
            s2 = s + dim if s < 0 else min(s, dim)
            e2 = e + dim if e < 0 else min(e, dim)
            idx[a] = _py_slice(s2, e2)
        return v[tuple(idx)]
    return apply_op(impl, "slice", (x,), {})


def strided_slice(x, axes, starts, ends, strides, name=None):
    axes, starts, ends, strides = (_ints(axes), _ints(starts), _ints(ends),
                                   _ints(strides))

    def impl(v):
        idx = [_py_slice(None)] * v.ndim
        for a, s, e, st in zip(axes, starts, ends, strides):
            idx[a] = _py_slice(s, e, st)
        v, idx, _ = _positive_steps(v, tuple(idx))
        return v[idx]
    return apply_op(impl, "strided_slice", (x,), {})


def crop(x, shape=None, offsets=None, name=None):
    shape = _ints(shape)
    offsets = _ints(offsets) if offsets is not None else (0,) * len(shape)

    def impl(v):
        return v[tuple(_py_slice(o, o + (s if s != -1 else v.shape[i] - o))
                       for i, (s, o) in enumerate(zip(shape, offsets)))]
    return apply_op(impl, "crop", (x,), {})


@defop(tensor_method="unfold")
def unfold(x, axis, size, step, name=None):
    axis = _int(axis) % x.ndim
    return x.unfold(axis, int(size), int(step)).movedim(-1, axis + 1)


@defop
def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):  # noqa: A002
    pad = _ints(pad)
    nd = x.ndim
    if len(pad) == 2 * nd:
        widths = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        # paddle F.pad convention: pad covers the last len(pad)//2 spatial dims
        # in innermost-first order ([W_lo, W_hi, H_lo, H_hi, ...])
        k = len(pad) // 2
        widths = [(0, 0)] * nd
        if data_format.endswith("C"):  # NHWC/NLC/NDHWC: spatial dims precede C
            spatial = list(range(1, 1 + k))
        else:
            spatial = list(range(nd - k, nd))
        for i, d in enumerate(reversed(spatial)):
            widths[d] = (pad[2 * i], pad[2 * i + 1])
    # torch's F.pad: (last_lo, last_hi, second_last_lo, ...), no trailing
    # untouched dims for the non-constant modes
    flat = [w for lo_hi in reversed(widths) for w in lo_hi]
    while flat and flat[-2:] == [0, 0]:
        flat = flat[:-2]
    if not flat:        # nothing to pad (an int pad covers no dim, as in JAX)
        return x
    tmode = {"constant": "constant", "reflect": "reflect",
             "replicate": "replicate", "circular": "circular"}[mode]
    if tmode == "constant":
        return tF.pad(x, flat, mode="constant", value=value)
    return tF.pad(x, flat, mode=tmode)


def tensordot(x, y, axes=2, name=None):
    return apply_op(lambda a, b: torch.tensordot(*operands(a, b), dims=axes),
                    "tensordot", (x, y), {})
