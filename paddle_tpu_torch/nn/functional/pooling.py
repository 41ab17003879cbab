"""Pooling functionals (``paddle_tpu.nn.functional.pooling``
counterparts): max and average pools in 1, 2 and 3 dims and the adaptive
ones.

``max_pool{1,2,3}d`` give the reference's ``reduce_window`` max over
windows padded with -inf (``ceil_mode`` widens the high pad, as there).
Its gradient goes to the first maximum of each window in row-major order,
which is what the reference's ``select_and_scatter_add`` with ``ge``
selects, and what torch's max pools select.  Pads that torch's pools
cannot take themselves (uneven, or over half the window) are made with
-inf first.  ``return_mask=True`` also returns, for each output, the
index of its maximum in the flattened unpadded input volume (int64; a
pre-padded index is mapped back and clipped into the input, as the JAX
patch path clips it).

``avg_pool{1,2,3}d`` sum each window of the zero-padded input and divide
by the kernel's size, or with ``exclusive`` and any padding by the
number of input elements in the window (windows widened by ``ceil_mode``
included), as the reference's two ``reduce_window`` sums do;
``avg_pool2d``'s ``divisor_override`` rescales after (``avg_pool3d``
accepts it and does not read it, as there).

The adaptive pools split each spatial dim into bins ``[floor(b * size /
bins), ceil((b + 1) * size / bins))``, the reference's bins and torch's
adaptive pools'; ``None`` in ``output_size`` keeps that dim.  The adaptive
max pools accept ``return_mask`` and return the values only, as there.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as tF

from ...core.op import defop
from .conv import _explicit_pads, _flat_pads, _layout, _tuplize

__all__ = ["max_pool1d", "max_pool2d", "max_pool3d", "avg_pool1d",
           "avg_pool2d", "avg_pool3d", "adaptive_avg_pool1d",
           "adaptive_avg_pool2d", "adaptive_avg_pool3d",
           "adaptive_max_pool1d", "adaptive_max_pool2d",
           "adaptive_max_pool3d"]

_MAX = {1: tF.max_pool1d, 2: tF.max_pool2d, 3: tF.max_pool3d}
_AVG = {1: tF.avg_pool1d, 2: tF.avg_pool2d, 3: tF.avg_pool3d}
_ADAPTIVE_AVG = {1: tF.adaptive_avg_pool1d, 2: tF.adaptive_avg_pool2d,
                 3: tF.adaptive_avg_pool3d}
_ADAPTIVE_MAX = {1: tF.adaptive_max_pool1d, 2: tF.adaptive_max_pool2d,
                 3: tF.adaptive_max_pool3d}


def _pad_spec(padding, n):
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if len(padding) == n and all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    if len(padding) == 2 * n:
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(n)]
    return [tuple(p) for p in padding[-n:]]


def _window_pads(xin, kernel, stride, padding, ceil_mode, n):
    """``[(lo, hi)]`` per spatial dim, the high pads widened for
    ``ceil_mode`` (not for the string pads, as in the reference)."""
    spec = _pad_spec(padding, n)
    pads = _explicit_pads(spec, xin.shape[2:], kernel, stride, (1,) * n)
    if ceil_mode and not isinstance(spec, str):
        for i, size in enumerate(xin.shape[2:]):
            lo, hi = pads[i]
            k, s = kernel[i], stride[i]
            out_ceil = -(-(size + lo + hi - k) // s) + 1
            pads[i] = (lo, max(hi, (out_ceil - 1) * s + k - (size + lo)))
    return pads


def _back(t, channel_last):
    return t.movedim(1, -1) if channel_last else t


def _unpad_index(idx, padded, pads, sizes):
    """Flat indices into the padded volume -> into the unpadded one, each
    coordinate clipped into the input."""
    coords, rem = [], idx
    for size in reversed(padded):
        coords.append(rem % size)
        rem = rem // size
    flat = None
    for c, (lo, _), size in zip(reversed(coords), pads, sizes):
        c = (c - lo).clamp(0, size - 1)
        flat = c if flat is None else flat * size + c
    return flat


def _max_pool(x, kernel_size, stride, padding, return_mask, ceil_mode,
              data_format, n, what):
    kernel = _tuplize(kernel_size, n)
    stride = _tuplize(stride if stride is not None else kernel, n)
    channel_last, xin = _layout(x, data_format, n, what)
    pads = _window_pads(xin, kernel, stride, padding, ceil_mode, n)
    if all(lo == hi and 0 <= lo <= k // 2
           for (lo, hi), k in zip(pads, kernel)):
        res = _MAX[n](xin, kernel, stride, tuple(lo for lo, _ in pads),
                      return_indices=return_mask)
    else:
        xp = tF.pad(xin, _flat_pads(pads), value=float("-inf"))
        res = _MAX[n](xp, kernel, stride, return_indices=return_mask)
        if return_mask:
            res = (res[0], _unpad_index(res[1], xp.shape[2:], pads,
                                        xin.shape[2:]))
    if return_mask:
        return _back(res[0], channel_last), _back(res[1], channel_last)
    return _back(res, channel_last)


def _avg_pool(x, kernel_size, stride, padding, ceil_mode, exclusive,
              data_format, n, what):
    kernel = _tuplize(kernel_size, n)
    stride = _tuplize(stride if stride is not None else kernel, n)
    channel_last, xin = _layout(x, data_format, n, what)
    spec = _pad_spec(padding, n)
    pads = _window_pads(xin, kernel, stride, padding, ceil_mode, n)
    padded = any(p != (0, 0) for p in pads)
    flat = _flat_pads(pads)
    out = _AVG[n](tF.pad(xin, flat) if padded else xin, kernel, stride)
    if exclusive and (isinstance(spec, str) or padded):
        ones = torch.ones((1, 1) + tuple(xin.shape[2:]), dtype=out.dtype,
                          device=out.device)
        out = out / _AVG[n](tF.pad(ones, flat) if padded else ones, kernel,
                            stride)
    return _back(out, channel_last)


@defop
def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    return _max_pool(x, kernel_size, stride, padding, return_mask, ceil_mode,
                     data_format, 1, "max_pool1d")


@defop
def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    return _max_pool(x, kernel_size, stride, padding, return_mask, ceil_mode,
                     data_format, 2, "max_pool2d")


@defop
def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    return _max_pool(x, kernel_size, stride, padding, return_mask, ceil_mode,
                     data_format, 3, "max_pool3d")


@defop
def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    return _avg_pool(x, kernel_size, stride, padding, ceil_mode, exclusive,
                     data_format, 1, "avg_pool1d")


@defop
def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    out = _avg_pool(x, kernel_size, stride, padding, ceil_mode, exclusive,
                    data_format, 2, "avg_pool2d")
    if divisor_override:
        out = out * (float(math.prod(_tuplize(kernel_size, 2)))
                     / divisor_override)
    return out


@defop
def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _avg_pool(x, kernel_size, stride, padding, ceil_mode, exclusive,
                     data_format, 3, "avg_pool3d")


def _adaptive(x, output_size, data_format, n, table, what):
    channel_last, xin = _layout(x, data_format, n, what)
    size = tuple(s if o is None else o
                 for o, s in zip(_tuplize(output_size, n), xin.shape[2:]))
    return _back(table[n](xin, size if n > 1 else size[0]), channel_last)


@defop
def adaptive_avg_pool1d(x, output_size, data_format="NCL", name=None):
    return _adaptive(x, output_size, data_format, 1, _ADAPTIVE_AVG,
                     "adaptive_avg_pool1d")


@defop
def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive(x, output_size, data_format, 2, _ADAPTIVE_AVG,
                     "adaptive_avg_pool2d")


@defop
def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive(x, output_size, data_format, 3, _ADAPTIVE_AVG,
                     "adaptive_avg_pool3d")


@defop
def adaptive_max_pool1d(x, output_size, return_mask=False,
                        data_format="NCL", name=None):
    return _adaptive(x, output_size, data_format, 1, _ADAPTIVE_MAX,
                     "adaptive_max_pool1d")


@defop
def adaptive_max_pool2d(x, output_size, return_mask=False,
                        data_format="NCHW", name=None):
    return _adaptive(x, output_size, data_format, 2, _ADAPTIVE_MAX,
                     "adaptive_max_pool2d")


@defop
def adaptive_max_pool3d(x, output_size, return_mask=False,
                        data_format="NCDHW", name=None):
    return _adaptive(x, output_size, data_format, 3, _ADAPTIVE_MAX,
                     "adaptive_max_pool3d")
