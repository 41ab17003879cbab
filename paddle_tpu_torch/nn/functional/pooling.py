"""Pooling functionals (``paddle_tpu.nn.functional.pooling``
counterparts): ``max_pool2d`` and ``adaptive_avg_pool2d``.

``max_pool2d`` gives the reference's ``reduce_window`` max over windows
padded with -inf (``ceil_mode`` widens the high pad, as there).  Its
gradient goes to the first maximum of each window in row-major order,
which is what the reference's ``select_and_scatter_add`` with ``ge``
selects, and what ``torch.nn.functional.max_pool2d`` selects.  Pads that
``max_pool2d`` cannot take itself (uneven, or over half the window) are
made with ``-inf`` first.  ``return_mask`` is not ported.

``adaptive_avg_pool2d`` splits each spatial dim into bins ``[floor(b *
size / bins), ceil((b + 1) * size / bins))``, the reference's bins and
``torch.nn.functional.adaptive_avg_pool2d``'s.
"""
from __future__ import annotations

import torch.nn.functional as tF

from .conv import _explicit_pads, _tuplize

__all__ = ["max_pool2d", "adaptive_avg_pool2d"]


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


def _channel_first(x, data_format):
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"data_format must be NCHW or NHWC, got "
                         f"{data_format!r}")
    return x.permute(0, 3, 1, 2) if data_format == "NHWC" else x


def _back(out, data_format):
    return out.permute(0, 2, 3, 1) if data_format == "NHWC" else out


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    if return_mask:
        raise NotImplementedError(
            "max_pool2d(return_mask=True) is not ported yet (ROADMAP module "
            "item 3)")
    kernel = _tuplize(kernel_size, 2)
    stride = _tuplize(stride if stride is not None else kernel, 2)
    xin = _channel_first(x, data_format)
    spec = _pad_spec(padding, 2)
    pads = _explicit_pads(spec, xin.shape[2:], kernel, stride, (1, 1))
    if ceil_mode and not isinstance(spec, str):
        for i, size in enumerate(xin.shape[2:]):
            lo, hi = pads[i]
            k, s = kernel[i], stride[i]
            out_ceil = -(-(size + lo + hi - k) // s) + 1
            pads[i] = (lo, max(hi, (out_ceil - 1) * s + k - (size + lo)))
    if all(lo == hi and 0 <= lo <= k // 2
           for (lo, hi), k in zip(pads, kernel)):
        out = tF.max_pool2d(xin, kernel, stride, tuple(lo for lo, _ in pads))
    else:
        (ht, hb), (wl, wr) = pads
        out = tF.max_pool2d(tF.pad(xin, (wl, wr, ht, hb),
                                   value=float("-inf")), kernel, stride)
    return _back(out, data_format)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    xin = _channel_first(x, data_format)
    size = tuple(s if o is None else o
                 for o, s in zip(_tuplize(output_size, 2), xin.shape[2:]))
    return _back(tF.adaptive_avg_pool2d(xin, size), data_format)
