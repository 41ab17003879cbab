"""Convolution functionals (``paddle_tpu.nn.functional.conv``
counterparts): ``conv1d`` / ``conv2d`` / ``conv3d``, the three
transposed convs and the ``pointwise_as_dot`` toggle.

The JAX package runs its convolutions through ``lax.conv_general_dilated``
(XLA's own kernels, outside any Pallas kernel); the port runs them through
``torch.nn.functional.conv{1,2,3}d`` / ``conv_transpose{1,2,3}d`` (cuDNN
on the card).  The padding forms are
the reference's (``_norm_padding``): an int, one int per spatial dim, a
``[lo, hi]`` pair per dim (flat or nested, with or without the batch and
channel dims) or ``"SAME"`` / ``"VALID"``.  Symmetric pads go to
the convolution's own ``padding``; others are padded with zeros first.  Weights
are paddle's ``[out_c, in_c / groups, *k]`` (transposed: ``[in_c, out_c /
groups, *k]``); ``data_format`` is channel-first or channel-last
(``"NCL"`` / ``"NLC"``, ``"NCHW"`` / ``"NHWC"``, ``"NCDHW"`` /
``"NDHWC"``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as tF

from ...core.op import defop

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose", "pointwise_as_dot"]


def _tuplize(v, n):
    """An int (or None) or a sequence as an n-tuple; one entry repeats."""
    if isinstance(v, int) or v is None:
        return (v,) * n
    v = tuple(None if x is None else int(x) for x in v)
    return v * n if len(v) == 1 else v


def _norm_padding(padding, n):
    """paddle padding spec -> ``[(lo, hi)] * n``, or the string codes."""
    if isinstance(padding, str):
        return padding.upper()  # SAME / VALID
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if len(padding) == n and all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    if len(padding) == 2 * n:
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(n)]
    if all(isinstance(p, (list, tuple)) for p in padding):
        # may include batch/channel dims ([[0,0],[0,0],[lo,hi],...])
        if len(padding) == n + 2:
            padding = padding[2:]
        return [tuple(p) for p in padding]
    raise ValueError(f"bad padding spec {padding}")


def _explicit_pads(pad, sizes, kernel, stride, dilation):
    """``[(lo, hi)]`` per spatial dim; ``"SAME"`` and ``"VALID"`` resolved
    as ``lax.padtype_to_pads`` does (over the dilated kernel).  Anything
    but integer pairs raises ``ValueError``, as ``lax.conv_general_dilated``
    does (a nested spec with the batch and channel pairs has 2 n entries
    for n = 2, so ``_norm_padding`` reads it as flat pairs of pairs)."""
    if not isinstance(pad, str):
        if not all(len(p) == 2 and all(isinstance(v, int) for v in p)
                   for p in pad):
            raise ValueError(f"padding should be a string or a sequence of "
                             f"(low, high) pairs, got {pad}")
        return [tuple(p) for p in pad]
    if pad == "VALID":
        return [(0, 0)] * len(sizes)
    if pad != "SAME":
        raise ValueError(f"unknown padding {pad!r}")
    out = []
    for size, k, s, d in zip(sizes, kernel, stride, dilation):
        total = max(0, (-(-size // s) - 1) * s + (k - 1) * d + 1 - size)
        out.append((total // 2, total - total // 2))
    return out


_POINTWISE_AS_DOT = False


def pointwise_as_dot(flag: bool):
    """Toggle the 1x1-conv -> product lowering (process-wide, off by
    default, as in the reference).  It computes the same function."""
    global _POINTWISE_AS_DOT
    _POINTWISE_AS_DOT = bool(flag)


def _pointwise_conv(x, weight, stride, pad, groups, channel_last):
    """A 1x1 conv as a product over the channels when it is one (kernel 1,
    pad 0, groups 1); strides subsample the input first."""
    if not _POINTWISE_AS_DOT:
        return None
    if groups != 1 or isinstance(pad, str) or any(p != (0, 0) for p in pad):
        return None
    if any(k != 1 for k in weight.shape[2:]):
        return None
    w2 = weight.reshape(weight.shape[0], weight.shape[1])  # [O, C]
    if any(s != 1 for s in stride):
        sl = [slice(None)] * x.dim()
        for i, s in enumerate(stride):
            sl[(1 if channel_last else 2) + i] = slice(None, None, s)
        x = x[tuple(sl)]
    cdim = x.dim() - 1 if channel_last else 1
    out = torch.tensordot(x, w2, dims=([cdim], [1]))
    return out if channel_last else out.movedim(-1, 1)


_FORMATS = {1: ("NCL", "NLC"), 2: ("NCHW", "NHWC"), 3: ("NCDHW", "NDHWC")}
_CONV = {1: tF.conv1d, 2: tF.conv2d, 3: tF.conv3d}
_CONV_T = {1: tF.conv_transpose1d, 2: tF.conv_transpose2d,
           3: tF.conv_transpose3d}


def _layout(x, data_format, n, what):
    """``(channel_last, x channel-first)``; other formats raise."""
    if data_format not in _FORMATS[n]:
        raise ValueError(f"{what} data_format must be one of "
                         f"{_FORMATS[n]}, got {data_format!r}")
    channel_last = data_format == _FORMATS[n][1]
    return channel_last, (x.movedim(-1, 1) if channel_last else x)


def _finish(out, bias, channel_last, n):
    if channel_last:
        out = out.movedim(1, -1)
    if bias is not None:
        out = out + (bias.reshape((1,) * (n + 1) + (-1,)) if channel_last
                     else bias.reshape((1, -1) + (1,) * n))
    return out


def _flat_pads(pads):
    """``[(lo, hi)]`` per spatial dim -> torch's ``F.pad`` list (last dim
    first)."""
    return [v for lo_hi in reversed(pads) for v in lo_hi]


def _conv_nd(x, weight, bias, stride, padding, dilation, groups, n,
             data_format, what):
    channel_last, xin = _layout(x, data_format, n, what)
    stride = _tuplize(stride, n)
    dilation = _tuplize(dilation, n)
    pad = _norm_padding(padding, n)
    out = _pointwise_conv(xin, weight, stride, pad, groups, False)
    if out is not None:
        return _finish(out, bias, channel_last, n)
    pads = _explicit_pads(pad, xin.shape[2:], weight.shape[2:], stride,
                          dilation)
    if all(lo == hi and lo >= 0 for lo, hi in pads):
        sym = tuple(lo for lo, _ in pads)
    else:
        xin = tF.pad(xin, _flat_pads(pads))
        sym = (0,) * n
    out = _CONV[n](xin, weight, None, stride, sym, dilation, groups)
    return _finish(out, bias, channel_last, n)


def _conv_transpose_nd(x, weight, bias, stride, padding, output_padding,
                       groups, dilation, n, data_format, what):
    """The JAX package's transposed conv (the gradient of a conv: the
    flipped kernel over the stride-dilated input, padded ``(k - 1) d -
    lo`` before and ``(k - 1) d - hi + output_padding`` after): torch's
    unpadded transposed conv, then that output cropped by ``lo`` before
    and by ``hi - output_padding`` after (a negative crop pads zeros).
    ``output_size`` is accepted and not read, as there."""
    channel_last, xin = _layout(x, data_format, n, what)
    stride = _tuplize(stride, n)
    dilation = _tuplize(dilation, n)
    opad = _tuplize(output_padding, n)
    k = weight.shape[2:]
    pad = _norm_padding(padding, n)
    if isinstance(pad, str):
        pad = [(0, 0)] * n if pad == "VALID" else \
            [((k[i] - 1) // 2,) * 2 for i in range(n)]
    out = _CONV_T[n](xin, weight, None, stride, 0, 0, groups, dilation)
    crop = [(-lo, -hi + op) for (lo, hi), op in zip(pad, opad)]
    if any(c != (0, 0) for c in crop):
        out = tF.pad(out, _flat_pads(crop))
    return _finish(out, bias, channel_last, n)


@defop
def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 1,
                    data_format, "conv1d")


@defop
def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 2,
                    data_format, "conv2d")


@defop
def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 3,
                    data_format, "conv3d")


@defop
def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, groups, dilation, 1,
                              data_format, "conv1d_transpose")


@defop
def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW", name=None):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, groups, dilation, 2,
                              data_format, "conv2d_transpose")


@defop
def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, groups, dilation, 3,
                              data_format, "conv3d_transpose")
