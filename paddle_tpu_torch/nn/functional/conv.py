"""Convolution functionals (``paddle_tpu.nn.functional.conv``
counterparts): ``conv2d`` and the ``pointwise_as_dot`` toggle.

The JAX package runs its convolutions through ``lax.conv_general_dilated``
(XLA's own kernels, outside any Pallas kernel); the port runs them through
``torch.nn.functional.conv2d`` (cuDNN on the card).  The padding forms are
the reference's (``_norm_padding``): an int, one int per spatial dim, a
``[lo, hi]`` pair per dim (flat or nested, with or without the batch and
channel dims) or ``"SAME"`` / ``"VALID"``.  Symmetric pads go to
``conv2d``'s own ``padding``; others are padded with zeros first.  Weights
are paddle's ``[out_c, in_c / groups, kh, kw]``; ``data_format`` is
``"NCHW"`` or ``"NHWC"``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as tF

from ...core.op import defop

__all__ = ["conv2d", "pointwise_as_dot"]


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


@defop
def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"conv2d data_format must be NCHW or NHWC, got "
                         f"{data_format!r}")
    channel_last = data_format == "NHWC"
    stride = _tuplize(stride, 2)
    dilation = _tuplize(dilation, 2)
    pad = _norm_padding(padding, 2)
    out = _pointwise_conv(x, weight, stride, pad, groups, channel_last)
    if out is None:
        xin = x.permute(0, 3, 1, 2) if channel_last else x
        pads = _explicit_pads(pad, xin.shape[2:], weight.shape[2:], stride,
                              dilation)
        if all(lo == hi and lo >= 0 for lo, hi in pads):
            sym = tuple(lo for lo, _ in pads)
        else:
            (ht, hb), (wl, wr) = pads
            xin = tF.pad(xin, (wl, wr, ht, hb))
            sym = (0, 0)
        out = tF.conv2d(xin, weight, None, stride, sym, dilation, groups)
        if channel_last:
            out = out.permute(0, 2, 3, 1)
    if bias is not None:
        out = out + (bias.reshape(1, 1, 1, -1) if channel_last
                     else bias.reshape(1, -1, 1, 1))
    return out
