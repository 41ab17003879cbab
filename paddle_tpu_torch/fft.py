"""``paddle_tpu.fft`` counterpart: the paddle fft family over
``torch.fft``, on the input's device.

Every function takes ``norm`` as paddle names it (``"backward"``, the
default, ``"ortho"`` or ``"forward"``; None is ``"backward"``).  ``hfft2``
/ ``hfftn`` and ``ihfft2`` / ``ihfftn`` are the JAX package's
compositions, kept as they are: ``hfft`` over the last axis, then ``fft``
over the others (``s`` sets only the last axis' length), and ``ifft``
over the leading axes, then ``ihfft`` over the last.  ``ihfft`` takes a
real input, so ``ihfft2`` (and ``ihfftn`` over more than one axis) raises
on any input, in both packages.  ``fftfreq`` / ``rfftfreq`` are made on
the current place (the card unless ``set_device("cpu")``).  Surface
Tensors in give Tensors out; bare torch tensors give torch tensors.
"""
from __future__ import annotations

import torch

from .core import dtype as dtype_mod
from .core import place as place_mod
from .core.op import apply_op
from .core.tensor import Tensor
from .ops.compat_surface import is_complex  # noqa: F401

__all__ = ["fft", "ifft", "rfft", "irfft", "hfft", "ihfft", "fft2", "ifft2",
           "hfft2", "ihfft2", "hfftn", "ihfftn", "rfft2", "irfft2", "fftn",
           "ifftn", "rfftn", "irfftn", "fftfreq", "rfftfreq", "fftshift",
           "ifftshift"]


def _norm(norm):
    return "backward" if norm is None else norm


def _wrap1(tfn, op_name):
    def fn(x, n=None, axis=-1, norm="backward", name=None):
        return apply_op(lambda v: tfn(v, n=n, dim=axis, norm=_norm(norm)),
                        op_name, (x,), {})
    fn.__name__ = fn.__qualname__ = op_name
    return fn


def _wrap2(tfn, op_name):
    def fn(x, s=None, axes=(-2, -1), norm="backward", name=None):
        return apply_op(lambda v: tfn(v, s=s, dim=axes, norm=_norm(norm)),
                        op_name, (x,), {})
    fn.__name__ = fn.__qualname__ = op_name
    return fn


def _wrapn(tfn, op_name):
    def fn(x, s=None, axes=None, norm="backward", name=None):
        return apply_op(lambda v: tfn(v, s=s, dim=axes, norm=_norm(norm)),
                        op_name, (x,), {})
    fn.__name__ = fn.__qualname__ = op_name
    return fn


def _hfftn_impl(a, s=None, dim=None, norm="backward"):
    ax = tuple(range(a.dim())) if dim is None else tuple(dim)
    out = torch.fft.hfft(a, n=None if s is None else s[-1], dim=ax[-1],
                         norm=norm)
    for d in ax[:-1][::-1]:
        out = torch.fft.fft(out, dim=d, norm=norm)
    return out


def _ihfftn_impl(a, s=None, dim=None, norm="backward"):
    ax = tuple(range(a.dim())) if dim is None else tuple(dim)
    out = a
    for d in ax[:-1]:
        out = torch.fft.ifft(out, dim=d, norm=norm)
    return torch.fft.ihfft(out, n=None if s is None else s[-1],
                           dim=ax[-1], norm=norm)


fft = _wrap1(torch.fft.fft, "fft")
ifft = _wrap1(torch.fft.ifft, "ifft")
rfft = _wrap1(torch.fft.rfft, "rfft")
irfft = _wrap1(torch.fft.irfft, "irfft")
hfft = _wrap1(torch.fft.hfft, "hfft")
ihfft = _wrap1(torch.fft.ihfft, "ihfft")
fft2 = _wrap2(torch.fft.fft2, "fft2")
ifft2 = _wrap2(torch.fft.ifft2, "ifft2")
rfft2 = _wrap2(torch.fft.rfft2, "rfft2")
irfft2 = _wrap2(torch.fft.irfft2, "irfft2")
hfft2 = _wrap2(_hfftn_impl, "hfft2")
ihfft2 = _wrap2(_ihfftn_impl, "ihfft2")
hfftn = _wrapn(_hfftn_impl, "hfftn")
ihfftn = _wrapn(_ihfftn_impl, "ihfftn")
fftn = _wrapn(torch.fft.fftn, "fftn")
ifftn = _wrapn(torch.fft.ifftn, "ifftn")
rfftn = _wrapn(torch.fft.rfftn, "rfftn")
irfftn = _wrapn(torch.fft.irfftn, "irfftn")


def _freq(tfn, n, d, dtype):
    # in f64, then cast: the JAX package computes in its default float
    # and casts, so the two agree to the cast's rounding
    v = tfn(n, d, dtype=torch.float64, device=place_mod.current_device())
    return Tensor._wrap(v.to(dtype_mod.convert_dtype(dtype)))


def fftfreq(n, d=1.0, dtype="float32", name=None):
    return _freq(torch.fft.fftfreq, n, d, dtype)


def rfftfreq(n, d=1.0, dtype="float32", name=None):
    return _freq(torch.fft.rfftfreq, n, d, dtype)


def fftshift(x, axes=None, name=None):
    return apply_op(lambda v: torch.fft.fftshift(v, dim=axes), "fftshift",
                    (x,), {})


def ifftshift(x, axes=None, name=None):
    return apply_op(lambda v: torch.fft.ifftshift(v, dim=axes), "ifftshift",
                    (x,), {})
