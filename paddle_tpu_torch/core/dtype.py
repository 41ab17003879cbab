"""Dtypes of the port (``paddle_tpu.core.dtype`` counterpart).

A paddle dtype here IS a ``torch.dtype`` (``float32 is torch.float32``),
with the JAX package's alias table (``"fp16"``, ``"bf16"``, ...) and
default dtype.  Names compare across the packages through
:func:`dtype_name` (``"float32"``, ``"bool"``).

The JAX package runs with x64 on, and its ops promote as ``jax.numpy``
does; where torch promotes differently the port's ops follow the JAX
package (:func:`result_type`, :func:`inexact`):

* a 0-d tensor takes part in promotion like any other tensor (torch
  lets a 0-d tensor of the same kind defer to the other operand);
* a Python float meeting a bool or integer tensor gives float64, a
  Python int meeting a bool tensor int64, a Python complex complex128
  (complex64 beside a 32-bit or narrower float);
* integer and bool inputs of float functions (``sqrt``, ``mean``,
  ``divide``, ...) become float32, int64 and uint64 float64.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["bool_", "uint8", "int8", "int16", "int32", "int64", "float16",
           "bfloat16", "float32", "float64", "complex64", "complex128",
           "convert_dtype", "dtype_name", "is_floating_point", "is_integer",
           "set_default_dtype", "get_default_dtype", "promote_types",
           "result_type", "inexact", "operands", "as_inexact",
           "half_in_single"]

bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128

_ALIASES = {
    "bool": bool_,
    "uint8": uint8,
    "int8": int8,
    "int16": int16,
    "int32": int32,
    "int64": int64,
    "float16": float16,
    "fp16": float16,
    "half": float16,
    "bfloat16": bfloat16,
    "bf16": bfloat16,
    "float32": float32,
    "fp32": float32,
    "float": float32,
    "float64": float64,
    "fp64": float64,
    "double": float64,
    "complex64": complex64,
    "complex128": complex128,
}
_NAMES = {v: k for k, v in reversed(list(_ALIASES.items()))}
# numpy dtypes without a torch twin (uint16/32/64 in older torch) are not
# listed: converting one raises
_FROM_NUMPY = {np.dtype(k): v for k, v in _ALIASES.items()
               if k in ("bool", "uint8", "int8", "int16", "int32", "int64",
                        "float16", "float32", "float64", "complex64",
                        "complex128")}

_FLOATING = {float16, bfloat16, float32, float64}
_INTEGRAL = {uint8, int8, int16, int32, int64}


def convert_dtype(dtype) -> torch.dtype:
    """Normalise any user-supplied dtype spec into a ``torch.dtype``."""
    if dtype is None:
        raise TypeError("dtype must not be None")
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        key = dtype.lower()
        if key.startswith("paddle."):
            key = key[len("paddle."):]
        if key not in _ALIASES:
            raise TypeError(f"unsupported dtype string {dtype!r}")
        return _ALIASES[key]
    try:
        return _FROM_NUMPY[np.dtype(dtype)]
    except (KeyError, TypeError):
        raise TypeError(f"unsupported dtype {dtype!r}") from None


def dtype_name(dtype) -> str:
    """``"float32"``, ``"bool"``, ...: the name the JAX package gives."""
    return _NAMES[convert_dtype(dtype)]


def is_floating_point(dtype) -> bool:
    return convert_dtype(dtype) in _FLOATING


def is_integer(dtype) -> bool:
    d = convert_dtype(dtype)
    return d in _INTEGRAL or d == bool_


_default_dtype = float32


def set_default_dtype(dtype):
    """paddle.set_default_dtype — affects float tensor creation defaults."""
    global _default_dtype
    d = convert_dtype(dtype)
    if d not in _FLOATING:
        raise TypeError(f"default dtype must be floating, got {d}")
    _default_dtype = d


def get_default_dtype() -> torch.dtype:
    return _default_dtype


def promote_types(a, b) -> torch.dtype:
    return torch.promote_types(convert_dtype(a), convert_dtype(b))


def inexact(dtype: torch.dtype) -> torch.dtype:
    """The dtype a float function computes in for ``dtype`` inputs."""
    if dtype.is_floating_point or dtype.is_complex:
        return dtype
    return float64 if dtype in (int64, getattr(torch, "uint64", None)) \
        else float32


def _weak(dtype: torch.dtype, scalar) -> torch.dtype:
    """A tensor of ``dtype`` meeting a Python scalar."""
    if isinstance(scalar, bool):
        return dtype
    if isinstance(scalar, int):
        return int64 if dtype == bool_ else dtype
    if isinstance(scalar, float):
        return dtype if dtype.is_floating_point or dtype.is_complex \
            else float64
    if isinstance(scalar, complex):
        if dtype.is_complex:
            return dtype
        return complex64 if dtype in (float16, bfloat16, float32) \
            else complex128
    return dtype


def result_type(*args) -> torch.dtype | None:
    """The JAX package's result dtype over tensors and Python scalars
    (``None`` when no argument is a tensor)."""
    out = None
    for a in args:
        if isinstance(a, torch.Tensor):
            out = a.dtype if out is None else torch.promote_types(out, a.dtype)
    if out is None:
        return None
    for a in args:
        if isinstance(a, (bool, int, float, complex)):
            out = _weak(out, a)
    return out


def operands(*args):
    """``args`` at the JAX package's result dtype: tensors cast to it,
    Python scalars as 0-d CPU tensors of it (torch takes those beside a
    tensor on any device)."""
    if len(args) == 2 and isinstance(args[0], torch.Tensor) and \
            isinstance(args[1], torch.Tensor) and \
            args[0].dtype == args[1].dtype:
        return args
    dt = result_type(*args)
    return tuple(
        (a if a.dtype == dt else a.to(dt)) if isinstance(a, torch.Tensor)
        else torch.tensor(a, dtype=dt) if isinstance(
            a, (bool, int, float, complex)) else a
        for a in args)


def as_inexact(x):
    """``x`` as the dtype a float function computes in."""
    d = inexact(x.dtype)
    return x if d == x.dtype else x.to(d)


def half_in_single(fn):
    """``fn`` (a torch op with no bfloat16 / float16 implementation:
    LU-based linalg, quantiles, 3-D average pooling on the CPU) taking
    half-precision tensors: they are computed in float32 and the floating
    results come back in the half dtype, the dtype the JAX package
    computes and returns them in."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        half = next((a.dtype for a in args if isinstance(a, torch.Tensor)
                     and a.dtype in (float16, bfloat16)), None)
        if half is None:
            return fn(*args, **kwargs)
        out = fn(*[a.float() if isinstance(a, torch.Tensor)
                   and a.dtype == half else a for a in args], **kwargs)

        def back(o):
            if isinstance(o, torch.Tensor) and o.dtype == float32:
                return o.to(half)
            if isinstance(o, (tuple, list)):
                return type(o)(back(v) for v in o)
            return o

        return back(out)
    return run
