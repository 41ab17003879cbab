"""``paddle_tpu.utils.cpp_extension`` counterpart: C++ custom ops built
at run time (``load``, ``setup``, ``CppExtension``).

The ABI is the JAX package's: user C++ exports ``pt_op_<name>`` as
``paddle_ext.h`` declares it (the port's copy lives in ``kernels/csrc``,
``sysconfig.get_include()``), so one source builds against both
packages.  Sources compile with ``g++`` through ``utils.native_build``.
An op runs on the host: its wrapper copies the inputs to the host, calls
``pt_op_<name>`` and copies the outputs back to the first input's device
(one host sync a call on the card).  ``grad_op_map={"fwd": "fwd_grad"}``
names a gradient op that takes (inputs..., grad_outputs...) and writes
the inputs' gradients; it is wired through a ``torch.autograd.Function``.
An op without one gives outputs that stop the gradient.

``CUDAExtension`` raises, as the JAX package's does: the port's CUDA
kernels are its own, in ``kernels/csrc``, built with ``nvcc`` at first
use (``kernels/_build.py``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import types

import numpy as np
import torch

from .native_build import build_native_lib, get_build_directory

__all__ = ["load", "setup", "CppExtension", "CUDAExtension",
           "get_build_directory"]

_DTYPE_CODE = {"float32": 0, "float64": 1, "int32": 2, "int64": 3,
               "uint8": 4, "bool": 5}
_HEADERS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "kernels", "csrc")


class _PTTensor(ctypes.Structure):
    _fields_ = [("data", ctypes.c_void_p),
                ("shape", ctypes.POINTER(ctypes.c_int64)),
                ("ndim", ctypes.c_int),
                ("dtype", ctypes.c_int)]


def _as_pt(arr: np.ndarray, holder):
    code = _DTYPE_CODE.get(str(arr.dtype))
    if code is None:
        raise TypeError(
            f"dtype {arr.dtype} is not supported by custom C++ ops "
            f"(supported: {sorted(_DTYPE_CODE)}); cast to float32 before "
            "the op")
    shape = (ctypes.c_int64 * max(arr.ndim, 1))(*(arr.shape or (0,)))
    holder.append(shape)   # keep the shape alive for the native call
    holder.append(arr)     # and the buffer
    return _PTTensor(arr.ctypes.data_as(ctypes.c_void_p), shape, arr.ndim,
                     code)


class CppExtension:
    def __init__(self, sources, include_dirs=None, extra_compile_args=None,
                 **kwargs):
        self.sources = sources if isinstance(sources, (list, tuple)) \
            else [sources]
        self.include_dirs = include_dirs or []
        self.extra_compile_args = extra_compile_args or []


def CUDAExtension(*args, **kwargs):
    raise RuntimeError(
        "CUDAExtension is not built here: the port's CUDA kernels live in "
        "paddle_tpu_torch/kernels/csrc and build with nvcc at first use "
        "(kernels/_build.py); CppExtension builds host ops")


def _compile(name, sources, include_dirs=(), extra_flags=(),
             build_directory=None):
    if len(sources) != 1:
        # one translation unit including every source; the sources' bytes
        # go into its text (a digest), so an edit of any source rebuilds
        bdir = build_directory or get_build_directory()
        os.makedirs(bdir, exist_ok=True)
        paths = [os.path.abspath(s) for s in sources]
        digest = hashlib.sha256()
        for p in paths:
            with open(p, "rb") as f:
                digest.update(f.read())
        content = f"// sources {digest.hexdigest()}\n" + "".join(
            f'#include "{p}"\n' for p in paths)
        src = os.path.join(bdir, f"{name}_all.cpp")
        if not os.path.exists(src) or open(src).read() != content:
            tmp = f"{src}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                f.write(content)
            os.replace(tmp, src)
    else:
        src = os.path.abspath(sources[0])
    flags = [f"-I{_HEADERS}"] + [f"-I{d}" for d in include_dirs] + \
        list(extra_flags)
    return build_native_lib(src, f"lib{name}.so", extra_flags=tuple(flags),
                            build_dir=build_directory)


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).split(".")[-1]


def _make_op(lib, op_name, infer_shape, infer_dtype, grad_name=None):
    from ..core.op import apply_op
    from ..core.tensor import Tensor, to_tensor

    fn = getattr(lib, f"pt_op_{op_name}")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(_PTTensor), ctypes.c_int,
                   ctypes.POINTER(_PTTensor), ctypes.c_int]
    grad_fn = None
    if grad_name is not None:
        grad_fn = getattr(lib, f"pt_op_{grad_name}")
        grad_fn.restype = ctypes.c_int
        grad_fn.argtypes = fn.argtypes

    def run_native(native, vals, specs):
        """``native`` on host copies of ``vals``; outputs of ``specs``
        (shape, dtype name) on the first value's device."""
        holder = []
        host = [v.detach().cpu().contiguous().numpy() for v in vals]
        ins = (_PTTensor * len(host))(*[_as_pt(a, holder) for a in host])
        outs_np = [np.empty(s, d) for s, d in specs]
        outs = (_PTTensor * len(outs_np))(
            *[_as_pt(a, holder) for a in outs_np])
        rc = native(ins, len(host), outs, len(outs_np))
        if rc != 0:
            raise RuntimeError(f"custom op {op_name} returned {rc}")
        dev = vals[0].device
        return [torch.from_numpy(a).to(dev) for a in outs_np]

    def out_specs(vals):
        shapes = infer_shape(*[tuple(v.shape) for v in vals])
        dtypes = infer_dtype(*[_dtype_name(v) for v in vals])
        if not isinstance(shapes, list):
            shapes = [shapes]
        if not isinstance(dtypes, list):
            dtypes = [dtypes]
        return [(tuple(s), d) for s, d in zip(shapes, dtypes)]

    def unpack(outs):
        return outs[0] if len(outs) == 1 else tuple(outs)

    class _Op(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *vals):
            ctx.save_for_backward(*vals)
            return unpack(run_native(fn, vals, out_specs(vals)))

        @staticmethod
        def backward(ctx, *grads):
            vals = ctx.saved_tensors
            specs = [(tuple(v.shape), _dtype_name(v)) for v in vals]
            return unpack(run_native(grad_fn, (*vals, *grads), specs))

    def op_impl(*vals):
        if grad_fn is None:
            return unpack(run_native(fn, [v.detach() for v in vals],
                                     out_specs(vals)))
        return _Op.apply(*vals)

    def op(*args):
        tensors = [a if isinstance(a, Tensor) else to_tensor(np.asarray(a))
                   for a in args]
        return apply_op(op_impl, f"custom_{op_name}", tuple(tensors), {})

    op.__name__ = op_name
    return op


def load(name, sources, functions=None, extra_cxx_cflags=None,
         build_directory=None, verbose=False, grad_op_map=None,
         infer_shapes=None, infer_dtypes=None, **kwargs):
    """Compile ``sources`` and return a module-like object with one
    callable for each op of ``functions`` (op names; each C symbol is
    ``pt_op_<name>``).

    ``infer_shapes`` / ``infer_dtypes``: for each op, a callable from the
    inputs' shapes / dtype names to the outputs'; by default the first
    input's (the element-wise case).
    """
    if not functions:
        raise ValueError("pass functions=[op_name, ...] (C symbols "
                         "pt_op_<name> in the sources)")
    so = _compile(name, sources, extra_flags=tuple(extra_cxx_cflags or ()),
                  build_directory=build_directory)
    lib = ctypes.CDLL(so)
    grad_op_map = grad_op_map or {}
    infer_shapes = infer_shapes or {}
    infer_dtypes = infer_dtypes or {}
    mod = types.SimpleNamespace()
    for op_name in functions:
        ishape = infer_shapes.get(op_name, lambda *shapes: shapes[0])
        idtype = infer_dtypes.get(op_name, lambda *dts: dts[0])
        setattr(mod, op_name,
                _make_op(lib, op_name, ishape, idtype,
                         grad_name=grad_op_map.get(op_name)))
    mod.__file__ = so
    return mod


def setup(name=None, ext_modules=None, **kwargs):
    """Build only: compile each extension into the build directory (load
    its ops with ``load()``); returns the libraries' paths."""
    exts = ext_modules if isinstance(ext_modules, (list, tuple)) \
        else [ext_modules]
    outs = []
    for i, ext in enumerate(exts):
        if not isinstance(ext, CppExtension):
            raise TypeError("ext_modules must be CppExtension instances")
        ext_name = name or "paddle_tpu_torch_ext"
        if len(exts) > 1:  # one library an extension, never overwritten
            ext_name = f"{ext_name}_{i}"
        outs.append(_compile(ext_name, ext.sources,
                             include_dirs=ext.include_dirs,
                             extra_flags=tuple(ext.extra_compile_args)))
    return outs
