"""Tensor — the port's user-facing array (``paddle_tpu.core.tensor``
counterpart).

A ``Tensor`` wraps a ``torch.Tensor`` in ``_value`` (``.value`` returns
it) and adds the reference Tensor's eager surface: ``shape`` as a list,
``stop_gradient`` (default True), ``.grad``, ``backward()``, in-place
forms, numpy interop.  It is a wrapper, not a ``torch.Tensor`` subclass:
paddle's methods clash with torch's on the same names (``shape`` is a
list, ``size`` an int, ``transpose(perm)``, ``split(num_or_sections)``,
``max`` returns values only), and the port's models keep bare tensors
and pay no ``__torch_function__`` dispatch.  Compute lives in the ops
(``core.op.defop``), as in the JAX package.

Autograd is torch's own, on ``_value``: ``stop_gradient=False`` on a leaf
is ``requires_grad_(True)``, ``.grad`` wraps ``_value.grad``.  It holds
for floating and complex tensors only; ``stop_gradient=False`` on an
integer or bool tensor is ignored (torch cannot differentiate them).

Aliasing follows the JAX package, whose arrays are immutable: an
in-place form (``x[i] = v``, ``add_``, ``zero_``, ...) rebinds ``_value``
to a new tensor and never writes into the old storage, so a tensor taken
from ``x`` before (``y = x[0]``, a view in torch) keeps its values, and
the autograd graph carries across the rebinding.
"""
from __future__ import annotations

import itertools
from typing import Any

import numpy as np
import torch

from . import dtype as dtype_mod
from . import place as place_mod

__all__ = ["Tensor", "to_tensor"]

_name_counter = itertools.count()
_new = object.__new__


def _to_torch(data, dtype, place) -> torch.Tensor:
    if isinstance(data, (Tensor, torch.Tensor)):
        value = (data._value if isinstance(data, Tensor) else data).detach()
        if place is not None:
            value = value.to(place.torch_device())
    else:
        arr = np.asarray(data)
        if (dtype is None and arr.dtype == np.float64
                and not isinstance(data, (np.ndarray, np.generic))):
            # Python floats / float lists take the default dtype (float32),
            # as paddle.to_tensor does; numpy float64 arrays keep theirs
            dtype = dtype_mod.get_default_dtype()
        if not arr.flags.c_contiguous or not arr.flags.writeable:
            arr = arr.copy(order="C")
        value = torch.tensor(arr, device=place.torch_device() if place
                             else place_mod.current_device())
    if dtype is not None:
        value = value.to(dtype_mod.convert_dtype(dtype))
    if isinstance(place, place_mod.CUDAPinnedPlace):
        value = value.pin_memory()
    return value


def _index(idx):
    """The JAX package's index normalisation: a list or tuple is a tuple
    of indices, a Tensor index its value."""
    idx = tuple(idx) if isinstance(idx, (tuple, list)) else (idx,)
    return tuple(i._value if isinstance(i, Tensor) else i for i in idx)


def _positive_steps(v, idx):
    """``(v', idx')`` with every negative-step slice of a basic index
    turned positive on a flipped ``v`` (torch slices take no negative
    step)."""
    if not any(isinstance(i, slice) and i.step is not None and i.step < 0
               for i in idx):
        return v, idx, ()
    n_used = sum(0 if i is None or i is Ellipsis else
                 (i.ndim if isinstance(i, torch.Tensor) and
                  i.dtype == torch.bool else 1) for i in idx)
    out, dim, flips = [], 0, []
    for i in idx:
        if i is Ellipsis:
            dim += v.ndim - n_used
            out.append(i)
            continue
        if isinstance(i, slice) and i.step is not None and i.step < 0:
            size = v.shape[dim]
            start, stop, step = i.indices(size)
            n = len(range(start, stop, step))
            a = size - 1 - start
            i = slice(a, a - step * (n - 1) + 1, -step) if n else slice(0, 0)
            flips.append(dim)
        out.append(i)
        if i is not None:
            dim += i.ndim if isinstance(i, torch.Tensor) and \
                i.dtype == torch.bool else 1
    return (torch.flip(v, flips) if flips else v), tuple(out), tuple(flips)


class Tensor:
    __slots__ = ("_value", "_name", "persistable", "__weakref__")

    def __init__(self, data: Any = None, dtype=None, place=None,
                 stop_gradient: bool = True, name: str | None = None):
        self._value = _to_torch(data, dtype, place)
        self._name = name
        self.persistable = False
        if not stop_gradient:
            self.stop_gradient = False

    @staticmethod
    def _wrap(value: torch.Tensor) -> "Tensor":
        """A Tensor over ``value`` as it is (the ops' outputs)."""
        t = _new(Tensor)
        t._value = value
        t._name = None
        t.persistable = False
        return t

    # -- core properties ----------------------------------------------------
    @property
    def value(self) -> torch.Tensor:
        return self._value

    @property
    def name(self) -> str:
        if self._name is None:
            self._name = f"generated_tensor_{next(_name_counter)}"
        return self._name

    @name.setter
    def name(self, v):
        self._name = v

    @property
    def shape(self) -> list[int]:
        return list(self._value.shape)

    @property
    def ndim(self) -> int:
        return self._value.ndim

    @property
    def dtype(self) -> torch.dtype:
        return self._value.dtype

    @property
    def size(self) -> int:
        return self._value.numel()

    @property
    def place(self) -> place_mod.Place:
        dev = self._value.device
        if dev.type == "cuda":
            return place_mod.CUDAPlace(dev.index or 0)
        if torch.cuda.is_available() and self._value.is_pinned():
            return place_mod.CUDAPinnedPlace()
        return place_mod.CPUPlace()

    @property
    def stop_gradient(self) -> bool:
        return not self._value.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, stop: bool):
        v = self._value
        if stop:
            if v.requires_grad:
                self._value = v.requires_grad_(False) if v.is_leaf \
                    else v.detach()
        elif not v.requires_grad and (v.is_floating_point() or v.is_complex()):
            v.requires_grad_(True)

    @property
    def is_leaf(self) -> bool:
        return self._value.is_leaf

    @property
    def grad(self):
        """The leaf's gradient: a Tensor, or a ``SelectedRows`` where it
        is sparse (``Embedding(sparse=True)``)."""
        v = self._value
        g = v.grad if v.is_leaf else None
        if g is None:
            return None
        if g.is_sparse:
            from .selected_rows import SelectedRows
            return SelectedRows.of(g)
        return Tensor._wrap(g)

    @grad.setter
    def grad(self, g):
        from .selected_rows import SelectedRows
        if isinstance(g, SelectedRows):
            g = g.torch_value
        self._value.grad = None if g is None else (
            g._value if isinstance(g, Tensor) else torch.as_tensor(
                g, dtype=self._value.dtype, device=self._value.device))

    @property
    def T(self) -> "Tensor":
        v = self._value
        return Tensor._wrap(v.permute(*range(v.ndim - 1, -1, -1)))

    # -- autograd -----------------------------------------------------------
    def backward(self, grad_tensor=None, retain_graph: bool = False):
        from . import autograd
        autograd.backward([self], [grad_tensor], retain_graph=retain_graph)

    def clear_grad(self):
        if self._value.is_leaf:
            self._value.grad = None

    clear_gradient = clear_grad

    def detach(self) -> "Tensor":
        t = Tensor._wrap(self._value.detach())
        t._name = self.name + ".detach"
        return t

    def detach_(self) -> "Tensor":
        self._value = self._value.detach()
        return self

    def _rebind(self, new: torch.Tensor) -> "Tensor":
        """The in-place primitive: ``_value`` becomes ``new`` (the graph
        rides on it).  A tensor that required grad and gets a value that
        does not (an in-place form under ``no_grad``) stays a leaf that
        requires grad, its ``.grad`` kept, as the JAX package's
        ``_replace_(value, None)`` leaves it."""
        old = self._value
        if old.requires_grad and not new.requires_grad:
            new = new.detach().requires_grad_(True)
            if old.is_leaf and old.grad is not None and \
                    old.grad.shape == new.shape:
                new.grad = old.grad
        self._value = new
        return self

    # -- conversion ---------------------------------------------------------
    def numpy(self) -> np.ndarray:
        """A host copy.  bfloat16 comes back as float32 values (numpy has
        no bfloat16 without ``ml_dtypes``)."""
        v = self._value.detach().resolve_conj().resolve_neg()
        if v.dtype == torch.bfloat16:
            v = v.float()
        elif v.device.type == "cpu":
            v = v.clone()
        return v.cpu().numpy()

    def item(self, *args):
        if args:
            return self.numpy().item(*args)
        return self._value.item()

    def tolist(self):
        return self._value.tolist()

    def numel(self) -> int:
        return self._value.numel()

    def element_size(self) -> int:
        return self._value.element_size()

    def astype(self, dtype) -> "Tensor":
        return Tensor._wrap(self._value.to(dtype_mod.convert_dtype(dtype)))

    cast = astype

    def clone(self) -> "Tensor":
        return Tensor._wrap(self._value.clone())

    def cpu(self) -> "Tensor":
        return Tensor._wrap(self._value.cpu())

    def to(self, target=None, dtype=None, blocking=None) -> "Tensor":
        t = self
        if isinstance(target, str) and target not in dtype_mod._ALIASES:
            name, _, idx = target.partition(":")
            place = place_mod.CPUPlace() if name == "cpu" else \
                place_mod.CUDAPlace(int(idx or 0))
            t = Tensor._wrap(t._value.to(place.torch_device()))
        elif isinstance(target, place_mod.Place):
            t = Tensor._wrap(t._value.to(target.torch_device()))
        elif target is not None and dtype is None:
            dtype = target
        if dtype is not None:
            t = t.astype(dtype)
        return t

    def pin_memory(self) -> "Tensor":
        return Tensor._wrap(self._value.cpu().pin_memory())

    # -- python protocol ----------------------------------------------------
    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of a 0-d tensor")
        return self._value.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def _scalar(self):
        # paddle permits python-scalar conversion of any single-element tensor
        return self._value.reshape(()).item()

    def __bool__(self):
        return bool(self._scalar())

    def __int__(self):
        return int(self._scalar())

    def __float__(self):
        return float(self._scalar())

    def __index__(self):
        return int(self._scalar())

    def __format__(self, spec):
        if self.ndim == 0:
            return format(self.item(), spec)
        return format(str(self), spec)

    def __getitem__(self, idx):
        v, idx, _ = _positive_steps(self._value, _index(idx))
        return Tensor._wrap(v[idx])

    def __setitem__(self, idx, val):
        val = val._value if isinstance(val, Tensor) else torch.as_tensor(
            np.asarray(val), device=self._value.device)
        v, idx, flips = _positive_steps(self._value, _index(idx))
        new = v.clone()
        new[idx] = val.to(new.dtype)
        self._rebind(torch.flip(new, flips) if flips else new)

    def __repr__(self):
        body = np.array2string(self.numpy(), precision=8, separator=", ")
        return (f"Tensor(shape={self.shape}, "
                f"dtype={dtype_mod.dtype_name(self.dtype)}, "
                f"place={self.place}, stop_gradient={self.stop_gradient},\n"
                f"       {body})")

    __str__ = __repr__

    def __hash__(self):
        return id(self)

    # NB: __eq__ is element-wise (installed by ops.logic); hash stays identity
    # like the reference's Tensor.


def to_tensor(data, dtype=None, place=None, stop_gradient=True) -> Tensor:
    """paddle.to_tensor parity (python/paddle/tensor/creation.py): a copy
    of ``data`` (a new leaf when ``data`` is a Tensor) on ``place`` (the
    current place for host data)."""
    return Tensor(data, dtype=dtype, place=place, stop_gradient=stop_gradient)
