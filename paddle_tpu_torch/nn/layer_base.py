"""``nn.Layer``, ``Parameter``, ``ParamAttr`` (``paddle_tpu.nn.layer_base``
counterparts).

``Layer`` is a ``torch.nn.Module``.  Torch's registry keeps holding
``torch.nn.Parameter`` leaves and buffer tensors, so the models, the
optimizers, the train step, ``models.convert``, CUDA-graph capture,
``.to()`` and ``torch.func`` work on a Layer as on any module, and a
torch parent over a Layer child (GPT's and BERT's ``LayerNorm``) keeps
torch's ``state_dict`` / ``named_parameters`` / ``_apply`` recursion.

The paddle face sits on top:

* ``Parameter`` is a surface ``Tensor`` whose ``_value`` *is* the
  registered leaf (no copy): ``.grad`` is torch's gradient, ``trainable``
  is ``requires_grad``, and its other fields (``optimize_attr``,
  ``regularizer``, ``need_clip``, ``is_distributed``, ``name``) live on
  the leaf (``leaf._paddle_attrs``), so the optimizer and the clips find
  them from the leaf, and a deep copy or a conversion carries them.
  In-place forms, ``set_value`` and ``copy_`` write into the leaf's
  storage under ``no_grad`` (a plain Tensor rebinds ``_value`` instead;
  a Parameter must not, or the registry and the optimizer would keep a
  stale leaf).
  Buffers read from a Layer are surface Tensors bound the same way.
* Attribute reads of a parameter or buffer (``layer.weight``),
  ``parameters()`` (a list), ``named_parameters``, ``buffers``,
  ``state_dict()`` (surface Tensors under the JAX package's names, in its
  breadth-first order), ``set_state_dict`` (Tensors, numpy arrays or
  torch tensors; returns ``(missing, unexpected)``), ``create_parameter``,
  ``add_parameter``, ``add_sublayer``, ``register_buffer(...,
  persistable=)``, ``sublayers``, ``full_name``, ``clear_gradients``,
  ``to(device, dtype, blocking)``, ``astype`` and the forward pre/post
  hooks (``HookRemoveHelper``) are paddle's.  A parameter's wrapper is
  built from what torch's registry holds now (``torch.func`` swaps
  entries); while the entry is unchanged it is the same object.
* ``Layer.__call__`` scans its arguments once, as the ``defop`` boundary
  does: torch tensors in give torch tensors out; a surface Tensor in
  gives surface Tensors out.  The port's own layers (forwards written in
  this package) read torch values and get their inputs unwrapped; a
  forward written elsewhere (a user's ``Layer``) gets the inputs as they
  were passed.  Torch-style calls (``state_dict(prefix=...,
  keep_vars=...)``, ``to(torch.device)``, ``register_buffer(...,
  persistent=)``) go to torch.

Parameters are created on the device of an active ``with
torch.device(...)`` block, else on the current place (``set_device``;
the card by default, raising without one): the port's model
constructors build under their ``device=``.  Inside
``nn.abstract_init()`` they are made on the ``meta`` device instead
(``nn.meta``).
"""
from __future__ import annotations

import copy
import itertools
from collections import OrderedDict

import numpy as np
import torch

from ..core import dtype as dtype_mod
from ..core import place as place_mod
from ..core.tensor import Tensor, _name_counter, _to_torch
from . import initializer as init_mod
from .meta import is_abstract_init

__all__ = ["Layer", "Parameter", "ParamAttr", "HookRemoveHelper",
           "creation_device", "param"]

_layer_counter = itertools.count()
_Module = torch.nn.Module


def creation_device() -> torch.device:
    """Where a Layer creates its parameters: the device of an active
    ``with torch.device(...)`` block, else the current place."""
    try:
        from torch.overrides import _get_current_function_mode_stack
        from torch.utils._device import DeviceContext
        for mode in reversed(_get_current_function_mode_stack()):
            if isinstance(mode, DeviceContext):
                return torch.device(mode.device)
    except ImportError:   # pragma: no cover - older torch
        dev = torch.get_default_device()
        if dev.type != "cpu":
            return dev
    return place_mod.current_device()


def param(layer, name):
    """The torch value a forward reads as parameter ``name`` (None when
    the layer has none): the registered leaf, or the tensor that
    ``nn.utils.weight_norm`` / ``spectral_norm`` rebuilt from their own
    parameters for this call (kept in the layer's ``__dict__``)."""
    p = layer._parameters.get(name)
    if p is not None:
        return p
    rebuilt = layer.__dict__.get(name)
    return None if rebuilt is None else rebuilt._value


class _Bound(Tensor):
    """A surface Tensor over a Layer's own storage: in-place forms write
    into it under ``no_grad`` instead of rebinding ``_value``."""

    __slots__ = ()

    def _rebind(self, new: torch.Tensor) -> "Tensor":
        v = self._value
        if new is v:
            return self
        if tuple(new.shape) != tuple(v.shape):
            raise ValueError(f"cannot write a {tuple(new.shape)} value into "
                             f"{self.name} of shape {tuple(v.shape)}")
        with torch.no_grad():
            v.copy_(new)
        return self

    def set_value(self, value):
        """Write ``value`` (a Tensor, numpy array or torch tensor of the
        same shape) into the storage."""
        return self._rebind(_as_torch(value, self._value))

    def copy_(self, value, blocking=True):
        return self._rebind(_as_torch(value, self._value))

    def detach_(self):
        self._value.requires_grad_(False)
        return self


def _as_torch(v, like: torch.Tensor) -> torch.Tensor:
    if isinstance(v, Tensor):
        v = v._value
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(np.array(v))
    return v.to(like.device, like.dtype)


def _default_attrs(name=None, learning_rate=1.0, regularizer=None,
                   need_clip=True) -> dict:
    return {"name": name, "optimize_attr": {"learning_rate": learning_rate},
            "regularizer": regularizer, "need_clip": need_clip,
            "is_distributed": False}


def param_attrs(leaf: torch.Tensor):
    """The paddle fields a leaf carries (``name``, ``optimize_attr``,
    ``regularizer``, ``need_clip``, ``is_distributed``), or None when
    none were set."""
    return leaf.__dict__.get("_paddle_attrs") if isinstance(
        leaf, torch.nn.Parameter) else None


class Parameter(_Bound):
    """A trainable surface Tensor over a ``torch.nn.Parameter`` leaf.  Its
    fields live on the leaf (``leaf._paddle_attrs``): every wrapper of the
    leaf, the optimizer and the clips read the same ones."""

    __slots__ = ("_local",)

    def __init__(self, data, dtype=None, name=None, trainable=True,
                 learning_rate=1.0, regularizer=None, need_clip=True):
        value = _to_torch(data, dtype, None)
        leaf = torch.nn.Parameter(value, requires_grad=bool(trainable) and (
            value.is_floating_point() or value.is_complex()))
        self._bind(leaf)
        leaf._paddle_attrs = _default_attrs(name, learning_rate, regularizer,
                                            need_clip)

    def _bind(self, leaf):
        self._value = leaf
        self._name = None
        self.persistable = True
        self._local = None

    @staticmethod
    def of(leaf: torch.Tensor) -> "Parameter":
        """A wrapper of ``leaf`` (its fields are the leaf's)."""
        w = object.__new__(Parameter)
        w._bind(leaf)
        return w

    def _attrs(self) -> dict:
        leaf = self._value
        if isinstance(leaf, torch.nn.Parameter):
            attrs = leaf.__dict__.get("_paddle_attrs")
            if attrs is None:
                attrs = leaf._paddle_attrs = _default_attrs()
            return attrs
        if self._local is None:     # a value torch.func swapped in
            self._local = _default_attrs()
        return self._local

    @property
    def name(self) -> str:
        attrs = self._attrs()
        if attrs["name"] is None:
            attrs["name"] = f"generated_tensor_{next(_name_counter)}"
            attrs["generated"] = True
        return attrs["name"]

    @name.setter
    def name(self, value):
        self._attrs().update(name=value, generated=False)

    @property
    def optimize_attr(self) -> dict:
        return self._attrs()["optimize_attr"]

    @optimize_attr.setter
    def optimize_attr(self, value):
        self._attrs()["optimize_attr"] = value

    @property
    def regularizer(self):
        return self._attrs()["regularizer"]

    @regularizer.setter
    def regularizer(self, value):
        self._attrs()["regularizer"] = value

    @property
    def need_clip(self) -> bool:
        return self._attrs()["need_clip"]

    @need_clip.setter
    def need_clip(self, value):
        self._attrs()["need_clip"] = bool(value)

    @property
    def is_distributed(self) -> bool:
        return self._attrs()["is_distributed"]

    @is_distributed.setter
    def is_distributed(self, value):
        self._attrs()["is_distributed"] = bool(value)

    @property
    def trainable(self) -> bool:
        return self._value.requires_grad

    @trainable.setter
    def trainable(self, value: bool):
        self.stop_gradient = not value

    def __repr__(self):
        return "Parameter containing:\n" + super().__repr__()

    __str__ = __repr__


def _carry_attrs(old: torch.Tensor, new: torch.Tensor, copied=False):
    """Copy ``old``'s paddle fields onto ``new`` (a leaf torch made anew:
    a conversion, or with ``copied`` a deep copy, which gets a generated
    name of its own)."""
    attrs = param_attrs(old)
    if attrs is not None and isinstance(new, torch.nn.Parameter) and \
            param_attrs(new) is None:
        new._paddle_attrs = copy.deepcopy(attrs)
        if copied and attrs.get("generated"):
            new._paddle_attrs.update(name=None, generated=False)


class ParamAttr:
    """paddle.ParamAttr parity (python/paddle/fluid/param_attr.py)."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if isinstance(attr, init_mod.Initializer):
            return ParamAttr(initializer=attr)
        if attr is False:
            return False
        raise TypeError(f"cannot make ParamAttr from {attr!r}")


class HookRemoveHelper:
    def __init__(self, hooks: dict, hook_id: int):
        self._hooks = hooks
        self._hook_id = hook_id

    def remove(self):
        self._hooks.pop(self._hook_id, None)


_SEQ = (list, tuple)


def _has_surface(args, kwargs) -> bool:
    for a in args:
        if isinstance(a, Tensor):
            return True
        if isinstance(a, _SEQ):
            for b in a:
                if isinstance(b, Tensor):
                    return True
    for a in kwargs.values():
        if isinstance(a, Tensor):
            return True
    return False


def _unwrap(a):
    if isinstance(a, Tensor):
        return a._value
    if isinstance(a, _SEQ):
        return _map(a, _to_torch_out)
    return a


def _map(out, leaf_fn):
    """``out`` with ``leaf_fn`` applied to every tensor in it (through
    tuples, namedtuples and lists)."""
    if isinstance(out, (torch.Tensor, Tensor)):
        return leaf_fn(out)
    if isinstance(out, tuple):
        items = [_map(o, leaf_fn) for o in out]
        return type(out)(*items) if hasattr(out, "_fields") else \
            type(out)(items)
    if isinstance(out, list):
        return [_map(o, leaf_fn) for o in out]
    return out


def _to_surface(t):
    return Tensor._wrap(t) if isinstance(t, torch.Tensor) else t


def _to_torch_out(t):
    return t._value if isinstance(t, Tensor) else t


def _is_torch_style(args, kwargs, torch_kwargs) -> bool:
    return any(k in kwargs for k in torch_kwargs) or any(
        isinstance(a, (torch.device, torch.dtype, torch.Tensor))
        for a in args)


class Layer(_Module):
    """The paddle Layer base (a ``torch.nn.Module``)."""

    # forwards of the port's own layers read torch values (their inputs
    # are unwrapped); set per class in __init_subclass__
    _torch_forward = False

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        if "forward" in cls.__dict__:
            cls._torch_forward = cls.__module__.startswith(
                "paddle_tpu_torch.")

    def __init__(self, name_scope=None, dtype=None):
        super().__init__()
        self._dtype = dtype_mod.convert_dtype(dtype) if dtype is not None \
            else dtype_mod.get_default_dtype()
        self._full_name = (name_scope or type(self).__name__.lower()) + \
            f"_{next(_layer_counter)}"
        self._pd_pre_hooks = OrderedDict()
        self._pd_post_hooks = OrderedDict()
        self._pd_next_hook = 0
        self._pd_params = {}
        self._pd_buffers = {}

    # -- registration -------------------------------------------------------
    def __setattr__(self, name, value):
        if isinstance(value, Tensor):
            if isinstance(value, Parameter):
                leaf = value._value
                if not isinstance(leaf, torch.nn.Parameter):
                    raise TypeError(f"{name}: a Parameter over a "
                                    f"{type(leaf).__name__}, not a leaf")
                _Module.__setattr__(self, name, leaf)
                self.__dict__.setdefault("_pd_params", {})[name] = value
                return
            bufs = self.__dict__.get("_buffers")
            if bufs is not None and name in bufs:
                bufs[name] = value._value
                return
            params = self.__dict__.get("_parameters")
            if params is not None and name in params:
                raise TypeError(f"cannot assign a Tensor to parameter "
                                f"{name!r}: assign a Parameter, or "
                                f"set_value() into it")
        _Module.__setattr__(self, name, value)

    def __getattr__(self, name):
        d = self.__dict__
        params = d.get("_parameters")
        if params is not None and name in params:
            p = params[name]
            return None if p is None else self._param_view(name, p)
        bufs = d.get("_buffers")
        if bufs is not None and name in bufs:
            b = bufs[name]
            return None if b is None else self._buffer_view(name, b)
        return _Module.__getattr__(self, name)

    def _param_view(self, name, leaf):
        """The Parameter over ``leaf``, the same object while the registry
        entry is unchanged (kept by the layer, not by the leaf, so no
        cycle holds a leaf's memory)."""
        cache = self.__dict__.setdefault("_pd_params", {})
        w = cache.get(name)
        if w is None or w._value is not leaf:
            w = cache[name] = Parameter.of(leaf)
        return w

    def _buffer_view(self, name, b):
        cache = self.__dict__.setdefault("_pd_buffers", {})
        w = cache.get(name)
        if w is None or w._value is not b:
            w = object.__new__(_Bound)
            w._value, w._name = b, name
            w.persistable = name not in self._non_persistent_buffers_set
            cache[name] = w
        return w

    def add_parameter(self, name: str, parameter):
        if parameter is None:
            self.register_parameter(name, None)
            return None
        if isinstance(parameter, torch.nn.Parameter):
            parameter = Parameter.of(parameter)
        if not isinstance(parameter, Parameter):
            raise TypeError("add_parameter expects a Parameter")
        setattr(self, name, parameter)
        return parameter

    def add_sublayer(self, name: str, sublayer):
        self.add_module(name, sublayer)
        return sublayer

    def register_buffer(self, name: str, tensor, persistable=True,
                        persistent=None):
        if persistent is not None:
            persistable = persistent
        raw = tensor._value if isinstance(tensor, Tensor) else tensor
        _Module.register_buffer(self, name, raw, persistent=persistable)
        return tensor

    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        dtype = dtype_mod.convert_dtype(dtype) if dtype is not None \
            else self._dtype
        shape = tuple(int(s) for s in shape)
        if is_abstract_init():
            # shape and dtype only: the meta device wins over any
            # creation device, and no initializer draws
            value = torch.empty(shape, dtype=dtype, device="meta")
        else:
            initializer = attr.initializer or default_initializer or (
                init_mod.Constant(0.0) if is_bias
                else init_mod.XavierUniform())
            value = initializer(shape, dtype, creation_device())
        return Parameter(value, name=attr.name, trainable=attr.trainable,
                         learning_rate=attr.learning_rate,
                         regularizer=attr.regularizer,
                         need_clip=attr.need_clip)

    def create_tensor(self, name=None, dtype=None, default_initializer=None):
        return Tensor._wrap(torch.zeros((), dtype=dtype_mod.convert_dtype(
            dtype) if dtype is not None else self._dtype,
            device=creation_device()))

    # -- traversal ----------------------------------------------------------
    def _traverse(self, prefix="", include_sublayers=True):
        """``(dotted prefix, module)`` for self and its sublayers,
        breadth first, as the JAX package walks them."""
        queue = [(prefix + "." if prefix else "", self)]
        seen = set()
        while queue:
            pfx, layer = queue.pop(0)
            if id(layer) in seen:
                continue
            seen.add(id(layer))
            yield pfx, layer
            if include_sublayers:
                for name, sub in layer._modules.items():
                    if sub is not None:
                        queue.append((f"{pfx}{name}.", sub))

    # paddle's traversal returns surface objects; a call with torch's
    # ``recurse=`` (torch.nn.Module.parameters / buffers pass it) is
    # torch's and returns the torch leaves
    def named_parameters(self, prefix="", include_sublayers=True,
                         recurse=None, remove_duplicate=True):
        if recurse is not None:
            yield from _Module.named_parameters(self, prefix, recurse,
                                                remove_duplicate)
            return
        seen = set()
        for pfx, layer in self._traverse(prefix, include_sublayers):
            for name, p in layer._parameters.items():
                if p is not None and id(p) not in seen:
                    seen.add(id(p))
                    yield f"{pfx}{name}", _pview(layer, name, p)

    def parameters(self, include_sublayers=True, recurse=None):
        if recurse is not None:
            return _Module.parameters(self, recurse)
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers)]

    def named_buffers(self, prefix="", include_sublayers=True, recurse=None,
                      remove_duplicate=True):
        if recurse is not None:
            yield from _Module.named_buffers(self, prefix, recurse,
                                             remove_duplicate)
            return
        seen = set()
        for pfx, layer in self._traverse(prefix, include_sublayers):
            for name, b in layer._buffers.items():
                if b is not None and id(b) not in seen:
                    seen.add(id(b))
                    yield f"{pfx}{name}", _view(layer, name, b)

    def buffers(self, include_sublayers=True, recurse=None):
        if recurse is not None:
            return _Module.buffers(self, recurse)
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers)]

    def sublayers(self, include_self=False):
        out = [layer for _, layer in self._traverse()]
        return out if include_self else out[1:]

    def named_sublayers(self, prefix="", include_self=False):
        for i, (pfx, layer) in enumerate(self._traverse(prefix)):
            if i or include_self:
                yield pfx[:-1] if pfx.endswith(".") else pfx, layer

    def full_name(self):
        return self._full_name

    # -- torch methods that walk parameters through self.parameters() -------
    def requires_grad_(self, requires_grad=True):
        for p in _Module.parameters(self, True):
            p.requires_grad_(requires_grad)
        return self

    def zero_grad(self, set_to_none=True):
        for p in _Module.parameters(self, True):
            if p.grad is not None:
                if set_to_none:
                    p.grad = None
                else:
                    p.grad.detach_().zero_()

    def clear_gradients(self, set_to_zero=False):
        self.zero_grad(set_to_none=not set_to_zero)

    # -- state dict ---------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers=True,
                   use_hook=True, structured_name_prefix="", *, prefix=None,
                   keep_vars=None):
        if prefix is not None or keep_vars is not None:
            # torch's recursion from a torch parent
            return _Module.state_dict(self, destination=destination,
                                      prefix=prefix or "",
                                      keep_vars=bool(keep_vars))
        dest = destination if destination is not None else OrderedDict()
        for pfx, layer in self._traverse(structured_name_prefix.rstrip("."),
                                         include_sublayers):
            for name, p in layer._parameters.items():
                if p is not None:
                    dest[f"{pfx}{name}"] = _pview(layer, name, p)
            for name, b in layer._buffers.items():
                if b is not None and \
                        name not in layer._non_persistent_buffers_set:
                    dest[f"{pfx}{name}"] = _view(layer, name, b)
        return dest

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy ``state_dict``'s values (Tensors, numpy arrays or torch
        tensors) into the parameters and buffers of the same names, in
        place; returns ``(missing, unexpected)``.  A shape that does not
        fit raises ``ValueError`` naming the key."""
        state_dict = dict(state_dict)
        # layers may define _state_dict_compat_(state, prefix) to migrate
        # foreign layouts in place before matching
        for pfx, layer in self._traverse():
            hook = getattr(type(layer), "_state_dict_compat_", None)
            if hook is not None:
                hook(layer, state_dict, pfx)
        own = self.state_dict()
        unexpected = [k for k in state_dict if k not in own]
        missing = [k for k in own if k not in state_dict]
        with torch.no_grad():
            for k, target in own.items():
                if k not in state_dict:
                    continue
                dst = target._value
                val = _as_torch(state_dict[k], dst)
                if tuple(val.shape) != tuple(dst.shape):
                    raise ValueError(f"shape mismatch for {k}: "
                                     f"{tuple(dst.shape)} vs "
                                     f"{tuple(val.shape)}")
                dst.copy_(val)
        return missing, unexpected

    load_dict = set_state_dict
    set_dict = set_state_dict

    # -- call ---------------------------------------------------------------
    def __call__(self, *inputs, **kwargs):
        surface = _has_surface(inputs, kwargs)
        if self._pd_pre_hooks:
            for hook in list(self._pd_pre_hooks.values()):
                result = hook(self, inputs)
                if result is not None:
                    inputs = result if isinstance(result, tuple) \
                        else (result,)
        if surface and self._torch_forward:
            out = _Module.__call__(self, *[_unwrap(a) for a in inputs],
                                   **{k: _unwrap(v)
                                      for k, v in kwargs.items()})
        else:
            out = _Module.__call__(self, *inputs, **kwargs)
        if surface:
            if not isinstance(out, Tensor):
                out = _map(out, _to_surface)
        elif not isinstance(out, torch.Tensor):
            out = _map(out, _to_torch_out)
        if self._pd_post_hooks:
            for hook in list(self._pd_post_hooks.values()):
                result = hook(self, inputs, out)
                if result is not None:
                    out = result
        return out

    def _add_hook(self, hooks, hook) -> HookRemoveHelper:
        hid = self._pd_next_hook
        self._pd_next_hook = hid + 1
        hooks[hid] = hook
        return HookRemoveHelper(hooks, hid)

    def register_forward_pre_hook(self, hook) -> HookRemoveHelper:
        """``hook(layer, inputs)``; a non-None result replaces the
        inputs."""
        return self._add_hook(self._pd_pre_hooks, hook)

    def register_forward_post_hook(self, hook) -> HookRemoveHelper:
        """``hook(layer, inputs, output)``; a non-None result replaces
        the output."""
        return self._add_hook(self._pd_post_hooks, hook)

    # -- device and dtype ---------------------------------------------------
    def to(self, *args, **kwargs):
        """``to(device=None, dtype=None, blocking=None)``: ``device`` a
        place or ``"cpu"`` / ``"gpu[:N]"``, ``dtype`` a paddle dtype name
        or a torch dtype.  Floating parameters and buffers are cast, as
        torch casts them.  Torch's forms (a ``torch.device``, a tensor,
        ``non_blocking=``, ...) go to ``torch.nn.Module.to``."""
        if _is_torch_style(args, kwargs,
                           ("non_blocking", "memory_format", "copy")):
            return _Module.to(self, *args, **kwargs)
        names = ("device", "dtype", "blocking")
        bound = dict(zip(names, args))
        bound.update(kwargs)
        device, dtype = bound.get("device"), bound.get("dtype")
        if device is not None and not isinstance(device, torch.device):
            if isinstance(device, str) and device in dtype_mod._ALIASES \
                    and dtype is None:
                device, dtype = None, device
            else:
                place = device if isinstance(device, place_mod.Place) else \
                    _place_of(device)
                device = place.torch_device()
        if dtype is not None:
            dtype = dtype_mod.convert_dtype(dtype)
        return _Module.to(self, device=device, dtype=dtype)

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def _apply(self, fn, recurse=True):
        before = dict(self._parameters)
        out = _Module._apply(self, fn, recurse)
        for name, old in before.items():
            new = self._parameters.get(name)
            if old is not None and new is not None and new is not old:
                _carry_attrs(old, new)
        return out

    def __deepcopy__(self, memo):
        new = type(self).__new__(type(self))
        memo[id(self)] = new
        for k, v in self.__dict__.items():
            if k not in ("_pd_params", "_pd_buffers"):
                object.__setattr__(new, k, copy.deepcopy(v, memo))
        object.__setattr__(new, "_pd_params", {})
        object.__setattr__(new, "_pd_buffers", {})
        for name, leaf in self._parameters.items():
            if leaf is not None:
                _carry_attrs(leaf, new._parameters[name], copied=True)
        return new


def _place_of(device: str) -> place_mod.Place:
    name, _, idx = str(device).partition(":")
    if name == "cpu":
        return place_mod.CPUPlace()
    if name in ("gpu", "cuda"):
        return place_mod.CUDAPlace(int(idx or 0))
    raise ValueError(f"unsupported device {device!r}")


def _pview(layer, name, p):
    return layer._param_view(name, p) if isinstance(layer, Layer) else \
        Parameter.of(p)


def _view(layer, name, b):
    if isinstance(layer, Layer):
        return layer._buffer_view(name, b)
    w = object.__new__(_Bound)
    w._value, w._name, w.persistable = b, name, True
    return w
