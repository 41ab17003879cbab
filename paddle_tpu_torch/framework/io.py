"""Object save/load: ``paddle.save`` / ``paddle.load`` (reference:
python/paddle/framework/io.py:574,791; the port's copy of
``paddle_tpu/framework/io.py``).

``paddle.save(layer.state_dict(), "model.pdparams")`` pickles a nest of
numpy arrays, each Tensor as a ``_SavedTensor`` marker so that ``load``
gives Tensors back.  Files cross between the packages both ways: the
port writes its marker under the JAX package's class name
(``paddle_tpu.framework.io._SavedTensor``, the same slots state), and
its ``load`` maps that name onto its own class through
``Unpickler.find_class``, so neither side imports the other.  A
bfloat16 Tensor is saved as its float32 values, as ``Tensor.numpy()``
gives them (numpy has no bfloat16).
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from ..core.tensor import Tensor

# the class name both packages write and read
_SAVED_MODULE, _SAVED_NAME = "paddle_tpu.framework.io", "_SavedTensor"


def _to_saveable(obj):
    if isinstance(obj, Tensor):
        return _SavedTensor(obj.numpy())
    if isinstance(obj, torch.Tensor):
        return _SavedTensor(Tensor._wrap(obj).numpy())
    if isinstance(obj, dict):
        return {k: _to_saveable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_saveable(v) for v in obj)
    return obj


class _SavedTensor:
    """Marker wrapper so load() can distinguish tensors from raw ndarrays."""

    __slots__ = ("array",)

    def __init__(self, array: np.ndarray):
        self.array = array


class _Pickler(pickle._Pickler):
    """The pure-Python pickler, writing :class:`_SavedTensor` under the
    JAX package's class name."""

    def save_global(self, obj, name=None):
        if obj is not _SavedTensor:
            return super().save_global(obj, name)
        if self.proto >= 4:
            self.save(_SAVED_MODULE)
            self.save(_SAVED_NAME)
            self.write(pickle.STACK_GLOBAL)
        else:
            self.write(pickle.GLOBAL + f"{_SAVED_MODULE}\n{_SAVED_NAME}\n"
                       .encode("utf-8"))
        self.memoize(obj)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) == (_SAVED_MODULE, _SAVED_NAME):
            return _SavedTensor
        return super().find_class(module, name)


def _from_saved(obj, return_numpy=False):
    if isinstance(obj, _SavedTensor):
        return obj.array if return_numpy else Tensor(obj.array)
    if isinstance(obj, np.ndarray):
        return obj if return_numpy else Tensor(obj)
    if isinstance(obj, dict):
        return {k: _from_saved(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_saved(v, return_numpy) for v in obj)
    return obj


def save(obj, path, protocol=4, **configs):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        _Pickler(f, protocol=protocol).dump(_to_saveable(obj))


def load(path, return_numpy=False, **configs):
    """The object :func:`save` wrote (either package's file): Tensors on
    the current place, or numpy arrays with ``return_numpy``."""
    with open(path, "rb") as f:
        obj = _Unpickler(f).load()
    return _from_saved(obj, return_numpy=return_numpy)
