"""``paddle_tpu.strings`` counterpart: the strings op family (``empty``,
``empty_like``, ``lower``, ``upper``) over a host ``StringTensor``.

String data never touches the card: a ``StringTensor`` wraps a numpy
unicode array and the ops vectorise through ``np.char``, as in the JAX
package.
"""
from __future__ import annotations

import numpy as np

__all__ = ["StringTensor", "to_string_tensor", "empty", "empty_like",
           "lower", "upper"]


class StringTensor:
    """A string tensor on the host (a numpy unicode array)."""

    def __init__(self, data):
        self._data = np.asarray(data, dtype=np.str_)

    @property
    def shape(self):
        return tuple(self._data.shape)

    def numpy(self):
        return self._data

    def tolist(self):
        return self._data.tolist()

    def __repr__(self):
        return f"StringTensor(shape={self.shape}, {self._data!r})"

    def __eq__(self, other):
        other = other._data if isinstance(other, StringTensor) else other
        return bool(np.array_equal(self._data, np.asarray(other)))


def to_string_tensor(data) -> StringTensor:
    return data if isinstance(data, StringTensor) else StringTensor(data)


def empty(shape, name=None) -> StringTensor:
    return StringTensor(np.full(tuple(shape), "", dtype=np.str_))


def empty_like(x, name=None) -> StringTensor:
    return empty(to_string_tensor(x).shape)


def lower(x, use_utf8_encoding=True, name=None) -> StringTensor:
    """Element-wise lowercase (numpy unicode arrays work on code points,
    as the utf8 path does)."""
    return StringTensor(np.char.lower(to_string_tensor(x).numpy()))


def upper(x, use_utf8_encoding=True, name=None) -> StringTensor:
    return StringTensor(np.char.upper(to_string_tensor(x).numpy()))
