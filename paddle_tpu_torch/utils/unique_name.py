"""``paddle_tpu.utils.unique_name`` counterpart: ``generate``,
``switch`` and ``guard`` over one process-wide generator of unique names
(``key_0``, ``key_1``, ...; with a prefix, ``prefixkey_0``)."""
from __future__ import annotations

import contextlib
from collections import defaultdict

__all__ = ["generate", "guard", "switch"]


class _Generator:
    def __init__(self):
        self.ids = defaultdict(int)
        self.prefix = ""

    def __call__(self, key):
        n = self.ids[key]
        self.ids[key] += 1
        return "_".join([self.prefix + key, str(n)]) if self.prefix \
            else f"{key}_{n}"


_generator = _Generator()


def generate(key):
    return _generator(key)


def switch(new_generator=None):
    global _generator
    old = _generator
    _generator = new_generator or _Generator()
    return old


@contextlib.contextmanager
def guard(new_generator=None):
    if isinstance(new_generator, str):
        g = _Generator()
        g.prefix = new_generator
        new_generator = g
    old = switch(new_generator)
    try:
        yield
    finally:
        switch(old)
