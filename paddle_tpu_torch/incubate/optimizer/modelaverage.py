"""``ModelAverage`` (``paddle_tpu.incubate.optimizer.modelaverage``
counterpart): a running sum of the parameters over a window; ``apply()``
puts the average in place of the live weights for its block and restores
them on exit (``need_restore``; ``restore()`` by hand otherwise).

``step()`` (after the optimizer's) adds the weights to the sum; when the
count has reached the window, ``max(min_average_window,
min(max_average_window, int(count * rate) + 1))``, the sum restarts
first, as in the JAX package."""
from __future__ import annotations

import contextlib

import torch

from ...core.tensor import Tensor


class ModelAverage:
    def __init__(self, average_window_rate, parameters=None,
                 min_average_window=10000, max_average_window=10000,
                 name=None):
        self.rate = average_window_rate
        self.min_window = min_average_window
        self.max_window = max_average_window
        self._parameters = [p._value if isinstance(p, Tensor) else p
                            for p in (parameters or [])]
        self._sum = [torch.zeros_like(p) for p in self._parameters]
        self._count = 0
        self._backup = None

    @torch.no_grad()
    def step(self):
        """Add the current weights (call after ``optimizer.step()``)."""
        window = max(self.min_window,
                     min(self.max_window, int(self._count * self.rate) + 1))
        if self._count >= window:
            for s in self._sum:
                s.zero_()
            self._count = 0
        torch._foreach_add_(self._sum, self._parameters)
        self._count += 1

    @contextlib.contextmanager
    def apply(self, executor=None, need_restore=True):
        """The averaged weights in place within the block (nothing changes
        before the first ``step()``)."""
        if self._count == 0:
            yield
            return
        with torch.no_grad():
            self._backup = [p.clone() for p in self._parameters]
            torch._foreach_copy_(self._parameters,
                                 torch._foreach_div(self._sum, self._count))
        try:
            yield
        finally:
            if need_restore:
                self.restore()

    @torch.no_grad()
    def restore(self, executor=None):
        if self._backup is not None:
            torch._foreach_copy_(self._parameters, self._backup)
            self._backup = None
