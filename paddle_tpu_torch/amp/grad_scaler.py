"""``GradScaler``: dynamic loss scaling (``paddle_tpu.amp.grad_scaler``
counterpart), with the JAX package's rules.

``scale`` multiplies the loss by the scale.  ``unscale_(opt)`` divides
every gradient of the optimizer's parameters by it in place, once per
step (a second call before ``step`` does nothing), and reads whether all
of them are finite with one device-to-host read (their largest
magnitudes, one multi-tensor norm).  ``step`` skips the update on a
non-finite gradient and calls ``update``: ``decr_every_n_nan_or_inf``
non-finite steps in a row multiply the scale by ``decr_ratio`` (not below
1), ``incr_every_n_steps`` finite steps in a row by ``incr_ratio``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import Tensor

__all__ = ["GradScaler", "AmpScaler"]


def _leaves(optimizer):
    return [p._value if isinstance(p, Tensor) else p
            for p in optimizer._parameters]


class GradScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled: set[int] = set()  # optimizers unscaled this step

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self):
        return Tensor(np.float32(self._scale))

    def set_init_loss_scaling(self, value):
        self._scale = float(value)

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    def unscale_(self, optimizer):
        if not self._enable or id(optimizer) in self._unscaled:
            return
        self._unscaled.add(id(optimizer))
        grads = [p.grad for p in _leaves(optimizer) if p.grad is not None]
        if not grads:
            self._found_inf = False
            return
        with torch.no_grad():
            torch._foreach_mul_(grads, 1.0 / self._scale)
            # the largest magnitude of each gradient is finite iff all its
            # entries are: one read for the whole parameter set
            peaks = torch._foreach_norm(grads, float("inf"))
            finite = torch.isfinite(torch.stack(
                [t.float() for t in peaks])).all()
        self._found_inf = not bool(finite)

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self.update()
        self._unscaled.discard(id(optimizer))

    def minimize(self, optimizer, scaled_loss):
        self.step(optimizer)

    def update(self):
        if not (self._enable and self._dynamic):
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_count": self._good_steps,
                "decr_count": self._bad_steps}

    def load_state_dict(self, state):
        self._scale = state.get("scale", self._scale)
        self._good_steps = state.get("incr_count", 0)
        self._bad_steps = state.get("decr_count", 0)


AmpScaler = GradScaler
