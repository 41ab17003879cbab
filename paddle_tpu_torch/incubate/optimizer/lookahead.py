"""``LookAhead`` (``paddle_tpu.incubate.optimizer.lookahead``
counterpart): every ``k`` steps of the inner optimizer the slow weights
move ``alpha`` of the way to the fast ones (``slow += alpha * (fast -
slow)``) and the fast weights are set to them.  The slow weights start
at the fast weights as they are at construction, so the first sync
interpolates back toward the start.  ``state_dict`` is the inner
optimizer's with ``@lookahead_step``."""
from __future__ import annotations

import torch

from ...optimizer.optimizer import Optimizer


class LookAhead(Optimizer):
    def __init__(self, inner_optimizer, alpha=0.5, k=5, name=None):
        if not isinstance(inner_optimizer, Optimizer):
            raise TypeError("inner_optimizer must be an Optimizer")
        self.inner_optimizer = inner_optimizer
        self.alpha = float(alpha)
        self.k = int(k)
        self._parameters = inner_optimizer._parameters
        self._grad_clip = None
        self._slow = [p.detach().clone() for p in self._parameters]
        self._lookahead_step = 0
        self._step_count = 0
        self._lr = inner_optimizer._lr

    @torch.no_grad()
    def step(self):
        self.inner_optimizer.step()
        self._step_count = self.inner_optimizer._step_count
        self._lookahead_step += 1
        if self._lookahead_step % self.k == 0:
            torch._foreach_add_(self._slow, torch._foreach_sub(
                self._parameters, self._slow), alpha=self.alpha)
            torch._foreach_copy_(self._parameters, self._slow)

    def clear_grad(self, set_to_zero=True):
        self.inner_optimizer.clear_grad()

    clear_gradients = clear_grad

    def get_lr(self):
        return self.inner_optimizer.get_lr()

    def set_lr(self, lr):
        return self.inner_optimizer.set_lr(lr)

    def minimize(self, loss, *a, **kw):
        loss.backward()
        self.step()
        self.clear_grad()
        return None, None

    def state_dict(self):
        sd = self.inner_optimizer.state_dict()
        sd["@lookahead_step"] = self._lookahead_step
        return sd

    def set_state_dict(self, sd):
        self._lookahead_step = int(sd.pop("@lookahead_step", 0)) \
            if isinstance(sd, dict) else 0
        self.inner_optimizer.set_state_dict(sd)
