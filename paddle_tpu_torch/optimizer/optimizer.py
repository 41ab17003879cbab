"""Optimizers (``paddle_tpu.optimizer.optimizer`` counterparts): the
``Optimizer`` base, ``Adam`` and ``AdamW``.

The update rules follow the JAX package's ``Adam.update`` and
``AdamW.update`` literally: moments start at zero, the step count ``t``
counts from 1, Adam folds its L2 decay into the gradient, and AdamW
decays decoupled, ``p *= (1 - lr * coeff)``, before the Adam step.  Where
JAX returns new arrays, the port updates the parameters and moments in
place with ``torch._foreach_*`` ops over all parameters at once (a few
launches a step instead of ~10 per parameter).

Parameters are named by their state-dict names: pass a module (its
``named_parameters()``) or ``(name, tensor)`` pairs; bare tensors are
named ``param_<i>`` until :func:`name_parameters` (which the train step
calls) gives them their model's names.  ``apply_decay_param_fun``
receives those names.  A learning-rate scheduler and gradient clipping are
not ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch
from torch import nn

__all__ = ["Optimizer", "Adam", "AdamW"]


def _unported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP module "
                               f"item {item})")


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None):
        if not isinstance(learning_rate, (int, float)):
            raise _unported("a learning-rate scheduler (optimizer/lr.py)",
                            "5")
        if grad_clip is not None:
            raise _unported("gradient clipping (nn/clip.py)", "5")
        if weight_decay is not None and \
                not isinstance(weight_decay, (int, float)):
            raise _unported("a regularizer object as weight_decay", "5")
        self._lr = float(learning_rate)
        self._weight_decay = weight_decay
        self._names, self._parameters = self._collect(parameters)
        self._slots: dict[str, dict[str, torch.Tensor]] = {}
        self._step_count = 0

    @staticmethod
    def _collect(parameters):
        if parameters is None:
            return [], []
        if isinstance(parameters, nn.Module):
            parameters = parameters.named_parameters()
        names, params = [], []
        for i, item in enumerate(parameters):
            name, p = item if isinstance(item, tuple) else (f"param_{i}",
                                                            item)
            names.append(name)
            params.append(p)
        return names, params

    def name_parameters(self, model: nn.Module) -> None:
        """Give each parameter that belongs to ``model`` its state-dict
        name there (the names ``apply_decay_param_fun`` and
        ``state_dict()`` use)."""
        by_id = {id(p): n for n, p in model.named_parameters()}
        if self._slots:
            raise RuntimeError("name the parameters before the first step")
        self._names = [by_id.get(id(p), n)
                       for n, p in zip(self._names, self._parameters)]

    # -- the update (per optimizer) -----------------------------------------
    def _decay_coeff(self, name: str) -> float:
        return float(self._weight_decay or 0.0)

    def _update(self, params, grads, slots, lr, t, decay):
        raise NotImplementedError

    @torch.no_grad()
    def step(self):
        """One update of every parameter that has a gradient."""
        self._step_count += 1
        live = [(n, p) for n, p in zip(self._names, self._parameters)
                if p.requires_grad and p.grad is not None]
        if not live:
            return
        for n, p in live:
            if n not in self._slots:
                self._slots[n] = {"moment1": torch.zeros_like(p),
                                  "moment2": torch.zeros_like(p)}
        params = [p for _, p in live]
        grads = [p.grad.to(p.dtype) for p in params]
        slots = [self._slots[n] for n, _ in live]
        self._update(params, grads, slots, self._lr, self._step_count,
                     [self._decay_coeff(n) for n, _ in live])

    def clear_grad(self):
        for p in self._parameters:
            p.grad = None

    # -- state --------------------------------------------------------------
    def state_dict(self) -> dict:
        sd = {"LR_Scheduler": {}, "master_weights": {},
              "step_count": self._step_count}
        for n in self._names:
            for k, v in self._slots.get(n, {}).items():
                sd[f"{n}_{k}"] = v
        return sd


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1 = beta1
        self._beta2 = beta2
        self._eps = epsilon

    def _adam(self, params, grads, slots, lr, t):
        b1, b2 = self._beta1, self._beta2
        m = [s["moment1"] for s in slots]
        v = [s["moment2"] for s in slots]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, grads, alpha=1 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, grads, grads, value=1 - b2)
        # p - lr * mhat / (sqrt(vhat) + eps)
        den = torch._foreach_div(v, 1 - b2 ** t)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self._eps)
        upd = torch._foreach_div(m, 1 - b1 ** t)
        torch._foreach_div_(upd, den)
        torch._foreach_add_(params, upd, alpha=-lr)

    def _update(self, params, grads, slots, lr, t, decay):
        if any(decay):
            # L2 regularisation folded into the gradient (Adam, not AdamW)
            grads = torch._foreach_add(
                grads, torch._foreach_mul(params, decay))
        self._adam(params, grads, slots, lr, t)


class AdamW(Adam):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None):
        if lr_ratio is not None:
            raise _unported("AdamW lr_ratio", "5")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip)
        if not isinstance(weight_decay, (int, float)):
            raise _unported("a regularizer object as weight_decay", "5")
        self._wd = float(weight_decay)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decay_coeff(self, name: str) -> float:
        if self._apply_decay_param_fun is not None and \
                not self._apply_decay_param_fun(name):
            return 0.0
        return self._wd

    def _update(self, params, grads, slots, lr, t, decay):
        # decoupled weight decay first (reference adamw kernel:
        # p *= (1 - lr * coeff)), then the Adam step
        torch._foreach_mul_(params, [1.0 - lr * c for c in decay])
        self._adam(params, grads, slots, lr, t)
