"""Optimizers (``paddle_tpu.optimizer.optimizer`` counterparts): the
``Optimizer`` base, ``Momentum``, ``Adam`` and ``AdamW``, and the
regularizers ``L1Decay`` / ``L2Decay``.

The update rules follow the JAX package's ``update`` methods literally:
slots start at zero, the step count ``t`` counts from 1, Momentum and Adam
fold their L2 decay into the gradient (``g + coeff * p``) before the
velocity or the moments, and AdamW decays decoupled, ``p *= (1 - lr *
coeff)``, before the Adam step.  Momentum: ``v = momentum * v + g``, then
``p - lr * v``, or with Nesterov ``p - lr * (g + momentum * v)``.  Where
JAX returns new arrays, the port updates the parameters and moments in
place with ``torch._foreach_*`` ops over all parameters at once (a few
launches a step instead of ~10 per parameter).

``learning_rate`` is a number or an ``optimizer.lr`` scheduler, whose
``get_lr()`` is read at every update (a host float: no device sync).
``grad_clip`` is an ``nn.clip`` object, applied to the gradients before
the update (the parameters' ``.grad`` stay as they are, as in the JAX
package's eager step).  ``weight_decay`` is a number or a regularizer:
``L2Decay(c)`` is the number ``c``; ``L1Decay(c)`` folds ``c * sign(p)``
into Momentum's and Adam's gradient (the JAX package's base optimizer
drops it: ROADMAP section 3), and is AdamW's decoupled coefficient ``c``
(as the JAX AdamW reads it).  AdamW's ``lr_ratio(name) -> float`` scales
each parameter's learning rate, decay included (the JAX step's
per-parameter ``optimize_attr["learning_rate"]``).

Parameters are named by their state-dict names: pass a module or a
``Layer`` (its ``named_parameters()``) or ``(name, tensor)`` pairs;
surface ``Parameter``s (``layer.parameters()``) and Tensors go by their
``name``, bare torch tensors by ``param_<i>``, until
:func:`name_parameters` (which the train step calls) gives them their
model's names.  The optimizer updates the torch leaves in place.  As in
the JAX package, a parameter's ``optimize_attr["learning_rate"]``
scales its learning rate, its ``regularizer`` replaces the optimizer's
L2 coefficient for it (Momentum, Adam), and ``need_clip=False`` keeps
its gradient out of ``grad_clip`` (``nn.ParamAttr``; the fields live on
the leaf, ``nn.layer_base.param_attrs``).  ``apply_decay_param_fun``,
``lr_ratio`` and ``state_dict()`` use those names; the slots are
``moment1`` / ``moment2`` (Adam, AdamW) and ``velocity`` (Momentum), as in
the JAX package.
"""
from __future__ import annotations

import torch
from torch import nn

from ..core.tensor import Tensor
from ..nn.clip import need_clip
from ..nn.layer_base import param_attrs
from .lr import LRScheduler

__all__ = ["Optimizer", "Momentum", "Adam", "AdamW", "L1Decay", "L2Decay"]


class L2Decay:
    """``paddle.regularizer.L2Decay``: ``g + coeff * p``."""

    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)


class L1Decay:
    """``paddle.regularizer.L1Decay``: ``g + coeff * sign(p)``."""

    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)


_SPECIAL = ("LR_Scheduler", "master_weights", "step_count")


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None):
        if not isinstance(learning_rate, (int, float, LRScheduler)):
            raise TypeError(f"learning_rate must be a number or an "
                            f"optimizer.lr scheduler, got "
                            f"{type(learning_rate).__name__}")
        if weight_decay is not None and not isinstance(
                weight_decay, (int, float, L1Decay, L2Decay)):
            raise TypeError(f"weight_decay must be a number, L1Decay or "
                            f"L2Decay, got {type(weight_decay).__name__}")
        self._lr = learning_rate
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._names, self._parameters = self._collect(parameters)
        self._slots: dict[str, dict[str, torch.Tensor]] = {}
        self._step_count = 0

    @staticmethod
    def _collect(parameters):
        if parameters is None:
            return [], []
        if isinstance(parameters, nn.Module):
            parameters = parameters.named_parameters()
        items = []
        for item in parameters:
            # a paddle parameter group {"params": [...], ...}
            items.extend(item["params"] if isinstance(item, dict)
                         else [item])
        names, params = [], []
        for i, item in enumerate(items):
            name, p = item if isinstance(item, tuple) else (None, item)
            if isinstance(p, Tensor):
                name, p = name or p.name, p._value
            name = name or f"param_{i}"
            if name in names:       # slots are kept by name: keep it unique
                name = f"{name}_{i}"
            names.append(name)
            params.append(p)
        return names, params

    def name_parameters(self, model: nn.Module) -> None:
        """Give each parameter that belongs to ``model`` its state-dict
        name there (the names ``apply_decay_param_fun`` and
        ``state_dict()`` use)."""
        by_id = {id(p): n for n, p in nn.Module.named_parameters(model)}
        if self._slots:
            raise RuntimeError("name the parameters before the first step")
        self._names = [by_id.get(id(p), n)
                       for n, p in zip(self._names, self._parameters)]

    # -- lr -------------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return float(self._lr())
        return float(self._lr)

    def set_lr(self, value: float):
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._lr = float(value)

    def set_lr_scheduler(self, scheduler: LRScheduler):
        self._lr = scheduler

    # -- the update (per optimizer) -----------------------------------------
    def _decay_coeff(self, name: str, p=None) -> float:
        """The L2 coefficient folded into the gradient (the parameter's
        own regularizer first)."""
        wd = self._weight_decay
        attrs = None if p is None else param_attrs(p)
        if attrs is not None and attrs["regularizer"] is not None:
            wd = attrs["regularizer"]
        if isinstance(wd, L2Decay):
            return wd.coeff
        return float(wd) if isinstance(wd, (int, float)) else 0.0

    def _lr_scale(self, name: str) -> float:
        return 1.0

    def _init_slots(self, p) -> dict:
        raise NotImplementedError

    def _update(self, params, grads, slots, lrs, t, decay):
        raise NotImplementedError

    def _fold_decay(self, params, grads, decay):
        """The regularizer folded into the gradient: ``g + coeff * p``
        (L2) or ``g + coeff * sign(p)`` (L1)."""
        if isinstance(self._weight_decay, L1Decay):
            c = self._weight_decay.coeff
            return torch._foreach_add(
                grads, [torch.sign(p) for p in params], alpha=c) if c \
                else grads
        if not any(decay):
            return grads
        return torch._foreach_add(grads, torch._foreach_mul(params, decay))

    @staticmethod
    def _descend(params, upd, lrs):
        """``p -= lr_i * upd_i``."""
        if len(set(lrs)) == 1:
            torch._foreach_add_(params, upd, alpha=-lrs[0])
        else:
            torch._foreach_add_(params, torch._foreach_mul(
                upd, [-lr for lr in lrs]))

    @torch.no_grad()
    def step(self):
        """One update of every parameter that has a gradient."""
        self._step_count += 1
        self._apply(self._step_count)

    def _apply(self, t, clip_in_place=False):
        """Clip and update the parameters that have a gradient, at step
        ``t`` and the scheduler's current rate.  ``clip_in_place`` lets the
        clip scale the gradients themselves (the train step's own, which
        it clears next step) instead of copies."""
        live = [(n, p) for n, p in zip(self._names, self._parameters)
                if p.requires_grad and p.grad is not None]
        if not live:
            return
        for n, p in live:
            if n not in self._slots:
                self._slots[n] = self._init_slots(p)
        params = [p for _, p in live]
        grads = [p.grad.to(p.dtype) for p in params]
        if self._grad_clip is not None:
            clip = [i for i, p in enumerate(params) if need_clip(p)]
            if len(clip) == len(grads):
                grads = self._grad_clip.clip_list(grads,
                                                  in_place=clip_in_place)
            elif clip:
                done = self._grad_clip.clip_list(
                    [grads[i] for i in clip], in_place=clip_in_place)
                for i, g in zip(clip, done):
                    grads[i] = g
        lr = self.get_lr()
        self._update(params, grads, [self._slots[n] for n, _ in live],
                     [lr * self._lr_scale(n) * _attr_lr(p) for n, p in live],
                     t, [self._decay_coeff(n, p) for n, p in live])

    def clear_grad(self):
        for p in self._parameters:
            p.grad = None

    clear_gradients = clear_grad

    # -- state --------------------------------------------------------------
    def slots_of(self, name: str, p) -> dict:
        """The slots of parameter ``name`` (zeros before its first
        update, as the JAX train state starts them)."""
        return self._slots.get(name) or self._init_slots(p)

    def state_dict(self) -> dict:
        """``{"LR_Scheduler", "master_weights", "step_count"}`` and one
        ``<name>_<slot>`` entry per slot: the live slot tensors, as
        ``torch.optim`` hands them out."""
        sd = {"LR_Scheduler": (self._lr.state_dict()
                               if isinstance(self._lr, LRScheduler) else {}),
              "master_weights": {}, "step_count": self._step_count}
        for n in self._names:
            for k, v in self._slots.get(n, {}).items():
                sd[f"{n}_{k}"] = v
        return sd

    @torch.no_grad()
    def set_state_dict(self, state_dict):
        """Restore :meth:`state_dict`: the step count, the scheduler's
        state and every slot, matched all by parameter name or, when the
        names are another model's (a fresh model's generated names) and
        the counts agree, all by position, the JAX optimizer's rule (a
        slot entry that fits neither raises ``KeyError``; a shape that
        does not fit raises ``ValueError``)."""
        sc = state_dict.get("step_count", 0)
        self._step_count = int(sc.item() if torch.is_tensor(sc) else sc)
        if isinstance(self._lr, LRScheduler) and \
                state_dict.get("LR_Scheduler"):
            self._lr.set_state_dict(state_dict["LR_Scheduler"])
        if not self._parameters:
            return
        params = dict(zip(self._names, self._parameters))
        slot_names = set(self._init_slots(torch.zeros(1)))
        by_prefix: dict = {}
        for key, v in state_dict.items():
            if key in _SPECIAL:
                continue
            sn = next((s for s in slot_names if key.endswith(f"_{s}")), None)
            if sn is None:
                raise KeyError(f"optimizer state entry {key!r} names no "
                               f"slot of this optimizer")
            by_prefix.setdefault(key[:-len(sn) - 1], {})[sn] = v
        # EITHER all by name OR all by position: mixing the two could pair
        # shifted generated names with the wrong parameter's slots
        if all(n in params for n in by_prefix):
            found = by_prefix
        elif len(by_prefix) == len(self._names):
            found = dict(zip(self._names, by_prefix.values()))
        else:
            bad = next(n for n in by_prefix if n not in params)
            raise KeyError(f"optimizer state entry {bad!r} names no "
                           f"parameter of this optimizer")
        for name, src in found.items():
            p = params[name]
            slots = self._init_slots(p)
            for k, dst in slots.items():
                if k not in src:
                    continue
                v = torch.as_tensor(src[k])
                if tuple(v.shape) != tuple(dst.shape):
                    raise ValueError(f"{name}_{k}: shape {tuple(v.shape)} "
                                     f"does not fit {tuple(dst.shape)}")
                dst.copy_(v)
            self._slots[name] = slots


def _attr_lr(p) -> float:
    """The parameter's ``optimize_attr["learning_rate"]`` (1 unset)."""
    attrs = param_attrs(p)
    return 1.0 if attrs is None else float(
        attrs["optimize_attr"].get("learning_rate", 1.0))


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _init_slots(self, p):
        return {"velocity": torch.zeros_like(p)}

    def _update(self, params, grads, slots, lrs, t, decay):
        grads = self._fold_decay(params, grads, decay)
        v = [s["velocity"] for s in slots]
        torch._foreach_mul_(v, self._momentum)
        torch._foreach_add_(v, grads)
        if self._nesterov:
            # p - lr * (g + momentum * v)
            self._descend(params, torch._foreach_add(
                grads, v, alpha=self._momentum), lrs)
        else:
            self._descend(params, v, lrs)


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1 = beta1
        self._beta2 = beta2
        self._eps = epsilon

    def _init_slots(self, p):
        return {"moment1": torch.zeros_like(p),
                "moment2": torch.zeros_like(p)}

    def _adam(self, params, grads, slots, lrs, t):
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
        self._descend(params, upd, lrs)

    def _update(self, params, grads, slots, lrs, t, decay):
        # the regularizer folded into the gradient (Adam, not AdamW)
        self._adam(params, self._fold_decay(params, grads, decay), slots,
                   lrs, t)


class AdamW(Adam):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip)
        if not isinstance(weight_decay, (int, float, L1Decay, L2Decay)):
            raise TypeError(f"weight_decay must be a number, L1Decay or "
                            f"L2Decay, got {type(weight_decay).__name__}")
        self._wd = float(getattr(weight_decay, "coeff", weight_decay))
        self._lr_ratio = lr_ratio
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decay_coeff(self, name: str, p=None) -> float:
        if self._apply_decay_param_fun is not None and \
                not self._apply_decay_param_fun(name):
            return 0.0
        return self._wd

    def _lr_scale(self, name: str) -> float:
        return 1.0 if self._lr_ratio is None else float(self._lr_ratio(name))

    def _update(self, params, grads, slots, lrs, t, decay):
        # decoupled weight decay first (reference adamw kernel:
        # p *= (1 - lr * coeff)), then the Adam step
        torch._foreach_mul_(params, [1.0 - lr * c
                                     for lr, c in zip(lrs, decay)])
        self._adam(params, grads, slots, lrs, t)
