"""Optimizers (``paddle_tpu.optimizer.optimizer`` counterparts): the
``Optimizer`` base, ``SGD``, ``Momentum``, ``Adam``, ``AdamW``,
``Adagrad``, ``RMSProp``, ``Adadelta``, ``Adamax``, ``Lamb`` and
``LarsMomentum``, and the regularizers ``L1Decay`` / ``L2Decay``.

The update rules follow the JAX package's ``update`` methods literally:
slots start at zero (Adagrad's ``moment`` at ``initial_accumulator_
value``), the step count ``t`` counts from 1, and every optimizer but
AdamW, Lamb and LarsMomentum folds its L2 decay into the gradient (``g +
coeff * p``) first.  Momentum: ``v = momentum * v + g``, then ``p - lr *
v``, or with Nesterov ``p - lr * (g + momentum * v)``.  AdamW decays
decoupled, ``p *= (1 - lr * coeff)``, before the Adam step.  RMSProp's
``velocity`` carries the rate (``v = momentum * v + lr * g / denom``,
``p - v``); Adadelta reads its old ``avg_squared_update`` before it
updates it; Adamax's bias correction divides the rate.  Lamb and
LarsMomentum scale each tensor's step by a ratio of per-tensor norms
(``torch._foreach_norm``, the ``where`` on the device: no host sync):
Lamb's trust ratio ``|p| / |r|`` where both are positive, else 1, with
its own ``lamb_weight_decay`` inside ``r`` (``exclude_from_weight_decay_
fn(param)`` drops it for a parameter); LARS's local rate ``coeff * |p| /
(|g| + wd * |p| + eps)`` where both norms are positive, else 1, with no
decay from the base.  Where JAX returns new arrays, the port updates the
parameters and slots in place with ``torch._foreach_*`` ops over all
parameters at once (a few launches a step instead of ~10 per parameter).

A sparse gradient (``Embedding(sparse=True)``: a torch sparse COO
gradient, ``core.selected_rows``) takes the JAX package's lazy row update
(``update_sparse``): it is merged (``selected_rows.merge_rows``: sorted
unique rows, duplicates summed), the touched rows of the parameter and of
every slot whose first dimension is the table's are gathered
(``index_select``), the optimizer's own rule runs on that slice at the
same ``t`` and the rows are
written back (``index_copy_``): rows never touched keep their values and
slots bit for bit.  With a ``grad_clip`` the sparse gradients are made
dense first, as in the JAX step.  ``Adam``'s ``lazy_mode`` is taken and
ignored, as in the JAX package (every sparse gradient is lazy).

``learning_rate`` is a number or an ``optimizer.lr`` scheduler, whose
``get_lr()`` is read at every update (a host float: no device sync).
``grad_clip`` is an ``nn.clip`` object, applied to the gradients before
the update (the parameters' ``.grad`` stay as they are, as in the JAX
package's eager step).  ``weight_decay`` is a number or a regularizer:
``L2Decay(c)`` is the number ``c``; ``L1Decay(c)`` folds ``c * sign(p)``
into the gradient (the JAX package's base optimizer drops it: ROADMAP
section 3), and is AdamW's decoupled coefficient ``c`` (as the JAX AdamW
reads it).  AdamW's ``lr_ratio(name) -> float`` scales each parameter's
learning rate, decay included (the JAX step's per-parameter
``optimize_attr["learning_rate"]``).

Parameters are named by their state-dict names: pass a module or a
``Layer`` (its ``named_parameters()``) or ``(name, tensor)`` pairs;
surface ``Parameter``s (``layer.parameters()``) and Tensors go by their
``name``, bare torch tensors by ``param_<i>``, until
:func:`name_parameters` (which the train step calls) gives them their
model's names.  The optimizer updates the torch leaves in place.  As in
the JAX package, a parameter's ``optimize_attr["learning_rate"]``
scales its learning rate, its ``regularizer`` replaces the optimizer's
L2 coefficient for it, and ``need_clip=False`` keeps its gradient out of
``grad_clip`` (``nn.ParamAttr``; the fields live on the leaf,
``nn.layer_base.param_attrs``).  ``apply_decay_param_fun``, ``lr_ratio``
and ``state_dict()`` use those names; the slots are the JAX package's:
``moment1`` / ``moment2`` (Adam, AdamW, Lamb), ``velocity`` (Momentum,
LarsMomentum), ``moment`` (Adagrad), ``mean_square`` / ``mean_grad`` /
``velocity`` (RMSProp), ``avg_squared_grad`` / ``avg_squared_update``
(Adadelta), ``moment`` / ``inf_norm`` (Adamax); SGD has none.
"""
from __future__ import annotations

import torch
from torch import nn

from ..core.selected_rows import merge_rows
from ..core.tensor import Tensor
from ..nn.clip import need_clip
from ..nn.layer_base import Parameter, param_attrs
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adagrad",
           "RMSProp", "Adadelta", "Adamax", "Lamb", "LarsMomentum", "L1Decay",
           "L2Decay"]


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
        # sparse (row) gradients are split off before any _foreach call,
        # which rejects them; a clip sees them dense, as in the JAX step
        grads = [p.grad.to_dense() if p.grad.is_sparse and
                 self._grad_clip is not None else p.grad for p in params]
        grads = [g if g.is_sparse else g.to(p.dtype)
                 for g, p in zip(grads, params)]
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
        slots = [self._slots[n] for n, _ in live]
        lrs = [lr * self._lr_scale(n) * _attr_lr(p) for n, p in live]
        decay = [self._decay_coeff(n, p) for n, p in live]
        dense = [i for i, g in enumerate(grads) if not g.is_sparse]
        rows = [i for i, g in enumerate(grads) if g.is_sparse]
        for part, update in ((dense, self._update), (rows, self._update_rows)):
            if part:
                update(*([seq[i] for i in part]
                         for seq in (params, grads, slots, lrs)), t,
                       [decay[i] for i in part])

    def _update_rows(self, params, grads, slots, lrs, t, decay):
        """The lazy row update (the JAX ``update_sparse``): the class's
        own rule on the touched rows of each parameter and of its
        row-shaped slots, written back in place."""
        merged = [merge_rows(g) for g in grads]
        rows = [r for r, _ in merged]

        def rowwise(v, p):
            return v.dim() > 0 and v.shape[0] == p.shape[0]

        sub_p = [p.index_select(0, r) for p, r in zip(params, rows)]
        sub_s = [{k: v.index_select(0, r) if rowwise(v, p) else v
                  for k, v in s.items()}
                 for s, p, r in zip(slots, params, rows)]
        self._update(sub_p, [v.to(p.dtype)
                             for (_, v), p in zip(merged, params)],
                     sub_s, lrs, t, decay)
        for p, r, sp, s, ss in zip(params, rows, sub_p, slots, sub_s):
            p.index_copy_(0, r, sp)
            for k, v in s.items():
                if rowwise(v, p):
                    v.index_copy_(0, r, ss[k])

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
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
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
        # p - lr * mhat / (sqrt(vhat) + eps), in the JAX expression's order:
        # (lr * mhat) / den
        den = torch._foreach_div(v, 1 - b2 ** t)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self._eps)
        upd = torch._foreach_div(m, 1 - b1 ** t)
        torch._foreach_mul_(upd, lrs[0] if len(set(lrs)) == 1 else lrs)
        torch._foreach_div_(upd, den)
        torch._foreach_sub_(params, upd)

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


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)

    def _init_slots(self, p):
        return {}

    def _update(self, params, grads, slots, lrs, t, decay):
        self._descend(params, self._fold_decay(params, grads, decay), lrs)


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._eps = epsilon
        self._init_acc = initial_accumulator_value

    def _init_slots(self, p):
        return {"moment": torch.full_like(p, self._init_acc)}

    def _update(self, params, grads, slots, lrs, t, decay):
        grads = self._fold_decay(params, grads, decay)
        acc = [s["moment"] for s in slots]
        torch._foreach_addcmul_(acc, grads, grads)
        # p - lr * g / (sqrt(acc) + eps)
        den = torch._foreach_sqrt(acc)
        torch._foreach_add_(den, self._eps)
        self._descend(params, torch._foreach_div(grads, den), lrs)


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._rho = rho
        self._eps = epsilon
        self._momentum = momentum
        self._centered = centered

    def _init_slots(self, p):
        return {"mean_square": torch.zeros_like(p),
                "mean_grad": torch.zeros_like(p),
                "velocity": torch.zeros_like(p)}

    def _update(self, params, grads, slots, lrs, t, decay):
        grads = self._fold_decay(params, grads, decay)
        rho = self._rho
        ms = [s["mean_square"] for s in slots]
        torch._foreach_mul_(ms, rho)
        torch._foreach_addcmul_(ms, grads, grads, value=1 - rho)
        if self._centered:
            # sqrt(ms - mg^2 + eps)
            mg = [s["mean_grad"] for s in slots]
            torch._foreach_mul_(mg, rho)
            torch._foreach_add_(mg, grads, alpha=1 - rho)
            den = torch._foreach_sub(ms, torch._foreach_mul(mg, mg))
        else:
            den = torch._foreach_add(ms, 0.0)
        torch._foreach_add_(den, self._eps)
        torch._foreach_sqrt_(den)
        # the velocity carries the rate: v = momentum * v + lr * g / denom
        step = torch._foreach_div(grads, den)
        torch._foreach_mul_(step, lrs)
        v = [s["velocity"] for s in slots]
        torch._foreach_mul_(v, self._momentum)
        torch._foreach_add_(v, step)
        torch._foreach_sub_(params, v)


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._eps = epsilon
        self._rho = rho

    def _init_slots(self, p):
        return {"avg_squared_grad": torch.zeros_like(p),
                "avg_squared_update": torch.zeros_like(p)}

    def _update(self, params, grads, slots, lrs, t, decay):
        grads = self._fold_decay(params, grads, decay)
        rho, eps = self._rho, self._eps
        asg = [s["avg_squared_grad"] for s in slots]
        asu = [s["avg_squared_update"] for s in slots]
        torch._foreach_mul_(asg, rho)
        torch._foreach_addcmul_(asg, grads, grads, value=1 - rho)
        # g * sqrt(old asu + eps) / sqrt(asg + eps), before asu moves
        upd = torch._foreach_add(asu, eps)
        torch._foreach_sqrt_(upd)
        torch._foreach_mul_(upd, grads)
        den = torch._foreach_add(asg, eps)
        torch._foreach_sqrt_(den)
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(asu, rho)
        torch._foreach_addcmul_(asu, upd, upd, value=1 - rho)
        self._descend(params, upd, lrs)


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _init_slots(self, p):
        return {"moment": torch.zeros_like(p),
                "inf_norm": torch.zeros_like(p)}

    def _update(self, params, grads, slots, lrs, t, decay):
        grads = self._fold_decay(params, grads, decay)
        b1 = self._beta1
        m = [s["moment"] for s in slots]
        u = [s["inf_norm"] for s in slots]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, grads, alpha=1 - b1)
        torch._foreach_mul_(u, self._beta2)
        torch._foreach_maximum_(u, torch._foreach_abs(grads))
        # p - lr / (1 - b1^t) * m / (u + eps)
        den = torch._foreach_add(u, self._eps)
        self._descend(params, torch._foreach_div(m, den),
                      [lr / (1 - b1 ** t) for lr in lrs])


def _where_positive(a, b, value):
    """``where(a > 0 & b > 0, value, 1)`` over stacked per-tensor norms,
    on the device, as one 0-d tensor per parameter."""
    return list(torch.where((a > 0) & (b > 0), value,
                            torch.ones_like(value)).unbind())


class Lamb(Optimizer):
    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _init_slots(self, p):
        return {"moment1": torch.zeros_like(p),
                "moment2": torch.zeros_like(p)}

    def _decay_coeff(self, name: str, p=None) -> float:
        if self._exclude_fn is not None and p is not None and \
                self._exclude_fn(Parameter.of(p)):
            return 0.0
        return self._wd

    def _update(self, params, grads, slots, lrs, t, decay):
        b1, b2 = self._beta1, self._beta2
        m = [s["moment1"] for s in slots]
        v = [s["moment2"] for s in slots]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, grads, alpha=1 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, grads, grads, value=1 - b2)
        # r = mhat / (sqrt(vhat) + eps) + decay * p
        den = torch._foreach_div(v, 1 - b2 ** t)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self._eps)
        r = torch._foreach_div(m, 1 - b1 ** t)
        torch._foreach_div_(r, den)
        if any(decay):
            torch._foreach_add_(r, torch._foreach_mul(params, decay))
        w = torch.stack(torch._foreach_norm(params))
        rn = torch.stack(torch._foreach_norm(r))
        trust = _where_positive(w, rn, w / rn)
        torch._foreach_mul_(r, trust)
        self._descend(params, r, lrs)


class LarsMomentum(Momentum):
    """LARS (the JAX package's ``LarsMomentum``): a local rate per tensor,
    no decay from the base (``exclude_from_weight_decay`` is taken and
    ignored, as there)."""

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, grad_clip=None,
                 exclude_from_weight_decay=None, epsilon=0, name=None):
        super().__init__(learning_rate, momentum, parameters, False, None,
                         grad_clip)
        self._lars_coeff = lars_coeff
        self._lars_wd = lars_weight_decay
        self._eps = epsilon

    def _update(self, params, grads, slots, lrs, t, decay):
        wd = self._lars_wd
        w = torch.stack(torch._foreach_norm(params))
        g = torch.stack(torch._foreach_norm(grads))
        local = _where_positive(
            w, g, self._lars_coeff * w / (g + wd * w + self._eps))
        # v = momentum * v + lr * local * (g + wd * p); p - v
        step = torch._foreach_add(grads, params, alpha=wd)
        torch._foreach_mul_(step, local)
        torch._foreach_mul_(step, lrs)
        v = [s["velocity"] for s in slots]
        torch._foreach_mul_(v, self._momentum)
        torch._foreach_add_(v, step)
        torch._foreach_sub_(params, v)
