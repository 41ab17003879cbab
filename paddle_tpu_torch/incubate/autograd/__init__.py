"""``paddle_tpu.incubate.autograd`` counterpart: ``jvp``, ``vjp``,
``Jacobian``, ``Hessian``, ``forward_grad``, ``grad`` and the prim
switch, over ``torch.func``.

A function of the port's Tensors is made pure as in the JAX package: its
raw torch arguments are wrapped into Tensors, and its Tensor results
unwrapped (``_pure``).  ``torch.func`` traces it on the arguments'
device.  A function ``torch.func`` cannot trace (one that reads a value
back with ``.item()``, goes through numpy, or calls a torch op without a
functorch rule) falls back to ``torch.autograd.functional`` with
``create_graph``, which runs the function on real tensors.  Results are
tape-free Tensors.  ``Jacobian(is_batched=True)`` takes the full
Jacobian and keeps its diagonal blocks, as the JAX package does; a
batched ``Hessian`` maps the one-sample Hessian over the batch
(``vmap``).

The prim switch keeps a flag for the API (the JAX package's does the
same): torch's autograd needs no lowering to primitives.
"""
from __future__ import annotations

import torch
from torch.autograd import functional as AF

from ...core.tensor import Tensor

__all__ = ["jvp", "vjp", "Jacobian", "Hessian", "forward_grad", "grad",
           "enable_prim", "disable_prim", "prim_enabled"]


def _unwrap(x):
    if isinstance(x, Tensor):
        return x._value
    if isinstance(x, (list, tuple)):
        return type(x)(_unwrap(v) for v in x)
    return torch.as_tensor(x)


def _wrap(v):
    if isinstance(v, (list, tuple)):
        return type(v)(_wrap(u) for u in v)
    return Tensor._wrap(v.detach())


def _pure(func):
    def fn(*raw):
        return _unwrap(func(*[Tensor._wrap(r) for r in raw]))
    return fn


def _traced(run_func, run_autograd):
    """``run_func()`` (``torch.func``), or ``run_autograd()`` where the
    function cannot be traced."""
    try:
        return run_func()
    except (RuntimeError, TypeError, NotImplementedError):
        return run_autograd()


def _inputs(xs):
    xs = xs if isinstance(xs, (list, tuple)) else [xs]
    return [_unwrap(x).detach() for x in xs]


def jvp(func, xs, v=None):
    """Forward mode: ``(outputs, the product of the Jacobian and v)``."""
    raw = _inputs(xs)
    if v is None:
        tangents = [torch.ones_like(r) for r in raw]
    else:
        tangents = _inputs(v)
    fn = _pure(func)
    out, tangent_out = _traced(
        lambda: torch.func.jvp(fn, tuple(raw), tuple(tangents)),
        lambda: AF.jvp(fn, tuple(raw), tuple(tangents), create_graph=True))
    return _wrap(out), _wrap(tangent_out)


def _ones_like_tree(out):
    if isinstance(out, (list, tuple)):
        return type(out)(_ones_like_tree(o) for o in out)
    return torch.ones_like(out)


def vjp(func, xs, v=None):
    """Reverse mode: ``(outputs, the product of v and the Jacobian)``."""
    raw = _inputs(xs)
    fn = _pure(func)

    def by_func():
        out, vjp_fn = torch.func.vjp(fn, *raw)
        cot = _ones_like_tree(out) if v is None else _unwrap(v)
        return out, vjp_fn(cot)

    def by_autograd():
        out = fn(*raw)
        cot = _ones_like_tree(out) if v is None else _unwrap(v)
        return AF.vjp(fn, tuple(raw), cot, create_graph=True)

    out, grads = _traced(by_func, by_autograd)
    grads = grads[0] if len(grads) == 1 else list(grads)
    return _wrap(out), _wrap(grads)


def _take_diag(j):
    """``[B, out..., B, in...]`` -> ``[B, out..., in...]``: sample ``i``'s
    block of the full Jacobian, indexed as the JAX package indexes it."""
    b = j.shape[0]
    return torch.stack([j[i].reshape(-1, *j.shape[2:])[:, i]
                        for i in range(b)])


class Jacobian:
    """``J[i, j]`` of a function of one or more inputs, computed at first
    use (``torch.func.jacrev``)."""

    def __init__(self, func, xs, is_batched=False):
        self._func = func
        self._xs = xs if isinstance(xs, (list, tuple)) else [xs]
        self._is_batched = is_batched
        self._mat = None

    def _compute(self):
        if self._mat is None:
            raw = _inputs(self._xs)
            fn = _pure(self._func)
            argnums = tuple(range(len(raw)))
            jac = _traced(
                lambda: torch.func.jacrev(fn, argnums=argnums)(*raw),
                lambda: AF.jacobian(fn, tuple(raw), create_graph=True))
            jac = jac[0] if len(raw) == 1 else tuple(jac)
            if self._is_batched:
                jac = (_take_diag(jac) if isinstance(jac, torch.Tensor)
                       else tuple(_take_diag(j) for j in jac))
            self._mat = _wrap(jac)
        return self._mat

    def __getitem__(self, idx):
        m = self._compute()
        if isinstance(m, Tensor):
            return m[idx]
        return [t[idx] for t in m]

    @property
    def shape(self):
        m = self._compute()
        return m.shape if isinstance(m, Tensor) else [t.shape for t in m]

    def numpy(self):
        m = self._compute()
        return m.numpy() if isinstance(m, Tensor) else m


class Hessian:
    """The Hessian of a function with a scalar output; ``is_batched``
    takes the leading dim as a batch of independent samples (``[B, N]``
    in, one scalar a sample out -> ``[B, N, N]``)."""

    def __init__(self, func, xs, is_batched=False):
        self._func = func
        self._xs = xs if isinstance(xs, (list, tuple)) else [xs]
        self._is_batched = is_batched
        self._mat = None

    def _compute(self):
        if self._mat is None:
            raw = _inputs(self._xs)
            fn = _pure(self._func)
            if self._is_batched:
                if len(raw) != 1:
                    raise ValueError("batched Hessian supports one input")

                def single(row):
                    return fn(row[None]).reshape(-1)[0]

                def by_autograd():
                    return torch.stack([AF.hessian(single, r,
                                                   create_graph=True)
                                        for r in raw[0]])

                hess = _traced(
                    lambda: torch.func.vmap(torch.func.hessian(single))(
                        raw[0]), by_autograd)
            else:
                def scalar(*a):
                    return fn(*a).reshape(())

                argnums = tuple(range(len(raw)))
                hess = _traced(
                    lambda: torch.func.hessian(scalar, argnums=argnums)(
                        *raw),
                    lambda: AF.hessian(scalar, tuple(raw),
                                       create_graph=True))
                hess = hess[0][0] if len(raw) == 1 else tuple(
                    tuple(h) for h in hess)
            self._mat = _wrap(hess)
        return self._mat

    def __getitem__(self, idx):
        return self._compute()[idx]

    @property
    def shape(self):
        m = self._compute()
        return m.shape if isinstance(m, Tensor) else None

    def numpy(self):
        return self._compute().numpy()


def forward_grad(outputs_fn, xs, v=None):
    """The forward-mode gradient of ``outputs_fn`` at ``xs``."""
    _, tangent = jvp(outputs_fn, xs, v)
    return tangent


def grad(func, xs, v=None):
    """The reverse-mode gradient of ``func`` at ``xs``."""
    _, g = vjp(func, xs, v)
    return g


# the prim switch: a flag for the API and for reporting
_prim_enabled = [False]


def enable_prim():
    _prim_enabled[0] = True


def disable_prim():
    _prim_enabled[0] = False


def prim_enabled() -> bool:
    return _prim_enabled[0]
