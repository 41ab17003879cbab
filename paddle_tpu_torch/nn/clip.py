"""Gradient clipping (``paddle_tpu.nn.clip`` counterparts):
``ClipGradByValue``, ``ClipGradByNorm``, ``ClipGradByGlobalNorm`` and
``clip_grad_norm_``.

A clip object is called on ``[(param, grad), ...]`` and returns the pairs
with clipped copies of the gradients (``None``, and the gradient of a
parameter whose ``need_clip`` is False, pass through and stay out of the
global norm), as the JAX package's clips return new arrays;
``clip_list(grads, in_place=True)``
scales a list of gradients in place, which is how the train step and the
optimizers apply it.  Norms come from ``torch._foreach_norm`` and scales
from ``torch._foreach_mul_``; every coefficient stays a device tensor, so
clipping never waits for the device.

``ClipGradByGlobalNorm`` sums the squares in f32 whatever the gradients'
type, and scales by ``clip_norm / max(gn, clip_norm)``: the JAX eager
clip's form, equal in floating point to its train step's ``min(1,
clip_norm / max(gn, 1e-12))`` (both are exactly 1 while ``gn <=
clip_norm`` and the same quotient past it).  The scale is f32.  f32
gradients are multiplied by it as they are; the product for a gradient of
another type (bf16) takes the scale rounded to that type, because
torch's foreach kernels read a scalar tensor in the list's own type: within
one bf16 rounding of the JAX step's f32 product, cast back.
"""
from __future__ import annotations

import torch

from ..core.tensor import Tensor
from .layer_base import param_attrs

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "clip_grad_norm_"]


def need_clip(p) -> bool:
    """The parameter's ``need_clip`` (a surface ``Parameter`` or its torch
    leaf; True unless set False through ``ParamAttr``)."""
    if isinstance(p, Tensor):
        p = p._value
    attrs = param_attrs(p)
    return True if attrs is None else bool(attrs["need_clip"])


class ClipGradBase:
    def __call__(self, params_grads):
        """``[(param, grad)]`` with the gradients of the parameters that
        need clipping clipped (copies); the others, and None, pass
        through."""
        grads = [g._value if isinstance(g, Tensor) else g
                 for p, g in params_grads if g is not None and need_clip(p)]
        clipped = iter(self.clip_list(grads, in_place=False))

        def back(g):
            out = next(clipped)
            return Tensor._wrap(out) if isinstance(g, Tensor) else out
        return [(p, back(g) if g is not None and need_clip(p) else g)
                for p, g in params_grads]

    def clip_list(self, grads, in_place=False):
        """The clipped gradients (``grads`` themselves, scaled in place,
        with ``in_place``)."""
        if not grads:
            return grads
        if not in_place:
            grads = [g.clone() for g in grads]
        self._clip_(grads)
        return grads

    def _clip_(self, grads):
        raise NotImplementedError


def _scale_(grads, scale):
    """``g *= scale`` for every gradient: one foreach call a dtype, the
    device scalar ``scale`` in the gradients' type."""
    by_dtype: dict = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for dtype, group in by_dtype.items():
        torch._foreach_mul_(group, scale.to(dtype))


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):  # noqa: A002
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _clip_(self, grads):
        torch._foreach_clamp_min_(grads, self.min)
        torch._foreach_clamp_max_(grads, self.max)


class ClipGradByNorm(ClipGradBase):
    """Each gradient on its own: ``g * min(clip_norm / max(|g|, 1e-12),
    1)``, the norm in the gradient's type."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip_(self, grads):
        norms = torch._foreach_norm(grads)
        torch._foreach_mul_(grads, [
            (self.clip_norm / n.clamp(min=1e-12)).clamp(max=1.0)
            for n in norms])


def global_norm(grads) -> torch.Tensor:
    """``sqrt(sum(g^2))`` over all ``grads``, in f32 on their device."""
    norms = torch._foreach_norm(grads, 2.0, dtype=torch.float32)
    return torch.linalg.vector_norm(torch.stack(norms))


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _clip_(self, grads):
        gn = global_norm(grads)
        _scale_(grads, self.clip_norm / gn.clamp(min=self.clip_norm))


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale the parameters' gradients (torch leaves or surface
    Parameters) in place by ``min(max_norm / (total + 1e-6), 1)`` and
    return ``total`` (a Tensor for surface parameters), the ``norm_type``
    norm of all of them (``inf``: the largest magnitude).
    ``error_if_nonfinite`` reads ``total`` on the host (one sync) and
    raises if it is not finite."""
    surface = isinstance(parameters, Tensor) or (
        not torch.is_tensor(parameters) and any(
            isinstance(p, Tensor) for p in parameters))
    params = [parameters] if torch.is_tensor(parameters) or \
        isinstance(parameters, Tensor) else list(parameters)
    params = [p._value if isinstance(p, Tensor) else p for p in params]
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        total = torch.zeros(())
        return Tensor._wrap(total) if surface else total
    norm_type = float(norm_type)
    total = torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(grads, norm_type)), norm_type)
    if error_if_nonfinite and not bool(torch.isfinite(total)):
        raise RuntimeError(f"the total {norm_type} norm of the gradients is "
                           f"{float(total)}: not finite")
    _scale_(grads, (max_norm / (total + 1e-6)).clamp(max=1.0))
    return Tensor._wrap(total) if surface else total
