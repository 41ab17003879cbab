"""``paddle.nn.utils`` (``paddle_tpu.nn.utils`` counterpart):
``weight_norm`` / ``remove_weight_norm``, ``spectral_norm``,
``clip_grad_norm_`` / ``clip_grad_value_``, ``parameters_to_vector`` /
``vector_to_parameters``.

The two reparametrizations rebuild the layer's weight in a forward
pre-hook from the parameters that replace it (``<name>_g`` and
``<name>_v``; ``<name>_orig``), with torch ops, so those parameters get
the gradients.  The rebuilt tensor is the layer's ``<name>`` attribute (a
surface Tensor in its ``__dict__``), which the port's layers read through
``layer_base.param``.  ``spectral_norm``'s power-iteration vectors start
from ``numpy.random.RandomState(0)``, as in the JAX package, and are
state outside the state dict.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import Tensor
from .layer_base import Parameter

__all__ = ["weight_norm", "remove_weight_norm", "spectral_norm",
           "clip_grad_norm_", "clip_grad_value_", "parameters_to_vector",
           "vector_to_parameters"]


def _leaf(p):
    return p._value if isinstance(p, Tensor) else p


def _take(layer, name):
    """Unregister parameter ``name``; returns its Parameter."""
    w = getattr(layer, name)
    del layer._parameters[name]
    layer.__dict__.get("_pd_params", {}).pop(name, None)
    layer.__dict__.pop(name, None)
    return w


def _norm_except(v, dim):
    axes = [i for i in range(v.ndim) if i != dim]
    return torch.sqrt(torch.sum(v * v, dim=axes, keepdim=True))


def _weight_from(v, g, dim):
    if dim is None:
        return v * (g.reshape(()) / torch.sqrt(torch.sum(v * v)))
    shape = [1] * v.ndim
    shape[dim] = -1
    return v / _norm_except(v, dim) * g.reshape(shape)


def weight_norm(layer, name="weight", dim=0):
    """Reparametrize ``layer.<name>`` as ``g * v / ||v||`` (norms over
    every axis but ``dim``; one scalar ``g`` for ``dim=None``)."""
    w = _take(layer, name)
    wv = w._value.detach()
    if dim is not None:
        dim = dim % wv.ndim
        axes = [i for i in range(wv.ndim) if i != dim]
        g0 = torch.sqrt(torch.sum(torch.square(wv), dim=axes)).reshape(-1)
    else:
        g0 = torch.sqrt(torch.sum(torch.square(wv))).reshape(1)
    layer.add_parameter(f"{name}_v", Parameter(wv.clone(),
                                               name=f"{w.name}_v"))
    layer.add_parameter(f"{name}_g", Parameter(g0, name=f"{w.name}_g"))
    layer._weight_norm_cfg = (name, dim)

    def compute(lay):
        p = lay._parameters
        lay.__dict__[name] = Tensor._wrap(
            _weight_from(p[f"{name}_v"], p[f"{name}_g"], dim))

    compute(layer)

    def pre_hook(lay, inputs):
        compute(lay)
        return inputs

    layer._weight_norm_hook = layer.register_forward_pre_hook(pre_hook)
    return layer


def remove_weight_norm(layer, name="weight"):
    """Fold ``g`` and ``v`` back into one ``<name>`` parameter."""
    if not hasattr(layer, "_weight_norm_hook"):
        raise ValueError(f"weight_norm was not applied to {layer}")
    layer._weight_norm_hook.remove()
    nm, dim = layer._weight_norm_cfg
    with torch.no_grad():
        w = _weight_from(_take(layer, f"{name}_v")._value,
                         _take(layer, f"{name}_g")._value, dim)
    layer.__dict__.pop(name, None)
    layer.add_parameter(name, Parameter(w, name=nm))
    del layer._weight_norm_hook
    del layer._weight_norm_cfg
    return layer


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=None):
    """Each forward divides the current ``<name>_orig`` by its leading
    singular value (``n_power_iterations`` power steps on the rows along
    ``dim``, 0 by default, from the last step's vectors); sigma = u W v
    is differentiable in W, u and v are constants."""
    w = _take(layer, name)
    dim = (0 if dim is None else dim) % w.ndim
    layer.add_parameter(f"{name}_orig", w)
    wv = w._value.detach()
    mat0 = wv.movedim(dim, 0).reshape(wv.shape[dim], -1).float()
    u = torch.as_tensor(np.random.RandomState(0).standard_normal(
        mat0.shape[0]), dtype=torch.float32, device=wv.device)
    u = u / torch.clamp(torch.linalg.vector_norm(u), min=eps)
    v = mat0.T @ u
    state = {"u": u, "v": v / torch.clamp(torch.linalg.vector_norm(v),
                                          min=eps)}

    def compute(lay):
        orig = lay._parameters[f"{name}_orig"]
        rows = orig.shape[dim]
        with torch.no_grad():
            m = orig.detach().movedim(dim, 0).reshape(rows, -1).float()
            u, v = state["u"], state["v"]
            for _ in range(n_power_iterations):
                v = m.T @ u
                v = v / torch.clamp(torch.linalg.vector_norm(v), min=eps)
                u = m @ v
                u = u / torch.clamp(torch.linalg.vector_norm(u), min=eps)
            state["u"], state["v"] = u, v
        ct = torch.promote_types(orig.dtype, torch.float32)
        wm = orig.movedim(dim, 0).reshape(rows, -1).to(ct)
        sigma = (u[None, :].to(ct) @ wm @ v[:, None].to(ct)).reshape(())
        lay.__dict__[name] = Tensor._wrap(orig / sigma)

    compute(layer)

    def pre_hook(lay, inputs):
        compute(lay)
        return inputs

    layer.register_forward_pre_hook(pre_hook)
    return layer


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale the gradients in place by ``min(max_norm / max(total,
    1e-12), 1)``; returns ``total`` (float64), the ``norm_type`` norm of
    all of them, as a Tensor.  ``error_if_nonfinite`` reads it on the
    host and raises if it is not finite."""
    params = parameters if isinstance(parameters, (list, tuple)) \
        else [parameters]
    grads = [_leaf(p).grad for p in params if _leaf(p).grad is not None]
    if not grads:
        return Tensor._wrap(torch.zeros(()))
    if norm_type == float("inf"):
        total = torch.max(torch.stack([g.abs().max() for g in grads]))
    else:
        total = torch.sum(torch.stack(
            [torch.sum(g.double().abs() ** norm_type) for g in grads])
        ) ** (1.0 / norm_type)
    if error_if_nonfinite and not bool(torch.isfinite(total)):
        raise RuntimeError(
            "the total norm for gradients is non-finite; disable "
            "error_if_nonfinite to clip anyway")
    scale = torch.clamp(max_norm / torch.clamp(total, min=1e-12), max=1.0)
    with torch.no_grad():
        for g in grads:
            g.mul_(scale.to(g.dtype))
    return Tensor._wrap(total)


def clip_grad_value_(parameters, clip_value):
    params = parameters if isinstance(parameters, (list, tuple)) \
        else [parameters]
    with torch.no_grad():
        for p in params:
            g = _leaf(p).grad
            if g is not None:
                g.clamp_(-clip_value, clip_value)


def parameters_to_vector(parameters, name=None):
    """The parameters' values, flattened and concatenated (no gradient
    flows back)."""
    return Tensor._wrap(torch.cat([_leaf(p).detach().reshape(-1)
                                   for p in parameters]))


def vector_to_parameters(vec, parameters, name=None):
    """Write consecutive slices of ``vec`` into the parameters."""
    v = _leaf(vec) if isinstance(vec, (Tensor, torch.Tensor)) \
        else torch.as_tensor(np.asarray(vec))
    off = 0
    with torch.no_grad():
        for p in parameters:
            leaf = _leaf(p)
            n = leaf.numel()
            leaf.copy_(v[off:off + n].reshape(leaf.shape))
            off += n
