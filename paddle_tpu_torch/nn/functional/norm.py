"""Normalisation functionals (``paddle_tpu.nn.functional.norm``
counterparts).

``layer_norm`` routes as the JAX package does: when the opt-in fused path
applies (``kernels.layer_norm.layer_norm_fused_ok``: affine, last axis,
C a multiple of 128) it runs ``layer_norm_fused`` (the CUDA kernels for
CUDA tensors, their plain versions for CPU tensors); otherwise it is
``torch.nn.functional.layer_norm``, exactly what ``torch.nn.LayerNorm``
runs, so the default path's numbers do not move.

``batch_norm`` is the reference's literal arithmetic in torch ops (not
``torch.nn.functional.batch_norm``), where three things differ from torch:

* batch statistics by dtype: half inputs take one-pass f32 statistics,
  ``max(E[x^2] - E[x]^2, 0)``; full-precision inputs the two-pass mean and
  (biased) variance in their own dtype;
* the normalisation folds into a per-channel scale and shift computed in
  the statistics' dtype, then cast to x's dtype: the apply runs in x's
  dtype;
* the running statistics update as ``running = m * running + (1 - m) *
  batch`` (paddle's momentum, m = 0.9 by default) with the biased batch
  variance, in place and outside autograd (``with_no_grad_update``).
"""
from __future__ import annotations

import torch

from ...kernels.layer_norm import layer_norm_fused, layer_norm_fused_ok

__all__ = ["layer_norm", "batch_norm", "with_no_grad_update"]


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    normalized_shape = tuple(normalized_shape)
    axes = tuple(range(x.dim() - len(normalized_shape), x.dim()))
    if layer_norm_fused_ok(x, axes, weight, bias):
        return layer_norm_fused(x, weight, bias, epsilon)
    return torch.nn.functional.layer_norm(x, normalized_shape, weight, bias,
                                          epsilon)


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5, data_format="NCHW",
               use_global_stats=None, name=None):
    """The normalised x; in training (batch statistics) the running
    statistics update in place."""
    channel_axis = (1 if data_format.startswith("NC") and x.dim() > 2
                    else x.dim() - 1)
    reduce_axes = tuple(i for i in range(x.dim()) if i != channel_axis)
    shape = [1] * x.dim()
    shape[channel_axis] = x.shape[channel_axis]
    use_batch_stats = training and not use_global_stats
    if use_batch_stats:
        if x.is_floating_point() and torch.finfo(x.dtype).bits < 32:
            xf = x.float()
            mean = xf.mean(dim=reduce_axes)
            var = torch.clamp((xf * xf).mean(dim=reduce_axes) - mean * mean,
                              min=0)
        else:
            mean = x.mean(dim=reduce_axes)
            var = x.var(dim=reduce_axes, correction=0)
    else:
        mean, var = running_mean, running_var
    stat_dtype = mean.dtype
    inv = torch.rsqrt(var.to(stat_dtype) + epsilon)
    scale = inv if weight is None else inv * weight.to(stat_dtype)
    shift = -mean * scale
    if bias is not None:
        shift = shift + bias.to(stat_dtype)
    out = x * scale.reshape(shape).to(x.dtype) \
        + shift.reshape(shape).to(x.dtype)
    if use_batch_stats and running_mean is not None:
        with_no_grad_update(running_mean, running_var, mean, var, momentum)
    return out


def with_no_grad_update(running_mean, running_var, mean, var, momentum):
    """``running = momentum * running + (1 - momentum) * batch``, in
    place, outside autograd."""
    with torch.no_grad():
        running_mean.copy_(momentum * running_mean + (1 - momentum)
                           * mean.to(running_mean.dtype))
        running_var.copy_(momentum * running_var + (1 - momentum)
                          * var.to(running_var.dtype))
