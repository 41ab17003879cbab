"""Common functionals (``paddle_tpu.nn.functional.common`` counterparts):
``one_hot``, ``interpolate`` and ``upsample``.

``one_hot`` is ``jax.nn.one_hot`` in f32: an index outside ``[0,
num_classes)`` gives a row of zeros (torch's ``one_hot`` would raise on
a negative one).

``interpolate`` computes what the JAX package's does, which is
``jax.image.resize`` over the spatial dims (``align_corners`` and
``align_mode`` are accepted and, as there, not read; ``"area"`` resizes
as ``"linear"``, as there):

* ``"nearest"`` takes source index ``floor((i + 0.5) * in / out)``
  computed in f32 (half-pixel centres: torch's ``"nearest-exact"``; at an
  integer scale the same as torch's ``"nearest"``), one ``index_select``
  a resized dim;
* the linear modes (``"linear"``, ``"bilinear"``, ``"trilinear"``,
  ``"area"``) and ``"bicubic"`` (Keys' cubic, a = -0.5) contract each
  resized dim with ``jax.image.scale``'s weight matrix: half-pixel
  sample positions, the kernel widened by ``in / out`` when shrinking
  (antialiasing, ``jax.image.resize``'s default), the weights of each
  output normalised to 1 and zeroed for a sample outside the input.  The
  matrix is built in f64 on the host and applied in x's dtype (cached
  by shape, device and dtype).

The output size is ``size``, or ``int(dim * scale_factor)`` per spatial
dim, as in the JAX package.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ...core.op import defop

__all__ = ["one_hot", "interpolate", "upsample"]


@defop(register=False)
def one_hot(x, num_classes, name=None):
    """``[..., num_classes]`` f32; out-of-range indices give zeros."""
    classes = torch.arange(int(num_classes), device=x.device)
    return (x.unsqueeze(-1) == classes).to(torch.float32)


def _triangle(x):
    return np.maximum(0.0, 1.0 - np.abs(x))


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


_KERNELS = {"linear": _triangle, "cubic": _keys_cubic}
_METHOD = {"nearest": "nearest", "linear": "linear", "bilinear": "linear",
           "trilinear": "linear", "area": "linear", "bicubic": "cubic"}


@functools.lru_cache(maxsize=64)
def _weight_mat(m, n, kernel):
    """``jax.image.scale.compute_weight_mat(m, n, n / m, 0., kernel,
    antialias=True)`` in f64: ``[m, n]``."""
    inv_scale = 1.0 / (n / m)
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n, dtype=np.float64) + 0.5) * inv_scale - 0.5
    w = _KERNELS[kernel](np.abs(sample[None, :] - np.arange(
        m, dtype=np.float64)[:, None]) / kernel_scale)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return np.where(inside[None, :], w, 0.0)


@functools.lru_cache(maxsize=64)
def _weight_on(m, n, kernel, device, dtype):
    """:func:`_weight_mat` on ``device`` in ``dtype``, copied once (a copy
    from the host waits for the device)."""
    return torch.from_numpy(_weight_mat(m, n, kernel)).to(device, dtype)


def _nearest_index(m, n, device):
    offsets = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) \
        * m / n
    return torch.floor(offsets).to(torch.int64)


@defop
def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    channel_first = data_format in ("NCHW", "NCL", "NCDHW")
    dims = (list(range(2, x.dim())) if channel_first
            else list(range(1, x.dim() - 1)))
    spatial = [x.shape[d] for d in dims]
    if size is not None:
        if torch.is_tensor(size):
            size = [int(s) for s in size.reshape(-1).tolist()]
        out = [int(s) for s in (size if isinstance(size, (list, tuple))
                                else [size])]
    elif isinstance(scale_factor, (list, tuple)):
        out = [int(s * f) for s, f in zip(spatial, scale_factor)]
    else:
        out = [int(s * scale_factor) for s in spatial]
    method = _METHOD[mode]
    if method != "nearest" and not x.is_floating_point():
        x = x.to(torch.get_default_dtype())
    for d, m, n in zip(dims, spatial, out):
        if m == n:
            continue
        if method == "nearest":
            x = x.index_select(d, _nearest_index(m, n, x.device))
        else:
            w = _weight_on(m, n, method, x.device, x.dtype)
            x = torch.tensordot(x, w, dims=([d], [0])).movedim(-1, d)
    return x


@defop(register=False)
def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)
