"""Common functionals (``paddle_tpu.nn.functional.common`` counterparts):
``linear``, the dropouts, ``embedding``, ``one_hot``, ``label_smooth``,
``normalize``, ``cosine_similarity``, ``sequence_mask``, the pixel and
channel shuffles, ``interpolate`` / ``upsample``, ``unfold`` / ``fold``,
``bilinear``, ``pad`` and ``class_center_sample``.

``linear`` is ``x @ W + b`` with paddle's ``[in, out]`` weight (a plain
product, as the JAX package computes it outside Pallas).  The dropouts
draw their masks from the port's generator for x's device
(``core.random.generator``): keep with probability ``1 - p``, then
``x / (1 - p)`` (``"upscale_in_train"``) or ``x`` (``"downscale_in_infer"``,
which scales by ``1 - p`` outside training); ``axis`` shares one draw
along the other dims.  ``embedding`` zeroes the output rows whose index
is ``padding_idx`` (so their gradient is zero too), as the JAX function
does.

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
import torch.nn.functional as tF

from ...core import random as rnd
from ...core import selected_rows
from ...core.op import apply_op, defop
from ...core.tensor import Tensor
from ...ops.manipulation import pad  # noqa: F401  (re-exported as F.pad)

__all__ = ["linear", "dropout", "dropout2d", "dropout3d", "alpha_dropout",
           "embedding", "one_hot", "label_smooth", "normalize",
           "cosine_similarity", "sequence_mask", "pixel_shuffle",
           "pixel_unshuffle", "channel_shuffle", "interpolate", "upsample",
           "unfold", "fold", "bilinear", "pad", "class_center_sample"]


@defop
def linear(x, weight, bias=None, name=None):
    # paddle stores Linear weights as [in_features, out_features]
    out = torch.matmul(x, weight)
    if bias is not None:
        out = out + bias
    return out


def _keep_mask(x, p, shape):
    u = torch.rand(shape, generator=rnd.generator(x.device),
                   device=x.device)
    return u >= p


@defop
def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    if not training or p == 0.0:
        return x if mode == "upscale_in_train" else x * (1.0 - p)
    if p == 1.0:
        return torch.zeros_like(x)
    shape = list(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        keep_dims = [a % x.dim() for a in axes]
        shape = [s if i in keep_dims else 1 for i, s in enumerate(shape)]
    keep = _keep_mask(x, p, shape)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), zero)
    return torch.where(keep, x, zero)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p=p, axis=axis, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p=p, axis=axis, training=training)


@defop
def alpha_dropout(x, p=0.5, training=True, name=None):
    if not training or p == 0.0:
        return x
    alpha = 1.6732632423543772
    scale = 1.0507009873554805
    alpha_p = -alpha * scale
    keep = _keep_mask(x, p, x.shape)
    a = float(np.float32(1.0 / np.sqrt((alpha_p ** 2 * p + 1) * (1 - p))))
    b = -a * alpha_p * p
    return a * torch.where(keep, x, torch.full_like(x, alpha_p)) + b


@defop
def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """``weight[x]`` with the ``padding_idx`` rows zero.  ``sparse=True``
    with grad enabled gives the weight a sparse gradient
    (``core.selected_rows``; ids clipped to the table as the JAX lookup
    clips them); inside the train step it stays dense."""
    if sparse and weight.requires_grad and \
            selected_rows.sparse_gradients_enabled():
        return selected_rows.sparse_embedding_lookup(weight, x, padding_idx)
    out = tF.embedding(x.long(), weight)
    if padding_idx is not None:
        out = out * (x != padding_idx).unsqueeze(-1).to(out.dtype)
    return out


@defop(register=False)
def one_hot(x, num_classes, name=None):
    """``[..., num_classes]`` f32; out-of-range indices give zeros."""
    classes = torch.arange(int(num_classes), device=x.device)
    return (x.unsqueeze(-1) == classes).to(torch.float32)


@defop
def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * prior_dist
    return (1 - epsilon) * label + epsilon / label.shape[-1]


@defop
def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    nrm = (x.abs() ** p).sum(dim=int(axis), keepdim=True) ** (1.0 / p)
    return x / nrm.clamp(min=epsilon)


@defop
def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    axis = int(axis)
    dot = (x1 * x2).sum(dim=axis)
    n1 = (x1 * x1).sum(dim=axis).sqrt()
    n2 = (x2 * x2).sum(dim=axis).sqrt()
    return dot / (n1 * n2).clamp(min=eps)


def sequence_mask(lengths, maxlen=None, dtype="int64", name=None):
    """``[..., maxlen]``: 1 where the position is below the length.
    Without ``maxlen`` it is the largest length (read on the host)."""
    from ...core.dtype import convert_dtype

    def raw(lv):
        n = int(lv.max()) if maxlen is None else int(maxlen)
        return (torch.arange(n, device=lv.device) < lv[..., None]).to(
            convert_dtype(dtype))
    return apply_op(raw, "sequence_mask", (lengths,), {})


@defop
def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    r = int(upscale_factor)
    if data_format == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
        return x.reshape(n, c // (r * r), h * r, w * r)
    # NHWC: channels grouped [c_out, r, r] with c_out slowest
    n, h, w, c = x.shape
    co = c // (r * r)
    x = x.reshape(n, h, w, co, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, h * r, w * r, co)


@defop
def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    r = int(downscale_factor)
    if data_format == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4)
        return x.reshape(n, c * r * r, h // r, w // r)
    # NHWC: output channels grouped [c, r, r] with c slowest (the inverse
    # of the NHWC pixel_shuffle)
    n, h, w, c = x.shape
    x = x.reshape(n, h // r, r, w // r, r, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(n, h // r, w // r, c * r * r)


@defop
def channel_shuffle(x, groups, data_format="NCHW", name=None):
    if data_format == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, groups, c // groups, h, w).transpose(1, 2)
        return x.reshape(n, c, h, w)
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, groups, c // groups).transpose(3, 4)
    return x.reshape(n, h, w, c)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


@defop(name="unfold_im2col")   # Tensor.unfold owns the plain "unfold" name
def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: NCHW -> ``[N, C * kh * kw, L]``; ``paddings`` an int, a
    ``[ph, pw]`` pair or ``[ph0, pw0, ph1, pw1]``."""
    kh, kw = _pair(kernel_sizes)
    sh, sw = _pair(strides)
    dh, dw = _pair(dilations)
    if isinstance(paddings, int):
        ph0 = ph1 = pw0 = pw1 = paddings
    elif len(paddings) == 2:
        ph0 = ph1 = paddings[0]
        pw0 = pw1 = paddings[1]
    else:
        ph0, pw0, ph1, pw1 = paddings
    n, c, h, w = x.shape
    xp = tF.pad(x, (pw0, pw1, ph0, ph1))
    oh = (h + ph0 + ph1 - (dh * (kh - 1) + 1)) // sh + 1
    ow = (w + pw0 + pw1 - (dw * (kw - 1) + 1)) // sw + 1
    patches = [xp[:, :, i * dh:i * dh + (oh - 1) * sh + 1:sh,
                  j * dw:j * dw + (ow - 1) * sw + 1:sw]
               for i in range(kh) for j in range(kw)]
    return torch.stack(patches, dim=2).reshape(n, c * kh * kw, oh * ow)


@defop
def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im, the adjoint of :func:`unfold` (overlaps add)."""
    oh, ow = _pair(output_sizes)
    kh, kw = _pair(kernel_sizes)
    sh, sw = _pair(strides)
    dh, dw = _pair(dilations)
    ph, pw = _pair(paddings)
    n, ckk, _ = x.shape
    c = ckk // (kh * kw)
    out_h, out_w = oh + 2 * ph, ow + 2 * pw
    noh = (out_h - (dh * (kh - 1) + 1)) // sh + 1
    now = (out_w - (dw * (kw - 1) + 1)) // sw + 1
    xr = x.reshape(n, c, kh, kw, noh, now)
    out = torch.zeros((n, c, out_h, out_w), dtype=x.dtype, device=x.device)
    for i in range(kh):
        for j in range(kw):
            out[:, :, i * dh:i * dh + (noh - 1) * sh + 1:sh,
                j * dw:j * dw + (now - 1) * sw + 1:sw] += xr[:, :, i, j]
    return out[:, :, ph:ph + oh, pw:pw + ow]


@defop(register=False)
def bilinear(x1, x2, weight, bias=None, name=None):
    """``out[b, o] = x1[b] @ W[o] @ x2[b]`` (+ bias)."""
    out = torch.einsum("bm,omn,bn->bo", x1, weight, x2)
    if bias is not None:
        out = out + bias
    return out


def class_center_sample(label, num_classes, num_samples, group=None):
    """PartialFC class-center sampling: keep every positive class, draw
    negatives (from the port's CPU generator) up to ``num_samples``;
    returns ``(remapped_label, sorted sampled class ids)``.  A host op
    (the output shape depends on the data).  A group of more than one
    rank raises, as in the JAX package."""
    if group not in (None, False) and getattr(group, "nranks", 1) > 1:
        raise NotImplementedError(
            "class_center_sample across a multi-rank group is not "
            "supported in-process")
    raw = label._value if isinstance(label, Tensor) else torch.as_tensor(
        np.asarray(label))
    lab = raw.detach().cpu().reshape(-1).long().numpy()
    if lab.size and (lab.min() < 0 or lab.max() >= num_classes):
        raise ValueError(
            f"labels must lie in [0, {num_classes}), got range "
            f"[{lab.min()}, {lab.max()}]")
    pos = np.unique(lab)
    if len(pos) < num_samples:
        neg_pool = np.setdiff1d(np.arange(num_classes, dtype=np.int64),
                                pos, assume_unique=True)
        k = min(num_samples - len(pos), len(neg_pool))
        pick = torch.randperm(len(neg_pool),
                              generator=rnd.generator("cpu"))[:k].numpy()
        sampled = np.sort(np.concatenate([pos, neg_pool[pick]]))
    else:
        sampled = pos
    remapped = np.searchsorted(sampled, lab)
    dev = raw.device
    return (Tensor._wrap(torch.from_numpy(remapped.astype(np.int64)).to(dev)),
            Tensor._wrap(torch.from_numpy(sampled.astype(np.int64)).to(dev)))


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
