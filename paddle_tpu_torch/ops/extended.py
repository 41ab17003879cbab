"""The long tail of the op inventory (``paddle_tpu.ops.extended``
counterpart): math extensions (``addmm``, ``logit``, ``renorm``, the norm
clips), tensor surgery (``diag_embed``, ``fill_diagonal``, ``unstack``,
``crop_tensor``, ``shard_index``), signal framing (``frame`` /
``overlap_add``), sequence decoding (``gather_tree``, ``viterbi_decode``,
``edit_distance``), LU factorisation and the sampling-grid family
(``affine_grid`` / ``grid_sample`` / ``temporal_shift`` /
``max_unpool2d``).

Each op is the JAX package's arithmetic in torch ops, registered under
its name.  ``tril_indices`` / ``triu_indices`` take no tensor and give a
Tensor on the current place.  ``edit_distance`` and ``lu_unpack``'s
permutation run on the host, as in the JAX package; a scatter that writes
one place twice keeps its last writer (``ops.manipulation._set``).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as tF

from ..core.dtype import convert_dtype
from ..core.op import OP_REGISTRY, defop
from ..core.place import current_device
from ..core.tensor import Tensor
from .manipulation import _set

__all__ = [
    "addmm", "logit", "renorm", "clip_by_norm", "squared_l2_norm",
    "unstack", "diag_embed", "fill", "fill_diagonal",
    "fill_diagonal_tensor", "crop_tensor", "shard_index", "tril_indices",
    "triu_indices", "frame", "overlap_add", "gather_tree",
    "viterbi_decode", "edit_distance", "lu", "lu_unpack", "affine_grid",
    "grid_sample", "temporal_shift", "bilinear_tensor_product",
    "max_unpool2d",
]


@defop
def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):  # noqa: A002
    """beta * input + alpha * (x @ y)."""
    return beta * input + alpha * (x @ y)


@defop
def logit(x, eps=None, name=None):
    """log(x / (1 - x)), x clipped to [eps, 1 - eps] when eps is given."""
    if eps is not None:
        x = torch.clamp(x, eps, 1.0 - eps)
    return torch.log(x) - torch.log1p(-x)


@defop
def renorm(x, p, axis, max_norm, name=None):
    """Every slice along ``axis`` scaled to a p-norm of at most
    ``max_norm``."""
    axes = tuple(i for i in range(x.ndim) if i != axis % x.ndim)
    norms = torch.sum(torch.abs(x) ** p, dim=axes, keepdim=True) ** (1.0 / p)
    scale = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                        torch.ones_like(norms))
    return x * scale


@defop
def clip_by_norm(x, max_norm, name=None):
    """x * min(1, max_norm / ||x||_2)."""
    n = torch.sqrt(torch.sum(torch.square(x)))
    return x * torch.clamp(max_norm / torch.clamp(n, min=1e-12), max=1.0)


@defop
def squared_l2_norm(x, name=None):
    return torch.sum(torch.square(x)).reshape(1)


@defop
def unstack(x, axis=0, num=None, name=None):
    """``num`` (the axis' size by default) tensors without ``axis``."""
    n = num or x.shape[axis]
    return [p.squeeze(axis) for p in torch.tensor_split(x, n, dim=axis)]


@defop
def diag_embed(input, offset=0, dim1=-2, dim2=-1, name=None):  # noqa: A002
    """Batched vectors as banded matrices on dims (dim1, dim2)."""
    return torch.diag_embed(input, offset, dim1, dim2)


@defop
def fill(x, value, name=None):
    return torch.full_like(x, value)


@defop
def fill_diagonal(x, value, offset=0, wrap=False, name=None):
    """The JAX package's walk of the flat buffer in diagonal-stride steps:
    ``offset`` shifts the write within a row (dropped where it leaves the
    row); ``wrap`` (forced for ndim > 2, all dims equal) walks on past
    the first n * n elements."""
    n_last = x.shape[-1]
    if x.ndim < 2:
        raise ValueError("fill_diagonal needs a tensor with ndim >= 2")
    if x.ndim > 2:
        if len(set(x.shape)) != 1:
            raise ValueError(
                "fill_diagonal requires all dims equal when ndim > 2")
        wrap = True
    shape = tuple(x.shape)
    strides = np.cumprod((shape[1:] + (1,))[::-1])[::-1]
    step = int(strides.sum())
    size = int(np.prod(shape))
    if not wrap:
        size = min(size, n_last * n_last)
    flat_idx = np.arange(0, size, step)
    cols = flat_idx % n_last + offset
    flat_idx = flat_idx[(cols >= 0) & (cols < n_last)] + offset
    if flat_idx.size == 0:
        return x
    idx = torch.as_tensor(flat_idx, device=x.device)
    return x.reshape(-1).index_put(
        (idx,), torch.as_tensor(value, dtype=x.dtype, device=x.device)
    ).reshape(shape)


@defop
def fill_diagonal_tensor(x, y, offset=0, dim1=0, dim2=1, name=None):
    """``y`` written onto the ``offset`` diagonal of dims (dim1, dim2)."""
    n = y.shape[-1] if y.ndim else min(x.shape[dim1], x.shape[dim2])
    rng = torch.arange(n, device=x.device)
    idx = [slice(None)] * x.ndim
    idx[dim1] = rng + max(-offset, 0)
    idx[dim2] = rng + max(offset, 0)
    out = x.clone()
    out[tuple(idx)] = y.to(x.dtype)
    return out


@defop
def crop_tensor(x, shape, offsets=None, name=None):
    offsets = offsets or [0] * x.ndim
    return x[tuple(slice(o, o + s) for o, s in zip(offsets, shape))]


@defop
def shard_index(input, index_num, nshards, shard_id, ignore_value=-1,  # noqa: A002
                name=None):
    """Ids relocated to shard ``shard_id``'s local range, others
    ``ignore_value``."""
    per = (index_num + nshards - 1) // nshards
    mine = torch.div(input, per, rounding_mode="floor") == shard_id
    return torch.where(mine, input - shard_id * per,
                       torch.full_like(input, ignore_value))


def _creation_op(raw):
    """An op that takes no tensor: its result is a Tensor on the current
    place."""
    def op(*args, **kwargs):
        return Tensor._wrap(raw(*args, **kwargs))
    op.__name__ = op.__qualname__ = raw.__name__
    op.__doc__ = raw.__doc__
    op.raw, op.op_name = raw, raw.__name__
    OP_REGISTRY[raw.__name__] = op
    return op


def tril_indices(row, col=None, offset=0, dtype="int64", name=None):
    """[2, n] row and column indices of the lower triangle."""
    r, c = np.tril_indices(row, offset, col or row)
    return torch.as_tensor(np.stack([r, c]), dtype=convert_dtype(dtype),
                           device=current_device())


def triu_indices(row, col=None, offset=0, dtype="int64", name=None):
    """[2, n] row and column indices of the upper triangle."""
    r, c = np.triu_indices(row, offset, col or row)
    return torch.as_tensor(np.stack([r, c]), dtype=convert_dtype(dtype),
                           device=current_device())


tril_indices = _creation_op(tril_indices)
triu_indices = _creation_op(triu_indices)


@defop
def frame(x, frame_length, hop_length, axis=-1, name=None):
    """Frames of ``frame_length`` every ``hop_length`` along ``axis``,
    stacked on a new last axis ([..., T] -> [..., frame_length, n] for the
    last axis)."""
    n = 1 + (x.shape[axis] - frame_length) // hop_length
    return torch.stack([x.narrow(axis, i * hop_length, frame_length)
                        for i in range(n)], dim=-1)


@defop
def overlap_add(x, hop_length, axis=-1, name=None):
    """The inverse of ``frame``: [..., frame_length, n] -> [..., T]."""
    frame_length, n = x.shape[-2], x.shape[-1]
    t = (n - 1) * hop_length + frame_length
    return sum(tF.pad(x[..., i], (i * hop_length,
                                  t - i * hop_length - frame_length))
               for i in range(n))


@defop
def gather_tree(ids, parents, name=None):
    """Beam-search backtrace over [max_time, batch, beam]."""
    t_max = ids.shape[0]
    out = [None] * t_max
    out[t_max - 1] = ids[t_max - 1]
    cur = parents[t_max - 1].long()
    for t in range(t_max - 2, -1, -1):
        out[t] = torch.gather(ids[t], 1, cur)
        cur = torch.gather(parents[t], 1, cur).long()
    return torch.stack(out, dim=0)


@defop
def viterbi_decode(potentials, transition_params, lengths=None,
                   include_bos_eos_tag=True, name=None):
    """CRF max-sum decode: potentials [B, T, C], transitions [C, C] ->
    (scores [B], paths [B, T] int64).  With ``include_bos_eos_tag`` row
    C - 1 of the transitions is the start row and row C - 2 the stop row;
    past a sequence's length alpha stays and the backpointer is the
    identity."""
    pot, trans = potentials, transition_params
    b, t, c = pot.shape
    dev = pot.device
    lens = torch.full((b,), t, dtype=torch.int32, device=dev) \
        if lengths is None else torch.as_tensor(lengths, device=dev).int()
    alpha = pot[:, 0] + trans[c - 1][None, :] if include_bos_eos_tag \
        else pot[:, 0]
    ident = torch.arange(c, device=dev)[None, :]
    backptrs = []
    for i in range(1, t):
        scores = alpha[:, :, None] + trans[None] + pot[:, i][:, None, :]
        active = (i < lens)[:, None]
        alpha = torch.where(active, scores.max(dim=1).values, alpha)
        backptrs.append(torch.where(active, scores.argmax(dim=1), ident))
    if include_bos_eos_tag:
        alpha = alpha + trans[c - 2][None, :]
    best = alpha.max(dim=1).values
    tag = alpha.argmax(dim=1)
    path = [tag]
    for bp in reversed(backptrs):
        tag = torch.gather(bp, 1, tag[:, None])[:, 0]
        path.append(tag)
    return best, torch.stack(path[::-1], dim=1).long()


def _host(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


@defop
def edit_distance(input, label, normalized=True, input_length=None,  # noqa: A002
                  label_length=None, name=None):
    """Levenshtein distance of int id rows ([B, T1] against [B, T2]), on
    the host: (distances [B, 1] f32, sequence count [1] int64)."""
    a, lb = _host(input), _host(label)
    il = _host(input_length) if input_length is not None \
        else np.full(a.shape[0], a.shape[1])
    ll = _host(label_length) if label_length is not None \
        else np.full(lb.shape[0], lb.shape[1])
    out = np.zeros((a.shape[0], 1), np.float32)
    for bi in range(a.shape[0]):
        n, m = int(il[bi]), int(ll[bi])
        d = np.arange(m + 1, dtype=np.int64)
        for i in range(1, n + 1):
            prev = d.copy()
            d[0] = i
            for j in range(1, m + 1):
                cost = 0 if a[bi, i - 1] == lb[bi, j - 1] else 1
                d[j] = min(d[j - 1] + 1, prev[j] + 1, prev[j - 1] + cost)
        dist = float(d[m])
        out[bi, 0] = dist / m if (normalized and m) else dist
    dev = input.device if isinstance(input, torch.Tensor) else None
    return (torch.as_tensor(out, device=dev),
            torch.as_tensor([a.shape[0]], dtype=torch.int64, device=dev))


@defop
def lu(x, pivot=True, name=None):
    """Packed LU factorisation: (factor, 1-based int32 pivots, int32
    info)."""
    lu_mat, piv = torch.linalg.lu_factor(x)
    info = torch.zeros(x.shape[:-2], dtype=torch.int32, device=x.device)
    return lu_mat, piv.int(), info


@defop
def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True, name=None):
    """(packed LU, 1-based pivots) -> (P, L, U), batched over the leading
    dims; the permutation is built on the host."""
    n, m = x.shape[-2], x.shape[-1]
    lower = torch.tril(x, -1) + torch.eye(n, m, dtype=x.dtype,
                                          device=x.device)
    upper = torch.triu(x)
    piv = _host(y)
    piv = piv.reshape((-1, piv.shape[-1])) - 1
    pmats = np.zeros((piv.shape[0], n, n), np.float64)
    for bi in range(piv.shape[0]):
        perm = np.arange(n)
        for i, p in enumerate(piv[bi][:n]):
            perm[i], perm[int(p)] = perm[int(p)], perm[i]
        pmats[bi] = np.eye(n)[perm].T
    pmat = torch.as_tensor(pmats, dtype=x.dtype, device=x.device).reshape(
        tuple(x.shape[:-2]) + (n, n))
    return pmat, lower[..., :n, :min(n, m)], upper


@defop
def affine_grid(theta, out_shape, align_corners=True, name=None):
    """[N, 2, 3] affine maps -> f32 sampling grid [N, H, W, 2]."""
    h, w = int(out_shape[-2]), int(out_shape[-1])
    dev = theta.device
    if align_corners:
        ys = torch.linspace(-1.0, 1.0, h, device=dev)
        xs = torch.linspace(-1.0, 1.0, w, device=dev)
    else:
        ys = (torch.arange(h, device=dev) * 2 + 1) / h - 1
        xs = (torch.arange(w, device=dev) * 2 + 1) / w - 1
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1).float()
    return torch.einsum("nij,hwj->nhwi", theta.float(), base)


@defop
def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """NCHW bilinear / nearest sampling at normalised coordinates [N, H',
    W', 2]; out-of-range taps read 0 (``"zeros"``) or the clamped edge."""
    n, c, h, w = x.shape
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        fx = (gx + 1) * 0.5 * (w - 1)
        fy = (gy + 1) * 0.5 * (h - 1)
    else:
        fx = ((gx + 1) * w - 1) * 0.5
        fy = ((gy + 1) * h - 1) * 0.5
    bidx = torch.arange(n, device=x.device)[:, None, None]

    def sample(ix, iy):
        inb = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        vals = x[bidx, :, iy.clamp(0, h - 1), ix.clamp(0, w - 1)]
        if padding_mode == "zeros":
            vals = torch.where(inb[..., None], vals, torch.zeros_like(vals))
        return vals                                   # [N, H', W', C]

    if mode == "nearest":
        out = sample(torch.round(fx).long(), torch.round(fy).long())
    else:
        x0, y0 = torch.floor(fx).long(), torch.floor(fy).long()
        x1, y1 = x0 + 1, y0 + 1
        wa = (x1 - fx) * (y1 - fy)
        wb = (fx - x0) * (y1 - fy)
        wc = (x1 - fx) * (fy - y0)
        wd = (fx - x0) * (fy - y0)
        out = (sample(x0, y0) * wa[..., None] + sample(x1, y0) * wb[..., None]
               + sample(x0, y1) * wc[..., None]
               + sample(x1, y1) * wd[..., None])
    return out.movedim(-1, 1)


@defop
def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW",
                   name=None):
    """TSM: a fraction of the channels shifted one segment back and one
    forward along time; x is [N * T, C, H, W]."""
    nt, c, h, w = x.shape
    v = x.reshape(nt // seg_num, seg_num, c, h, w)
    fold = int(c * shift_ratio)
    left = torch.cat([v[:, 1:, :fold], torch.zeros_like(v[:, :1, :fold])],
                     dim=1)
    right = torch.cat([torch.zeros_like(v[:, :1, fold:2 * fold]),
                       v[:, :-1, fold:2 * fold]], dim=1)
    return torch.cat([left, right, v[:, :, 2 * fold:]], dim=2).reshape(
        nt, c, h, w)


@defop
def bilinear_tensor_product(x, y, weight, bias=None, name=None):
    """out[b, o] = x[b] @ W[o] @ y[b] (+ bias)."""
    out = torch.einsum("bm,omn,bn->bo", x, weight, y)
    return out if bias is None else out + bias


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


@defop
def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format="NCHW", name=None):
    """Pooled values scattered back to the flat positions
    ``max_pool2d(return_mask=True)`` recorded."""
    n, c, h, w = x.shape
    ks, st = _pair(kernel_size), _pair(stride or kernel_size)
    if output_size is None:
        oh = (h - 1) * st[0] + ks[0] - 2 * padding
        ow = (w - 1) * st[1] + ks[1] - 2 * padding
    else:
        oh, ow = output_size[-2], output_size[-1]
    flat = torch.zeros((n, c, oh * ow), dtype=x.dtype, device=x.device)
    bi = torch.arange(n, device=x.device)[:, None, None]
    ci = torch.arange(c, device=x.device)[None, :, None]
    return _set(flat, (bi, ci, indices.reshape(n, c, -1).long()),
                x.reshape(n, c, -1)).reshape(n, c, oh, ow)
