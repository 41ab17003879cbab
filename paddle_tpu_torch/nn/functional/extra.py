"""The ``nn.functional`` long tail (``paddle_tpu.nn.functional.extra``
counterpart): the distance and margin losses, the hierarchical sigmoid,
the ArcFace-style margin softmax, CSR sparse attention, ``zeropad2d``,
the 1-D / 3-D unpools and the in-place ``elu_`` / ``softmax_`` /
``tanh_``.

The registered ones (``defop``, under the JAX names) take torch tensors
or surface Tensors.  ``sparse_attention`` is the JAX package's dense-mask
computation (the CSR pattern scattered into a ``[B, H, L, L]`` mask):
plain torch, no kernel; its scores and output are float64, as there.  ``margin_cross_entropy`` is the single-group
form, its cosines clipped to +-(1 - 1e-6) before the arccos.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as tF

from ...core.op import defop
from ...core.tensor import Tensor
from ...ops.compat_surface import _inplace
from ...ops.extended import max_unpool2d
from ...ops.manipulation import _set

__all__ = ["dice_loss", "npair_loss", "zeropad2d", "pairwise_distance",
           "soft_margin_loss", "multi_label_soft_margin_loss",
           "triplet_margin_with_distance_loss", "thresholded_relu",
           "hsigmoid_loss", "margin_cross_entropy", "sparse_attention",
           "max_unpool1d", "max_unpool3d", "elu_", "softmax_", "tanh_"]


def _reduce(loss, reduction):
    if reduction == "mean":
        return torch.mean(loss)
    if reduction == "sum":
        return torch.sum(loss)
    if reduction == "none":
        return loss
    raise ValueError(f"reduction should be mean|sum|none, got {reduction}")


@defop
def dice_loss(input, label, epsilon=1e-5, name=None):  # noqa: A002
    """input [N, ..., C] probabilities, label [N, ..., 1] class ids."""
    oh = tF.one_hot(label.squeeze(-1).long(), input.shape[-1]).to(
        input.dtype)
    dims = tuple(range(1, input.ndim))
    inter = torch.sum(input * oh, dim=dims)
    union = torch.sum(input, dim=dims) + torch.sum(oh, dim=dims)
    return torch.mean(1 - (2 * inter + epsilon) / (union + epsilon))


@defop
def npair_loss(anchor, positive, labels, l2_reg=0.002, name=None):
    """Cross entropy over anchor . positive^T similarities against the
    same-label distribution, plus an L2 term on the embeddings."""
    reg = l2_reg * (torch.sum(anchor * anchor) / max(anchor.shape[0], 1)
                    + torch.sum(positive * positive)
                    / max(positive.shape[0], 1)) * 0.25
    sim = anchor @ positive.T
    lab = labels.reshape(-1)
    same = (lab[:, None] == lab[None, :]).to(sim.dtype)
    target = same / torch.clamp(torch.sum(same, dim=1, keepdim=True), min=1)
    ce = -torch.mean(torch.sum(target * torch.log_softmax(sim, dim=1),
                               dim=1))
    return ce + reg


@defop
def zeropad2d(x, padding, data_format="NCHW", name=None):
    """Zero padding ``[left, right, top, bottom]`` of the spatial dims."""
    l, r, t, b = (int(v) for v in (padding.tolist()
                                   if hasattr(padding, "tolist") else padding))
    if data_format == "NCHW":
        return tF.pad(x, (l, r, t, b))
    return tF.pad(x, (0, 0, l, r, t, b))


@defop
def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    """The p-norm of ``x - y + epsilon`` over the last axis (f32 at
    least)."""
    d = x - y + epsilon
    return torch.linalg.vector_norm(
        d.to(torch.promote_types(d.dtype, torch.float32)), ord=p, dim=-1,
        keepdim=keepdim).to(d.dtype)


@defop
def soft_margin_loss(input, label, reduction="mean", name=None):  # noqa: A002
    loss = torch.log1p(torch.exp(-label.to(input.dtype) * input))
    return _reduce(loss, reduction)


@defop
def multi_label_soft_margin_loss(input, label, weight=None,  # noqa: A002
                                 reduction="mean", name=None):
    lab = label.to(input.dtype)
    loss = -(lab * tF.logsigmoid(input) + (1 - lab) * tF.logsigmoid(-input))
    if weight is not None:
        loss = loss * weight
    return _reduce(torch.mean(loss, dim=-1), reduction)


def triplet_margin_with_distance_loss(input, positive, negative,  # noqa: A002
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    """max(d(input, positive) - d(input, negative) + margin, 0), with
    ``pairwise_distance`` as d by default; ``swap`` takes the smaller of
    d(input, negative) and d(positive, negative)."""
    dist = distance_function or pairwise_distance
    surface = any(isinstance(t, Tensor) for t in (input, positive, negative))

    def dval(a, b):
        out = dist(a, b)
        return out._value if isinstance(out, Tensor) else torch.as_tensor(out)

    dp, dn = dval(input, positive), dval(input, negative)
    if swap:
        dn = torch.minimum(dn, dval(positive, negative))
    out = _reduce(torch.clamp(dp - dn + margin, min=0), reduction)
    return Tensor._wrap(out) if surface else out


@defop
def thresholded_relu(x, threshold=1.0, name=None):
    return torch.where(x > threshold, x, torch.zeros_like(x))


def _default_tree_paths(num_classes):
    """Paths of the default complete binary tree: class c is the leaf at
    heap position c + num_classes - 1 below internal nodes
    0 .. num_classes - 2; (node ids [C, D] padded with -1, branch bits
    [C, D])."""
    depth_max = int(np.ceil(np.log2(max(num_classes, 2))))
    table = np.full((num_classes, depth_max), -1, np.int64)
    code = np.zeros((num_classes, depth_max), np.float32)
    for c in range(num_classes):
        node = c + num_classes - 1
        path, bits = [], []
        while node > 0:
            parent = (node - 1) // 2
            path.append(parent)
            bits.append(1.0 if node == 2 * parent + 2 else 0.0)
            node = parent
        table[c, :len(path)] = path[::-1]
        code[c, :len(bits)] = bits[::-1]
    return table, code


@defop
def hsigmoid_loss(input, label, num_classes, weight, bias=None,  # noqa: A002
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """The sum of the sigmoid cross entropies along each label's
    root-to-leaf path: [N, 1].  The default tree is the complete binary
    tree over ``num_classes - 1`` internal nodes; a custom one comes as
    ``path_table`` / ``path_code``."""
    if path_table is None or path_code is None:
        t, c = _default_tree_paths(int(num_classes))
        path_table = torch.as_tensor(t, device=input.device)
        path_code = torch.as_tensor(c, device=input.device)
    lab = label.reshape(-1).long()
    tbl = path_table[lab]                               # [N, D]
    code = path_code[lab].to(input.dtype)
    idx = torch.clamp(tbl, min=0)
    logits = torch.einsum("nde,ne->nd", weight[idx], input)
    if bias is not None:
        logits = logits + bias.reshape(-1)[idx]
    loss = -(code * tF.logsigmoid(logits)
             + (1 - code) * tF.logsigmoid(-logits))
    return torch.sum(torch.where(tbl >= 0, loss, torch.zeros_like(loss)),
                     dim=1, keepdim=True)


@defop
def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean", name=None):
    """ArcFace family: the logits are cosines; the target's angle becomes
    cos(m1 * theta + m2) - m3, everything scales by s, then softmax cross
    entropy.  Cosines are clipped to +-(1 - 1e-6) first (arccos'
    derivative is infinite at +-1)."""
    oh = tF.one_hot(label.reshape(-1).long(), logits.shape[-1]).to(
        logits.dtype)
    eps = 1e-6
    cos = torch.clamp(logits, -1.0 + eps, 1.0 - eps)
    target = torch.cos(margin1 * torch.arccos(cos) + margin2) - margin3
    logp = torch.log_softmax(torch.where(oh > 0, target, cos) * scale, dim=-1)
    loss = -torch.sum(oh * logp, dim=-1, keepdim=True)
    if reduction == "mean":
        loss = torch.mean(loss)
    elif reduction == "sum":
        loss = torch.sum(loss)
    elif reduction is not None and reduction != "none":
        raise ValueError(f"bad reduction {reduction}")
    if return_softmax:
        return loss, torch.exp(logp)
    return loss


@defop
def sparse_attention(query, key, value, sparse_csr_offset,
                     sparse_csr_columns, key_padding_mask=None,
                     attn_mask=None, name=None):
    """Attention restricted to a CSR pattern (offsets [B, H, L + 1],
    columns [B, H, nnz]), as a dense [B, H, L, L] mask over the scores;
    a position outside the pattern gets probability 0."""
    b, h, L, d = query.shape
    # the JAX package divides by a numpy float64 scalar, which promotes the
    # scores (and so the output) to float64
    scores = torch.einsum("bhld,bhmd->bhlm", query, key).double() / np.sqrt(d)
    nnz = sparse_csr_columns.shape[-1]
    # entry j of the columns belongs to the row whose offset range holds j
    pos = torch.arange(nnz, device=query.device).expand(b, h, nnz)
    rows = torch.clamp(torch.searchsorted(
        sparse_csr_offset.contiguous(), pos.contiguous(), right=True) - 1,
        0, L - 1)
    mask = torch.zeros((b, h, L * L), dtype=torch.bool, device=query.device)
    mask = mask.scatter(2, rows * L + sparse_csr_columns.long(),
                        True).reshape(b, h, L, L)
    neg = torch.tensor(torch.finfo(torch.float32).min, dtype=scores.dtype,
                       device=scores.device)
    scores = torch.where(mask, scores, neg)
    if attn_mask is not None:
        scores = scores + attn_mask
    if key_padding_mask is not None:
        scores = torch.where(key_padding_mask[:, None, None, :] > 0, scores,
                             neg)
    probs = torch.where(mask, torch.softmax(scores, dim=-1),
                        torch.zeros_like(scores))
    return torch.einsum("bhlm,bhmd->bhld", probs, value.to(probs.dtype))


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format="NCL", name=None):
    """``max_unpool2d`` over a height of 1."""
    out_sz = None if output_size is None else \
        list(output_size[:-1]) + [1, output_size[-1]]
    out = max_unpool2d(x.unsqueeze(-2), indices.unsqueeze(-2),
                       (1, kernel_size), (1, stride or kernel_size),
                       padding, out_sz, data_format="NCHW")
    return out.squeeze(-2)


def _triple(v):
    return (v,) * 3 if isinstance(v, int) else tuple(v)


@defop(register=False)
def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format="NCDHW", name=None):
    """Pooled values scattered back along D, H, W to the flat positions
    ``max_pool3d(return_mask=True)`` recorded."""
    ks = _triple(kernel_size)
    st = ks if stride is None else _triple(stride)
    pd = _triple(padding)
    n, c, dd, hh, ww = x.shape
    if output_size is None:
        od, oh, ow = ((s - 1) * t + k - 2 * p for s, t, k, p in
                      zip((dd, hh, ww), st, ks, pd))
    else:
        od, oh, ow = output_size[-3:]
    flat = torch.zeros((n, c, od * oh * ow), dtype=x.dtype, device=x.device)
    bi = torch.arange(n, device=x.device)[:, None, None]
    ci = torch.arange(c, device=x.device)[None, :, None]
    return _set(flat, (bi, ci, indices.reshape(n, c, -1).long()),
                x.reshape(n, c, -1)).reshape(n, c, od, oh, ow)


# -- in-place activation forms: the Tensor rebinds to the result ------------

def elu_(x, alpha=1.0, name=None):
    from .activation import elu
    return _inplace(x, elu(x, alpha))


def softmax_(x, axis=-1, dtype=None, name=None):
    from .activation import softmax
    return _inplace(x, softmax(x, axis=axis, dtype=dtype))


def tanh_(x, name=None):
    from ...ops.math import tanh
    return _inplace(x, tanh(x))
