"""``paddle_tpu.sparse.fused_attention``: attention scored only at a
sparse mask's sites (SDDMM), a softmax over each row's stored scores and
the weighted sum of ``value`` over them (SpMM)."""
from __future__ import annotations

import math

import torch

from ..core.tensor import Tensor
from .tensor import SparseCsrTensor, _value

__all__ = ["fused_attention"]


def fused_attention(query, key, value, sparse_mask, key_padding_mask=None,
                    attn_mask=None, name=None):
    """q, k, v ``[B, nh, M, hd]`` dense; ``sparse_mask`` COO or CSR,
    ``[B * nh, M, M]`` or a 2-D ``[M, M]`` pattern shared by every
    batch-head; ``key_padding_mask`` ``[B, M]`` and ``attn_mask``
    ``[M, M]`` are added to the scores.  A row's softmax divides by at
    least 1e-38, as the JAX kernel does.  Returns ``[B, nh, M, hd]``."""
    q, k, v = _value(query), _value(key), _value(value)
    b, nh, m, hd = q.shape
    mask = sparse_mask.to_sparse_coo() \
        if isinstance(sparse_mask, SparseCsrTensor) else sparse_mask
    midx = mask._idx
    if midx.shape[1] == 2:
        nnz = midx.shape[0]
        bh = torch.arange(b * nh, device=midx.device).repeat_interleave(nnz)
        row, col = midx[:, 0].repeat(b * nh), midx[:, 1].repeat(b * nh)
    else:
        bh, row, col = midx[:, 0], midx[:, 1], midx[:, 2]
    seg = bh * m + row
    qf, kf, vf = (t.reshape(b * nh, m, hd) for t in (q, k, v))
    scores = (qf[bh, row] * kf[bh, col]).sum(-1) / math.sqrt(hd)
    if key_padding_mask is not None:
        scores = scores + _value(key_padding_mask).reshape(b, m)[
            torch.div(bh, nh, rounding_mode="floor"), col]
    if attn_mask is not None:
        scores = scores + _value(attn_mask)[row, col]
    nseg = b * nh * m
    smax = torch.zeros(nseg, dtype=scores.dtype,
                       device=scores.device).scatter_reduce(
        0, seg, scores, "amax", include_self=False)
    e = torch.exp(scores - smax[seg])
    ssum = torch.zeros(nseg, dtype=e.dtype, device=e.device).index_add(
        0, seg, e)
    p = e / ssum[seg].clamp_min(1e-38)
    out = torch.zeros((nseg, hd), dtype=vf.dtype, device=vf.device)
    out = out.index_add(0, seg, p.unsqueeze(-1) * vf[bh, col])
    return Tensor._wrap(out.reshape(b, nh, m, hd))
