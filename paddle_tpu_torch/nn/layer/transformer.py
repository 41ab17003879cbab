"""``MultiHeadAttention`` (``paddle_tpu.nn.layer.transformer``'s): the
projections ``q_proj``, ``k_proj``, ``v_proj`` and ``out_proj`` are the
port's ``Linear`` (``[out, in]`` weights; ``models.convert`` transposes
the JAX package's ``[in, out]``), heads are ``[B, T, num_heads,
head_dim]``.

* Without ``need_weights`` the heads go through
  ``F.scaled_dot_product_attention``: a call with no mask and no dropout
  in training launches the flash kernels on the card (rows 1 and 2:
  ``flash_attention_bthd`` and its backward), a masked call or dropout
  takes the plain attention, as in the JAX package.
* ``need_weights=True`` is the JAX layer's explicit path: scores divided
  by ``sqrt(head_dim)``, a boolean mask as ``where(mask, s, -1e30)`` and
  any other mask added, softmax in the scores' dtype, no dropout; it also
  returns the weights ``[B, H, Tq, Tk]``.
* ``cache``: a ``Cache`` (from ``gen_cache``, empty) gets this call's
  keys and values appended and comes back updated; a ``StaticCache``
  (``gen_cache(key, value, type=StaticCache)``) supplies projected keys
  and values and comes back as it was.

The return is ``out``, or the tuple ``(out[, weights][, cache])``.
"""
from __future__ import annotations

import collections
import math

import torch
from torch import nn

from .. import functional as F
from .common import Linear

__all__ = ["MultiHeadAttention"]


class MultiHeadAttention(nn.Module):
    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.dropout = dropout
        self.need_weights = need_weights
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)
        self.k_proj = Linear(self.kdim, embed_dim, weight_attr, bias_attr)
        self.v_proj = Linear(self.vdim, embed_dim, weight_attr, bias_attr)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)

    def _reshape_heads(self, x):
        return x.reshape(x.shape[0], x.shape[1], self.num_heads,
                         self.head_dim)

    def gen_cache(self, key, value=None, type=Cache):  # noqa: A002
        if type == MultiHeadAttention.StaticCache:
            k = self._reshape_heads(self.k_proj(key))
            v = self._reshape_heads(self.v_proj(
                value if value is not None else key))
            return self.StaticCache(k, v)
        k = torch.zeros(key.shape[0], 0, self.num_heads, self.head_dim,
                        device=key.device)
        return self.Cache(k, k)

    def _weights_path(self, q, k, v, mask):
        qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
        scores = torch.matmul(qh, kh.transpose(-1, -2)) / math.sqrt(
            qh.shape[-1])
        if mask is not None:
            if mask.dtype == torch.bool:
                scores = torch.where(mask, scores,
                                     torch.full_like(scores, -1e30))
            else:
                scores = scores + mask
        w = torch.softmax(scores, dim=-1)
        o = torch.matmul(w, vh).transpose(1, 2)
        return o.reshape(o.shape[0], o.shape[1], -1), w

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._reshape_heads(self.q_proj(query))
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
            new_cache = cache
        else:
            k = self._reshape_heads(self.k_proj(key))
            v = self._reshape_heads(self.v_proj(value))
            if isinstance(cache, self.Cache):
                k = torch.cat([cache.k.to(k.dtype), k], dim=1)
                v = torch.cat([cache.v.to(v.dtype), v], dim=1)
                new_cache = self.Cache(k, v)
            else:
                new_cache = None
        weights = None
        if self.need_weights:
            out, weights = self._weights_path(q, k, v, attn_mask)
        else:
            out = F.scaled_dot_product_attention(
                q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
                training=self.training)
            out = out.reshape(out.shape[0], out.shape[1], self.embed_dim)
        out = self.out_proj(out)
        outs = [out]
        if self.need_weights:
            outs.append(weights)
        if cache is not None:
            outs.append(new_cache)
        return out if len(outs) == 1 else tuple(outs)
