"""Sparse 3-D convolution and max pooling over NDHWC COO input
(``paddle_tpu.sparse``'s ``conv3d``, ``subm_conv3d``, ``max_pool3d``).

The rulebook pairs each input site with the output site it reaches
through each kernel offset.  The JAX package builds it on the host; the
port builds it on the device, with the same pairs and output order:

* a site ``(b, z, y, x)`` is one int64 key, row-major, so sorted keys are
  ``np.unique(axis=0)``'s order (``sparse.tensor.pack_keys``);
* for every offset ``o`` at once, an input site reaches the output
  coordinate ``(in + pad - o * dilation) / stride`` where that divides
  evenly and lies inside the output grid;
* submanifold (``subm``): the output sites are the input sites, and a
  candidate is matched to them with ``searchsorted`` over the sorted
  input keys (the JAX ``_match_rows``);
* otherwise the output sites are ``torch.unique`` of the candidates'
  keys, whose size is the one host read of a layer.

The rulebook is a ``[K, n_in]`` table of output rows, so no other size
is read back.  Where offset ``k`` takes input ``i`` nowhere, the entry is
a spare row of that input's own, ``n_out + i``: the pairs that do not
exist are computed and dropped, and their atomic adds never meet on one
row (one shared spare row made the card serialise millions of them).
It is cached on the input's indices tensor itself (no copy to the host)
and the geometry: consecutive submanifold layers over the same sites
share one rulebook, as a SECOND backbone's layers with one
``indice_key`` do, and a strided layer's output sites (a tensor it made)
key the next layers.

The value compute never gathers a ``[pairs, Ci, Co]`` weight copy: for
each offset, one ``torch.mm`` of the input values against ``w[offset]``
and an ``index_add`` into the output rows (the spare rows take the pairs
that do not exist), then the bias.  The sum is the JAX einsum's;
the atomics of ``index_add`` make it not repeatable bit for bit, so the
tests hold it to a tolerance.  Max pooling is one ``scatter_reduce``
("amax", ``include_self=False``) over every pair: implicit zeros never
take part.
"""
from __future__ import annotations

import collections

import numpy as np
import torch

from ..core.tensor import Tensor
from .tensor import SparseCooTensor, _surface, as_coo, pack_keys, \
    unpack_keys

__all__ = ["conv3d", "subm_conv3d", "max_pool3d", "Rulebook",
           "build_rulebook", "rulebook_pairs", "rulebook_stats"]

Rulebook = collections.namedtuple(
    "Rulebook", "table out_idx out_spatial n_out")
Rulebook.__doc__ = """``table`` ``[K, n_in]`` int64: the output row each
input site ``i`` reaches through offset ``k`` (the spare row ``n_out + i``
where it reaches none); ``out_idx`` ``[n_out, 4]``; ``out_spatial`` the
output grid."""

_CACHE: dict = {}
_CACHE_SIZE = 32
_STATS = {"built": 0, "reused": 0}


def rulebook_stats(reset: bool = False) -> dict:
    """Rulebooks built and reused since the last reset."""
    out = dict(_STATS)
    if reset:
        _STATS.update(built=0, reused=0)
    return out


def _to3(v):
    return (int(v),) * 3 if isinstance(v, (int, np.integer)) else \
        tuple(int(a) for a in v)


def _out_spatial(spatial, ksize, pads, dils, strs, subm):
    if subm:
        return tuple(spatial)
    return tuple((spatial[d] + 2 * pads[d] - dils[d] * (ksize[d] - 1) - 1)
                 // strs[d] + 1 for d in range(3))


def build_rulebook(idx: torch.Tensor, batch: int, spatial, ksize, pads,
                   dils, strs, subm: bool) -> Rulebook:
    """The rulebook of ``idx`` ``[n, 4]`` (batch, z, y, x) on its device;
    cached on ``idx`` itself and the geometry."""
    key = (id(idx), int(batch), tuple(spatial), tuple(ksize), tuple(pads),
           tuple(dils), tuple(strs), bool(subm))
    hit = _CACHE.get(key)
    if hit is not None and hit[0] is idx:
        _STATS["reused"] += 1
        return hit[1]
    rb = _build(idx, batch, spatial, ksize, pads, dils, strs, subm)
    if len(_CACHE) >= _CACHE_SIZE:
        _CACHE.clear()
    _CACHE[key] = (idx, rb)
    _STATS["built"] += 1
    return rb


def _build(idx, batch, spatial, ksize, pads, dils, strs, subm):
    out_sp = _out_spatial(spatial, ksize, pads, dils, strs, subm)
    dev = idx.device
    n_in = idx.shape[0]
    k_all = ksize[0] * ksize[1] * ksize[2]
    o = torch.arange(k_all, device=dev)
    offs = (o // (ksize[1] * ksize[2]), (o // ksize[2]) % ksize[1],
            o % ksize[2])
    ok = torch.ones((k_all, n_in), dtype=torch.bool, device=dev)
    coords = [idx[:, 0].expand(k_all, n_in)]
    for d in range(3):
        num = idx[:, 1 + d].unsqueeze(0) + pads[d] \
            - offs[d].unsqueeze(1) * dils[d]
        out_c = torch.div(num, strs[d], rounding_mode="floor")
        ok &= (num % strs[d] == 0) & (out_c >= 0) & (out_c < out_sp[d])
        coords.append(out_c)
    dims = (int(batch),) + out_sp
    cand = pack_keys(torch.stack([c.reshape(-1) for c in coords], 1)
                     .clamp_min(0), dims).reshape(k_all, n_in)
    spare = torch.arange(n_in, device=dev).expand(k_all, n_in)
    if subm:
        in_keys = pack_keys(idx, dims)
        sorted_keys, order = torch.sort(in_keys)
        pos = torch.searchsorted(sorted_keys, cand).clamp_max(
            max(n_in - 1, 0))
        hit = ok & (sorted_keys[pos] == cand) if n_in else ok
        return Rulebook(torch.where(hit, order[pos], n_in + spare), idx,
                        out_sp, n_in)
    # the missing pairs' key sorts last and is always present: n_out =
    # len - 1
    last = int(np.prod(dims, dtype=object))
    cand = torch.where(ok, cand, torch.full_like(cand, last))
    uniq, inv = torch.unique(
        torch.cat([cand.reshape(-1), cand.new_full((1,), last)]),
        sorted=True, return_inverse=True)
    n_out = uniq.shape[0] - 1
    table = torch.where(ok, inv[:-1].reshape(k_all, n_in), n_out + spare)
    return Rulebook(table, unpack_keys(uniq[:-1], dims), out_sp, n_out)


def rulebook_pairs(rb: Rulebook):
    """``(pairs_in, pairs_out, pairs_off)`` int64 tensors of every pair,
    offset-major (the JAX ``_build_rulebook``'s order).  Reads sizes back:
    for checks, not for the forward."""
    off, pin = torch.nonzero(rb.table < rb.n_out, as_tuple=True)
    return pin, rb.table[off, pin], off


def _check_conv_args(data_format, groups=1, ceil_mode=False):
    if data_format != "NDHWC":
        raise NotImplementedError(
            f"sparse conv/pool supports data_format='NDHWC' only "
            f"(got {data_format!r}); permute with sparse.transpose")
    if groups != 1:
        raise NotImplementedError("sparse conv3d groups>1")
    if ceil_mode:
        raise NotImplementedError("sparse max_pool3d ceil_mode=True")


def _rulebook_of(x: SparseCooTensor, ksize, padding, dilation, stride,
                 subm):
    return build_rulebook(x._idx, x._shape[0], tuple(x._shape[1:4]), ksize,
                          _to3(padding), _to3(dilation), _to3(stride), subm)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NDHWC", name=None, subm=False):
    """Sparse 3-D convolution of COO ``[N, D, H, W, C]`` by ``weight``
    ``[kd, kh, kw, Ci, Co]``; ``subm=True`` keeps the input's sites."""
    _check_conv_args(data_format, groups)
    x = as_coo(x)
    w = _surface(weight)._value
    kd, kh, kw, ci, co = (int(s) for s in w.shape)
    rb = _rulebook_of(x, (kd, kh, kw), padding, dilation, stride, subm)
    vals = x._vt._value
    w2 = w.reshape(kd * kh * kw, ci, co)
    out = torch.zeros((rb.n_out + vals.shape[0], co), dtype=vals.dtype,
                      device=vals.device)
    for k in range(w2.shape[0]):
        out.index_add_(0, rb.table[k], torch.mm(vals, w2[k]))
    out = out[:rb.n_out]
    if bias is not None:
        out = out + _surface(bias)._value
    return SparseCooTensor(rb.out_idx, Tensor._wrap(out),
                           (x._shape[0], *rb.out_spatial, co))


def subm_conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1,
                groups=1, data_format="NDHWC", name=None):
    return conv3d(x, weight, bias, stride, padding, dilation, groups,
                  data_format, name, subm=True)


def max_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               data_format="NDHWC", name=None):
    """Sparse max pooling: each channel's maximum over the input sites an
    output site covers (implicit zeros never take part)."""
    _check_conv_args(data_format, ceil_mode=ceil_mode)
    x = as_coo(x)
    ks = _to3(kernel_size)
    rb = _rulebook_of(x, ks, padding, 1,
                      kernel_size if stride is None else stride, False)
    vals = x._vt._value
    c = vals.shape[-1]
    k_all = rb.table.shape[0]
    src = vals.unsqueeze(0).expand(k_all, -1, -1).reshape(-1, c)
    index = rb.table.reshape(-1, 1).expand(-1, c)
    out = torch.zeros((rb.n_out + vals.shape[0], c), dtype=vals.dtype,
                      device=vals.device).scatter_reduce(
        0, index, src, "amax", include_self=False)
    return SparseCooTensor(rb.out_idx, Tensor._wrap(out[:rb.n_out]),
                           (x._shape[0], *rb.out_spatial, c))
