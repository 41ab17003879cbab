"""Neighbour sampling and reindexing (``paddle_tpu.geometric.sampling``
counterparts): ``sample_neighbors``, ``reindex_graph``,
``reindex_heter_graph``.

Their output shapes depend on the data, so, as in the JAX package, they
run on the host in numpy, line for line the JAX functions: the same seed
draws the same neighbours.  ``sample_neighbors`` draws from a module
generator seeded lazily from the framework seed (``paddle.seed``) at its
first call, which then advances with every call; a ``perm_buffer`` pins
a generator of its own.  Inputs on the card are copied to the host (one
sync each), and the outputs go to the device of ``row`` (``x`` for the
reindexing): surface Tensors in, or numpy arrays, give Tensors out (numpy
ones on the current place); bare torch tensors give torch tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import Tensor

__all__ = ["sample_neighbors", "reindex_graph", "reindex_heter_graph"]


def _np(x):
    if isinstance(x, Tensor):
        return np.asarray(x.numpy())
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _out(like):
    """How outputs are returned for the input ``like``: torch tensors on
    its device for a bare torch tensor, else Tensors on its device (the
    current place for host data)."""
    if torch.is_tensor(like):
        return lambda a: torch.from_numpy(a).to(like.device)
    place = like.place if isinstance(like, Tensor) else None
    return lambda a: Tensor(a, place=place)


_rng = None


def _module_rng() -> np.random.Generator:
    """Lazily seeded from the framework seed, then advances per call."""
    global _rng
    if _rng is None:
        from ..core import random as random_mod
        _rng = np.random.default_rng(int(random_mod._seed or 0))
    return _rng


def sample_neighbors(row, colptr, input_nodes, sample_size=-1, eids=None,
                     return_eids=False, perm_buffer=None, name=None):
    """Sample up to ``sample_size`` neighbours of each input node from a
    CSC graph (``row``: the concatenated neighbour lists, ``colptr``: each
    node's offsets).  Returns ``(out_neighbors, out_count[, out_eids])``:
    counts align with ``input_nodes``, neighbours are concatenated in
    input order."""
    if return_eids and eids is None:
        raise ValueError("`eids` should not be None if `return_eids` is "
                         "True.")
    out = _out(row)
    row_np = _np(row).reshape(-1)
    colptr_np = _np(colptr).reshape(-1)
    nodes = _np(input_nodes).reshape(-1)
    eids_np = _np(eids).reshape(-1) if eids is not None else None
    rng = _module_rng() if perm_buffer is None else \
        np.random.default_rng(int(_np(perm_buffer).reshape(-1)[0]) & 0xFFFF)

    out_neigh, out_eids, counts = [], [], []
    for u in nodes:
        lo, hi = int(colptr_np[u]), int(colptr_np[u + 1])
        idx = np.arange(lo, hi)
        if 0 <= sample_size < len(idx):
            idx = rng.choice(idx, size=sample_size, replace=False)
        counts.append(len(idx))
        out_neigh.append(row_np[idx])
        if eids_np is not None:
            out_eids.append(eids_np[idx])
    dtype = row_np.dtype
    neighbors = out(np.concatenate(out_neigh).astype(dtype)
                    if out_neigh else np.zeros((0,), dtype))
    count = out(np.asarray(counts, np.int32))
    if return_eids:
        e = out(np.concatenate(out_eids).astype(dtype)
                if out_eids else np.zeros((0,), dtype))
        return neighbors, count, e
    return neighbors, count


def reindex_graph(x, neighbors, count, value_buffer=None, index_buffer=None,
                  name=None):
    """Number the sampled nodes from 0: ``out_nodes`` is ``x`` followed by
    the neighbours not in it, in first-appearance order; ``reindex_src``
    maps ``neighbors`` into that numbering and ``reindex_dst`` repeats each
    input node's new id ``count`` times."""
    out = _out(x)
    x_np = _np(x).reshape(-1)
    nb = _np(neighbors).reshape(-1)
    cnt = _np(count).reshape(-1)
    mapping = {int(v): i for i, v in enumerate(x_np)}
    order = list(x_np)
    for v in nb:
        vi = int(v)
        if vi not in mapping:
            mapping[vi] = len(order)
            order.append(vi)
    dtype = x_np.dtype
    reindex_src = np.asarray([mapping[int(v)] for v in nb], dtype)
    reindex_dst = np.repeat(np.arange(len(x_np), dtype=dtype), cnt)
    return (out(reindex_src), out(reindex_dst),
            out(np.asarray(order, dtype)))


def reindex_heter_graph(x, neighbors, count, value_buffer=None,
                        index_buffer=None, name=None):
    """:func:`reindex_graph` for a heterogeneous graph: ``neighbors`` and
    ``count`` are lists, one per edge type, numbered in one id space."""
    out = _out(x)
    x_np = _np(x).reshape(-1)
    mapping = {int(v): i for i, v in enumerate(x_np)}
    order = list(x_np)
    srcs, dsts = [], []
    dtype = x_np.dtype
    for nb_t, cnt_t in zip(neighbors, count):
        nb = _np(nb_t).reshape(-1)
        cnt = _np(cnt_t).reshape(-1)
        for v in nb:
            vi = int(v)
            if vi not in mapping:
                mapping[vi] = len(order)
                order.append(vi)
        srcs.append(np.asarray([mapping[int(v)] for v in nb], dtype))
        dsts.append(np.repeat(np.arange(len(x_np), dtype=dtype), cnt))
    return (out(np.concatenate(srcs) if srcs else np.zeros((0,), dtype)),
            out(np.concatenate(dsts) if dsts else np.zeros((0,), dtype)),
            out(np.asarray(order, dtype)))
