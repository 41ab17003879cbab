"""``paddle_tpu.geometric`` counterparts: message passing (``send_u_recv``,
``send_ue_recv``, ``send_uv``), the segment reductions and, from
:mod:`.sampling`, neighbour sampling and reindexing.

The reductions are torch scatters on the input's device: ``index_add``
for sum and mean, ``scatter_reduce`` (``amax`` / ``amin``,
``include_self=False`` into zeros) for max and min.  They keep the JAX
package's semantics:

* mean divides the sum by ``max(count, 1)``, the count and the division
  in f32, and casts back to the values' type;
* max and min write 0 to a segment no id names (not the identity);
* an id outside ``[0, n)`` is dropped, as ``jax.ops.segment_*`` drops
  it: such ids go to a spare row ``n`` that is cut off, so the device
  never checks them and nothing waits for it.

Gradients are torch's: ``index_add``'s for sum and mean, ``scatter_
reduce``'s for max and min (split evenly between tied maxima).  A call
without ``num_segments`` (``segment_*``) sizes its output from the ids,
``max(ids) + 1``: that reads one number back from the device, the one
host sync of these functions.  ``send_*`` size it from ``out_size`` or
the number of nodes, with no sync.

Surface Tensors in give Tensors out; bare torch tensors give torch
tensors (``core.op.apply_op``).
"""
from __future__ import annotations

import torch

from ..core.op import apply_op
from .sampling import (  # noqa: F401
    reindex_graph, reindex_heter_graph, sample_neighbors)

__all__ = ["send_u_recv", "send_ue_recv", "send_uv", "segment_sum",
           "segment_mean", "segment_max", "segment_min",
           "sample_neighbors", "reindex_graph", "reindex_heter_graph"]

_POOLS = ("sum", "mean", "max", "min")
_MESSAGES = ("add", "sub", "mul", "div")


def _index(ids, like):
    """``ids`` (a torch tensor, numpy array or list) as int64 on
    ``like``'s device."""
    return torch.as_tensor(ids, device=like.device).long()


def _ids(dst, n):
    """``dst`` as int64 with every id outside ``[0, n)`` sent to the
    spare row ``n``."""
    return torch.where((dst >= 0) & (dst < n), dst,
                       torch.full_like(dst, n))


def _seg_reduce(vals, dst, pool, n):
    """Reduce the rows of ``vals`` into ``n`` segments by ``dst``."""
    ids = _ids(dst, n)
    rows = (n + 1,) + tuple(vals.shape[1:])
    if pool in ("sum", "mean"):
        s = vals.new_zeros(rows).index_add(0, ids, vals)[:n]
        if pool == "sum":
            return s
        # the count in f32: bf16 holds no integer past 256 exactly
        cnt = torch.zeros(n + 1, dtype=torch.float32,
                          device=vals.device).index_add(
            0, ids, torch.ones(ids.shape, dtype=torch.float32,
                               device=vals.device))[:n]
        cnt = cnt.clamp(min=1.0).reshape((-1,) + (1,) * (vals.dim() - 1))
        return (s.float() / cnt).to(vals.dtype)
    idx = ids.reshape((-1,) + (1,) * (vals.dim() - 1)).expand(vals.shape)
    # include_self=False: a touched segment takes only its rows, an
    # untouched one keeps the 0 it starts with (the JAX package's value)
    return vals.new_zeros(rows).scatter_reduce(
        0, idx, vals, "amax" if pool == "max" else "amin",
        include_self=False)[:n]


def _message(a, b, op):
    if op == "add":
        return a + b
    if op == "sub":
        return a - b
    if op == "mul":
        return a * b
    return a / b


def send_u_recv(x, src_index, dst_index, reduce_op="sum", out_size=None,
                name=None):
    """Gather ``x[src]`` and reduce at ``dst`` into ``out_size`` rows
    (default: as many as ``x`` has)."""
    pool = reduce_op.lower()
    if pool not in _POOLS:
        raise ValueError(f"unknown reduce_op {reduce_op!r}")

    def raw(xv, si, di):
        n = out_size if out_size is not None else xv.shape[0]
        return _seg_reduce(xv.index_select(0, _index(si, xv)),
                           _index(di, xv), pool, int(n))

    return apply_op(raw, "graph_send_recv", (x, src_index, dst_index), {})


def send_ue_recv(x, y, src_index, dst_index, message_op="add",
                 reduce_op="sum", out_size=None, name=None):
    """Combine the node features ``x[src]`` with the edge features ``y``
    by ``message_op`` and reduce at ``dst``."""
    pool, comb = reduce_op.lower(), message_op.lower()
    if pool not in _POOLS:
        raise ValueError(f"unknown reduce_op {reduce_op!r}")
    if comb not in _MESSAGES:
        raise ValueError(f"unknown message_op {message_op!r}")

    def raw(xv, yv, si, di):
        m = _message(xv.index_select(0, _index(si, xv)), yv, comb)
        n = out_size if out_size is not None else xv.shape[0]
        return _seg_reduce(m, _index(di, xv), pool, int(n))

    return apply_op(raw, "graph_send_ue_recv", (x, y, src_index, dst_index),
                    {})


def send_uv(x, y, src_index, dst_index, message_op="add", name=None):
    """The per-edge message ``x[src] (op) y[dst]``."""
    comb = message_op.lower()
    if comb not in _MESSAGES:
        raise ValueError(f"unknown message_op {message_op!r}")

    def raw(xv, yv, si, di):
        return _message(xv.index_select(0, _index(si, xv)),
                        yv.index_select(0, _index(di, yv)), comb)

    return apply_op(raw, "graph_send_uv", (x, y, src_index, dst_index), {})


def _segment(pool):
    def fn(data, segment_ids, num_segments=None, name=None):
        def raw(d, s):
            s = _index(s, d)
            if num_segments is not None:
                n = int(num_segments)
            else:                 # the one host sync: max(ids) + 1
                n = int(s.max()) + 1 if s.numel() else 0
            return _seg_reduce(d, s, pool, n)

        return apply_op(raw, f"segment_{pool}", (data, segment_ids), {})

    fn.__name__ = fn.__qualname__ = f"segment_{pool}"
    fn.__doc__ = (f"The {pool} of ``data``'s rows by ``segment_ids`` into "
                  f"``num_segments`` rows (default ``max(ids) + 1``, one "
                  f"host sync).")
    return fn


segment_sum = _segment("sum")
segment_mean = _segment("mean")
segment_max = _segment("max")
segment_min = _segment("min")
