"""The graph operators under their older names (``paddle_tpu.incubate.
operators.graph_ops`` counterparts), over :mod:`paddle_tpu_torch.
geometric`: ``graph_send_recv``, ``graph_sample_neighbors``,
``graph_reindex`` and ``graph_khop_sampler`` (several hops of sampling,
then one reindex over the frontiers, on the host)."""
from __future__ import annotations

import numpy as np

from ...geometric import reindex_graph, sample_neighbors, send_u_recv
from ...geometric.sampling import _np, _out

__all__ = ["graph_send_recv", "graph_sample_neighbors", "graph_reindex",
           "graph_khop_sampler"]


def graph_send_recv(x, src_index, dst_index, pool_type="sum",
                    out_size=None, name=None):
    return send_u_recv(x, src_index, dst_index, reduce_op=pool_type,
                       out_size=out_size)


def graph_sample_neighbors(row, colptr, input_nodes, eids=None,
                           perm_buffer=None, sample_size=-1,
                           return_eids=False, flag_perm_buffer=False,
                           name=None):
    return sample_neighbors(
        row, colptr, input_nodes, sample_size=sample_size, eids=eids,
        return_eids=return_eids,
        perm_buffer=perm_buffer if flag_perm_buffer else None)


def graph_reindex(x, neighbors, count, value_buffer=None, index_buffer=None,
                  flag_buffer_hashtable=False, name=None):
    return reindex_graph(x, neighbors, count, value_buffer, index_buffer)


def graph_khop_sampler(row, colptr, input_nodes, sample_sizes,
                       sorted_eids=None, return_eids=False, name=None):
    """Sample ``len(sample_sizes)`` hops from ``input_nodes``, then
    reindex the union once: returns ``edge_src, edge_dst, sample_index,
    reindex_nodes[, edge_eids]``."""
    out = _out(row)
    frontier = _np(input_nodes).reshape(-1)
    all_neigh, all_cnt, all_eids, dst_nodes = [], [], [], []
    for size in sample_sizes:
        if return_eids:
            neigh, cnt, eids = sample_neighbors(
                row, colptr, frontier, sample_size=size,
                eids=sorted_eids, return_eids=True)
            all_eids.append(_np(eids).reshape(-1))
        else:
            neigh, cnt = sample_neighbors(row, colptr, frontier,
                                          sample_size=size)
        all_neigh.append(_np(neigh).reshape(-1))
        all_cnt.append(_np(cnt).reshape(-1))
        dst_nodes.append(frontier)
        frontier = np.unique(all_neigh[-1])
    dst_cat = np.concatenate(dst_nodes)
    edge_src, edge_dst, sample_index = reindex_graph(
        out(dst_cat), out(np.concatenate(all_neigh)),
        out(np.concatenate(all_cnt).astype(np.int32)))
    # the input nodes lead reindex_graph's numbering: their new ids are
    # their positions
    n_in = len(_np(input_nodes).reshape(-1))
    reindex_nodes = out(np.arange(n_in, dtype=dst_cat.dtype))
    if return_eids:
        return (edge_src, edge_dst, sample_index, reindex_nodes,
                out(np.concatenate(all_eids)))
    return edge_src, edge_dst, sample_index, reindex_nodes
