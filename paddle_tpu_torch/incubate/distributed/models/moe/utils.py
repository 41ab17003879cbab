"""MoE routing utilities (``paddle_tpu/incubate/.../moe/utils.py``):
``_number_count``, ``_limit_by_capacity``, ``_prune_gate_by_capacity``,
``_random_routing``, and the token exchange ``global_scatter`` /
``global_gather``.

The count, limit and prune helpers are one-hot reductions on the device
(no host sync).  The exchange is the identity outside an expert-parallel
group, as in JAX outside ``shard_map``; a group of more than one rank
raises: its NCCL all-to-all is ROADMAP module entry 11.
"""
from __future__ import annotations

import torch

__all__ = ["_number_count", "_limit_by_capacity", "_prune_gate_by_capacity",
           "_random_routing", "global_scatter", "global_gather",
           "group_size"]


def _one_hot(ids, n):
    """``[..., n]`` bool: ``ids == j``; ids outside ``[0, n)`` (-1: no
    expert) match no column, as ``jax.nn.one_hot`` gives them zeros."""
    return ids[..., None] == torch.arange(n, device=ids.device)


def _number_count(numbers, upper_range):
    """int64 count of each id in ``[0, upper_range)``."""
    return _one_hot(numbers.reshape(-1), upper_range).sum(0)


def _limit_by_capacity(expert_count, capacity, n_worker):
    """Per-expert counts clamped by the per-worker capacity."""
    ec2 = expert_count.reshape(n_worker, -1) if expert_count.dim() == 1 \
        else expert_count
    cap = capacity[None, :] if capacity.dim() == 1 else capacity
    return torch.minimum(ec2, cap).reshape(expert_count.shape)


def _prune_gate_by_capacity(gate_idx, expert_count, n_expert, n_worker):
    """Gate ids set to -1 for tokens past their expert's capacity: a
    token's place within its expert is its prefix count among the tokens
    of that expert."""
    idx = gate_idx.reshape(-1)
    counts = expert_count.reshape(-1)
    total = n_expert * n_worker
    oh = _one_hot(idx, total).long()
    rank = (oh.cumsum(0) * oh).sum(1) - 1
    cap = counts[idx.clamp(0, total - 1)]
    keep = (idx >= 0) & (rank < cap)
    return torch.where(keep, idx, torch.full_like(idx, -1))


def _random_routing(topk_idx, topk_value, prob, topk=2):
    """GShard's second-expert routing: keep the second expert where
    ``prob < 2 * value``, else -1."""
    if topk != 2:
        raise ValueError("_random_routing supports topk=2 only")
    second = torch.where(prob < 2.0 * topk_value[..., 1], topk_idx[..., 1],
                         torch.full_like(topk_idx[..., 1], -1))
    return torch.stack([topk_idx[..., 0], second], dim=-1)


def group_size(group) -> int:
    """Ranks in an expert-parallel group: ``nranks`` (the JAX group's
    attribute) or ``size()`` (a ``torch.distributed`` group); 1 for
    None."""
    if group is None:
        return 1
    n = getattr(group, "nranks", None)
    if n is None and callable(getattr(group, "size", None)):
        n = group.size()
    return 1 if n is None else int(n)


def _exchange(x, group, what):
    if group_size(group) > 1:
        raise NotImplementedError(
            f"{what} over an expert-parallel group of {group_size(group)} "
            f"ranks (an NCCL all-to-all) is not ported yet: ROADMAP module "
            f"entry 11")
    return x


def global_scatter(x, local_count, global_count, group=None):
    """Tokens to their experts' ranks: the identity for one rank."""
    return _exchange(x, group, "global_scatter")


def global_gather(x, local_count, global_count, group=None):
    """Expert outputs back to the tokens' ranks: the identity for one
    rank."""
    return _exchange(x, group, "global_gather")
