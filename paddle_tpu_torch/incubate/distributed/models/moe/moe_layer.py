"""``MoELayer`` (``paddle_tpu/incubate/.../moe/moe_layer.py``): a mixture
of experts with GShard fixed-capacity dispatch, on one device.

It computes what the JAX layer computes:

* capacity ``C = max(ceil(f * k * N / E), 4)``, with ``f`` the gate's
  (train, eval) capacity pair where the gate has one (GShard, Switch), the
  layer's ``capacity_factor`` otherwise;
* each choice's weight: the gate's probability where the choice is valid
  (index >= 0), renormalised among the token's valid choices for k > 1
  (a choice later dropped for capacity still counts in the denominator);
  top-1 keeps ``p_top1``;
* k-major priority: all first choices take their expert's slots, in
  token order, before any second choice; a choice past ``C`` is dropped;
* a slot holds its token only where its weight is > 0, and the output is
  the weighted sum of the token's slots' expert outputs.

The form is not the JAX one's: instead of the dense ``[N, E, C]``
one-hot dispatch and combine einsums (at gpt2-small width, batch 16 x
1024 and E = 8 the combine tensor alone is 2.6 GB of f32 a layer), the
slot assignment is built from ``[E, kN]`` one-hots and a cumsum, the
tokens are added into an ``[E, C + 1, d]`` buffer (slot C of each expert
is a spare that takes the dropped choices and is discarded), each expert
runs on its ``[C, d]`` rows, and each token gathers its slots back,
weighted.  Every shape is fixed by N, and every step stays on the device:
no ``nonzero``, no boolean indexing, no ``.item()``.

Expert parallelism (``moe_group`` of more than one rank: the
``global_scatter`` / ``global_gather`` exchange around the experts) is
ROADMAP module entry 11; one rank needs no exchange.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as tF

from .gate import BaseGate, GShardGate, NaiveGate, SwitchGate
from .utils import group_size

__all__ = ["MoELayer"]


def _build_gate(gate, d_model, num_expert, world_size):
    if isinstance(gate, BaseGate):
        return gate
    if gate is None:
        gate = {"type": "gshard"}
    if isinstance(gate, str):
        gate = {"type": gate}
    cfg = dict(gate)
    kind = cfg.pop("type", "gshard")
    top_k = cfg.pop("top_k", 2 if kind != "switch" else 1)
    if kind == "naive":
        return NaiveGate(d_model, num_expert, world_size, topk=top_k)
    if kind == "gshard":
        return GShardGate(d_model, num_expert, world_size, topk=top_k, **cfg)
    if kind == "switch":
        return SwitchGate(d_model, num_expert, world_size, topk=top_k, **cfg)
    raise ValueError(f"unknown gate type {kind!r}")


class MoELayer(nn.Module):
    """Mixture of experts.  ``experts`` are this rank's experts (all of
    them: one rank); ``gate`` is a config dict (``{"type": "gshard" |
    "switch" | "naive", "top_k": k, ...}``), a type name or a
    :class:`BaseGate`."""

    def __init__(self, d_model, experts, gate=None, moe_group=None,
                 mp_group=None, recompute_interval=0, recompute_ctx=None,
                 capacity_factor=1.2):
        super().__init__()
        self.d_model = d_model
        self.experts = nn.ModuleList(list(experts))
        self.num_expert = len(self.experts)
        self.moe_group = moe_group
        self.world_size = group_size(moe_group)
        if self.world_size > 1:
            raise NotImplementedError(
                f"a moe_group of {self.world_size} ranks (expert "
                f"parallelism over NCCL all-to-all) is not ported yet: "
                f"ROADMAP module entry 11")
        self.capacity_factor = capacity_factor
        self.recompute_interval = recompute_interval
        self.gate = _build_gate(gate, d_model, self.num_expert,
                                self.world_size)
        self.top_k = self.gate.top_k
        if self.gate.tot_expert != self.num_expert:
            raise ValueError(
                f"{self.gate.tot_expert} global experts but "
                f"{self.num_expert} local experts on one rank")

    def _capacity(self, n_tokens: int) -> int:
        """Tokens an expert takes: from the shapes alone (no sync)."""
        factor = self.capacity_factor
        gate_cap = getattr(self.gate, "capacity", None)
        if gate_cap is not None:
            factor = gate_cap[0] if self.training else gate_cap[1]
        cap = int(math.ceil(factor * self.top_k * n_tokens /
                            self.gate.tot_expert))
        return max(cap, 4)

    def _route(self, val, idx, capacity):
        """The slot and weight of each of the ``k * N`` choices, k-major
        (choice j of token n at ``j * N + n``): ``slot = e * (C + 1) +
        position``, position C (the spare) for a dropped or invalid
        choice, whose weight is 0."""
        e_tot, k = self.gate.tot_expert, self.top_k
        valid = idx >= 0
        w = torch.where(valid, val, torch.zeros_like(val))
        if k > 1:
            w = w / w.sum(-1, keepdim=True).clamp(min=1e-9)
        e = idx.t().reshape(-1)
        w = w.t().reshape(-1)
        ok = e >= 0
        e = e.clamp(0, e_tot - 1)
        # the one-hots expert-major [E, kN]: the cumsum then runs along
        # the inner dimension (along the outer one, E = 8 columns of 32768
        # rows, CUDA's scan took 5.7 ms on the H100)
        oh = (torch.arange(e_tot, device=e.device)[:, None] == e[None]) \
            & ok[None]
        pos = oh.int().cumsum(1, dtype=torch.int32).gather(
            0, e[None]).squeeze(0) - 1
        keep = ok & (pos < capacity)
        slot = e * (capacity + 1) + torch.where(
            keep, pos, torch.full_like(pos, capacity))
        return slot, torch.where(keep, w, torch.zeros_like(w))

    def forward(self, inp):
        d = inp.shape[-1]
        tokens = inp.reshape(-1, d)
        n = tokens.shape[0]
        cap = self._capacity(n)
        e_tot, k = self.gate.tot_expert, self.top_k
        val, idx = self.gate(tokens)
        slot, w = self._route(val, idx, cap)
        # the dispatch: a slot takes its token where the weight is > 0
        src = tokens.repeat(k, 1) * (w > 0).to(tokens.dtype)[:, None]
        buf = tokens.new_zeros(e_tot * (cap + 1), d).index_add(
            0, slot, src).view(e_tot, cap + 1, d)
        out = torch.stack([expert(buf[i, :cap])
                           for i, expert in enumerate(self.experts)])
        # the combine: the spare slots read a zero row
        out = tF.pad(out, (0, 0, 0, 1)).reshape(e_tot * (cap + 1), d)
        y = out.index_select(0, slot) * w.to(out.dtype)[:, None]
        return y.view(k, n, d).sum(0).reshape(inp.shape)
