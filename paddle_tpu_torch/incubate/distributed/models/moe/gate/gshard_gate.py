"""``GShardGate`` (``paddle_tpu/incubate/.../moe/gate/gshard_gate.py``):
top-2 with the GShard balance loss and, in training, random routing of the
second expert."""
from __future__ import annotations

import torch

from .naive_gate import NaiveGate

__all__ = ["GShardGate"]


class GShardGate(NaiveGate):
    """The balance loss ``E * sum_e(mean_prob_e * top1_fraction_e)`` is
    computed from the top-1 choice *before* random routing.  In training
    only, the second expert is dropped (index -1) where ``u >= 2 * p2``,
    ``u ~ U[0, 1)`` a token, drawn from ``generator`` (torch's default
    generator when None): the JAX draw's distribution, not its bits.
    ``capacity`` is the (train, eval) capacity factor pair the layer
    uses."""

    def __init__(self, d_model, num_expert, world_size, topk=2,
                 capacity=(1.2, 2.4), random_routing=True, group=None,
                 generator=None):
        if topk != 2:
            raise ValueError("topk should be 2 in GShardGate")
        super().__init__(d_model, num_expert, world_size, topk=2)
        self.capacity = capacity
        self.random_routing = random_routing
        self.group = group
        self.generator = generator

    def forward(self, x):
        val, idx, score = super().forward(x, return_all_scores=True)
        e = self.tot_expert
        probs = torch.softmax(score, dim=-1)
        top1 = idx[:, 0, None] == torch.arange(e, device=idx.device)
        self.set_loss((probs.mean(0) * top1.to(probs.dtype).mean(0)).sum()
                      * float(e))
        if self.random_routing and self.training:
            u = torch.rand(score.shape[0], generator=self.generator,
                           device=score.device, dtype=score.dtype)
            second = torch.where(u < 2.0 * val[:, 1], idx[:, 1],
                                 torch.full_like(idx[:, 1], -1))
            idx = torch.stack([idx[:, 0], second], dim=-1)
        return val, idx
