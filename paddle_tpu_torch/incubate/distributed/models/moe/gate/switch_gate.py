"""``SwitchGate`` (``paddle_tpu/incubate/.../moe/gate/switch_gate.py``):
top-1 (Switch Transformer) routing with its balance loss."""
from __future__ import annotations

import torch

from .naive_gate import NaiveGate

__all__ = ["SwitchGate"]


class SwitchGate(NaiveGate):
    """In training the *logits* are multiplied by ``U[1 - eps, 1 + eps)``
    jitter (drawn from ``generator``, torch's default generator when
    None), then softmax, top-1 and the loss ``E * sum_e(mean_prob_e *
    top1_fraction_e)`` all come from the jittered probabilities.  Returns
    ``(p_top1 [N, 1], index [N, 1])``."""

    def __init__(self, d_model, num_expert, world_size, topk=1,
                 switch_eps=0.1, capacity=(1.2, 2.4), group=None,
                 generator=None):
        if topk != 1:
            raise ValueError("topk should be 1 in SwitchGate")
        super().__init__(d_model, num_expert, world_size, topk=1)
        self.switch_eps = switch_eps
        self.capacity = capacity
        self.group = group
        self.generator = generator

    def forward(self, inp):
        score = self.gate(inp)
        e = self.tot_expert
        if self.training:
            noise = torch.empty_like(score).uniform_(
                1.0 - self.switch_eps, 1.0 + self.switch_eps,
                generator=self.generator)
            score = score * noise
        probs = torch.softmax(score, dim=-1)
        val, idx = probs.max(dim=-1, keepdim=True)
        top1 = idx == torch.arange(e, device=idx.device)
        self.set_loss((probs.mean(0) * top1.to(probs.dtype).mean(0)).sum()
                      * float(e))
        return val, idx
