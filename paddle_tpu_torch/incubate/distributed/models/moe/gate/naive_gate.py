"""``NaiveGate`` (``paddle_tpu/incubate/.../moe/gate/naive_gate.py``): a
linear scorer, top-k over the softmax *probabilities* (not the logits), no
balance loss."""
from __future__ import annotations

import torch
from torch import nn

from .base_gate import BaseGate

__all__ = ["NaiveGate"]


class NaiveGate(BaseGate):
    """Returns ``(values [N, k], indices [N, k])``: the k largest router
    probabilities and their experts (int64), largest first.  The values
    are what the layer scales expert outputs by (Switch's ``p_top1``; for
    k > 1 the layer renormalises among the selected, GShard's
    softmax-then-renormalise)."""

    def __init__(self, d_model, num_expert, world_size, topk=2):
        super().__init__(num_expert, world_size)
        self.gate = nn.Linear(d_model, self.tot_expert)
        self.top_k = topk

    def score(self, inp):
        return self.gate(inp)

    def forward(self, inp, return_all_scores=False):
        score = self.gate(inp)
        val, idx = torch.topk(torch.softmax(score, dim=-1), self.top_k,
                              dim=-1)
        if return_all_scores:
            return val, idx, score
        return val, idx
