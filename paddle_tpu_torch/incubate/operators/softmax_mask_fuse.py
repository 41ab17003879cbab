"""``softmax_mask_fuse`` (``paddle_tpu.incubate.operators.
softmax_mask_fuse`` counterpart): ``softmax(x + mask)`` over the last
axis, in torch ops (the JAX package computes it with ``jax.nn.softmax``
and no Pallas kernel)."""
from __future__ import annotations

import torch

from ...core.op import defop

__all__ = ["softmax_mask_fuse"]


@defop
def softmax_mask_fuse(x, mask, name=None):
    """``x``: ``[B, H, T, T]`` scores; ``mask``: ``[B, 1, T, T]``
    additive (-10000-style)."""
    return torch.softmax(x + mask, dim=-1)
