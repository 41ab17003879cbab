"""``softmax_mask_fuse_upper_triangle`` (``paddle_tpu.incubate.operators``
counterpart): the causal softmax without a mask tensor, in torch ops.
Future positions take the dtype's ``finfo.min`` (f32 for an integer
input), as in the JAX package, not -inf."""
from __future__ import annotations

import torch

from ...core.op import defop

__all__ = ["softmax_mask_fuse_upper_triangle"]


@defop
def softmax_mask_fuse_upper_triangle(x):
    """``x``: ``[B, H, T, T]`` scores; masks the strict upper triangle
    before the softmax."""
    t = x.shape[-1]
    keep = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    low = torch.finfo(x.dtype if x.is_floating_point()
                      else torch.float32).min
    masked = torch.where(keep, x, torch.full((), low, dtype=x.dtype,
                                             device=x.device))
    return torch.softmax(masked, dim=-1)
