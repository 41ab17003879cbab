"""``ClipGradForMOEByGlobalNorm`` (``paddle_tpu/incubate/.../moe/
grad_clip.py``).

The reference norms the replicated parameters and the experts in two
parts across the expert group; on one device both parts are one sum, so
this is :class:`ClipGradByGlobalNorm` (f32 global norm, scale ``min(1,
clip_norm / max(gn, 1e-12))``, on the device) over every gradient whose
parameter is clipped (``need_clip``, default True).  ``is_expert_param_func``
is kept for the reference's surface; a ``moe_group`` of more than one rank
raises (ROADMAP module entry 11).
"""
from __future__ import annotations

from .....nn.clip import ClipGradByGlobalNorm
from .utils import group_size

__all__ = ["ClipGradForMOEByGlobalNorm"]


class ClipGradForMOEByGlobalNorm(ClipGradByGlobalNorm):
    def __init__(self, clip_norm, is_expert_param_func=None, moe_group=None,
                 group_name="default_moe_group"):
        if group_size(moe_group) > 1:
            raise NotImplementedError(
                f"the MoE clip over a moe_group of {group_size(moe_group)} "
                f"ranks is not ported yet: ROADMAP module entry 11")
        super().__init__(clip_norm, group_name=group_name)
        self.is_expert_param_func = is_expert_param_func
        self.moe_group = moe_group

    def __call__(self, params_grads):
        """``[(param, grad)]`` with the clipped gradients as copies; a
        parameter with ``need_clip`` False keeps its gradient and adds
        nothing to the norm."""
        clip = [g is not None and getattr(p, "need_clip", True)
                for p, g in params_grads]
        clipped = iter(self.clip_list(
            [g for (_, g), c in zip(params_grads, clip) if c]))
        return [(p, next(clipped) if c else g)
                for (p, g), c in zip(params_grads, clip)]
