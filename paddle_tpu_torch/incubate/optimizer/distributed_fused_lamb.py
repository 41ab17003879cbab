"""``DistributedFusedLamb`` (``paddle_tpu.incubate.optimizer.
distributed_fused_lamb`` counterpart): ``Lamb`` tagged for sharded
optimizer state (``_sharding_stage = 1``).  On one device it is ``Lamb``;
sharding the state over ranks waits for the distributed port (ROADMAP
module entry 11), and the tag is what a sharded train step will read."""
from __future__ import annotations

from ...optimizer.optimizer import Lamb


class DistributedFusedLamb(Lamb):
    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6,
                 parameters=None, grad_clip=None,
                 exclude_from_weight_decay_fn=None,
                 clip_after_allreduce=True, is_grad_scaled_by_nranks=True,
                 use_master_param_norm=True, gradient_accumulation_steps=1,
                 use_master_acc_grad=True, nproc_per_node=None, name=None):
        super().__init__(learning_rate=learning_rate,
                         lamb_weight_decay=lamb_weight_decay,
                         beta1=beta1, beta2=beta2, epsilon=epsilon,
                         parameters=parameters, grad_clip=grad_clip,
                         exclude_from_weight_decay_fn=(
                             exclude_from_weight_decay_fn))
        self._sharding_stage = 1
        self.gradient_accumulation_steps = gradient_accumulation_steps
