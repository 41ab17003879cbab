"""The single-device subset of ``paddle_tpu.distributed.spmd``:
``ShardedTrainStep`` and ``make_train_step``.

``step(*batch) -> loss`` runs forward, loss, backward and the optimizer
update on the model's device, as the JAX step does in one jitted program:

* the last ``num_labels`` batch arguments feed the loss, the rest the
  model (the JAX ``num_labels`` rule, ``spmd.py:529-540``);
* with ``compute_dtype``, floating parameters and floating model inputs
  are cast to it inside the step (``torch.func.functional_call`` over the
  cast values), so the f32 master parameters receive the gradients through
  the cast, as JAX's ``value_and_grad`` over the casting loss does; the
  labels and the loss stay in full precision;
* the loss comes back as an f32 scalar tensor (not synchronised);
* the model runs in training mode, the JAX model's default.

The twin of "one train-step compile": PyTorch runs eagerly, so nothing is
compiled; the step builds its per-signature state (the split of the batch
and the cast list) once per batch signature (shapes and dtypes) and
``compile_count`` counts the signatures.  A later CUDA-graph capture of
the step keys on the same signature.  A mesh and gradient accumulation
raise ``NotImplementedError`` (ROADMAP module item 11); the JAX step's
sharding and offload options are not taken.
"""
from __future__ import annotations

import torch

__all__ = ["ShardedTrainStep", "make_train_step"]


def _unported(what: str):
    return NotImplementedError(f"{what} is not ported yet: the port has the "
                               f"single-device step (ROADMAP module item 11)")


class _Plan:
    """The step's state for one batch signature."""

    def __init__(self, n_args, dtypes, has_loss, num_labels, compute_dtype):
        if not has_loss:
            self.x_idx, self.y_idx = list(range(n_args)), []
        elif n_args > num_labels:
            self.x_idx = list(range(n_args - num_labels))
            self.y_idx = list(range(n_args - num_labels, n_args))
        else:
            self.x_idx, self.y_idx = [0], list(range(1, n_args))
        # model inputs follow the compute dtype (AMP O2: floating inputs
        # cast with the params; labels stay full precision)
        self.cast = set() if compute_dtype is None else {
            i for i in self.x_idx if dtypes[i].is_floating_point}


class ShardedTrainStep:
    """One train step on one device; see the module docstring."""

    def __init__(self, model, optimizer, loss_fn=None, mesh=None,
                 compute_dtype=None, accumulate_steps: int = 1,
                 num_labels: int = 1):
        if mesh is not None:
            raise _unported("a device mesh")
        if accumulate_steps > 1:
            raise _unported("gradient accumulation (accumulate_steps > 1)")
        if isinstance(compute_dtype, str):
            compute_dtype = getattr(torch, compute_dtype)
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.compute_dtype = compute_dtype
        self.num_labels = num_labels
        self.device = next(model.parameters()).device
        optimizer.name_parameters(model)
        self._plans: dict = {}

    @property
    def compile_count(self) -> int:
        """Batch signatures the step has built its state for."""
        return len(self._plans)

    def _loss(self, plan, batch):
        x = [batch[i].to(self.compute_dtype) if i in plan.cast else batch[i]
             for i in plan.x_idx]
        if self.compute_dtype is None:
            out = self.model(*x)
        else:
            values = {n: (p.to(self.compute_dtype)
                          if p.is_floating_point() else p)
                      for n, p in self.model.named_parameters()}
            out = torch.func.functional_call(self.model, values, tuple(x))
        loss = out if self.loss_fn is None else self.loss_fn(
            out, *(batch[i] for i in plan.y_idx))
        if loss.dim():
            loss = loss.mean()
        return loss.float()

    def __call__(self, *batch):
        batch = tuple(torch.as_tensor(b, device=self.device) for b in batch)
        sig = tuple((tuple(b.shape), b.dtype) for b in batch)
        plan = self._plans.get(sig)
        if plan is None:
            plan = self._plans[sig] = _Plan(
                len(batch), [b.dtype for b in batch], self.loss_fn is not None,
                self.num_labels, self.compute_dtype)
        self.model.train()
        self.optimizer.clear_grad()
        loss = self._loss(plan, batch)
        loss.backward()
        self.optimizer.step()
        return loss.detach()


def make_train_step(model, optimizer, loss_fn=None,
                    **kwargs) -> ShardedTrainStep:
    return ShardedTrainStep(model, optimizer, loss_fn, **kwargs)
