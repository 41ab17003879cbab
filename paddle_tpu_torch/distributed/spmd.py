"""The single-device subset of ``paddle_tpu.distributed.spmd``:
``ShardedTrainStep`` (with ``run_steps``) and ``make_train_step``.

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
* the model runs in training mode, the JAX model's default;
* buffers (batch norm's running statistics) are not cast: they stay f32
  and update in place inside the forward, as the JAX step carries its
  ``buffers`` through ``functional_call`` uncast;
* the update reads the optimizer's learning rate (its scheduler's
  ``get_lr()``) at every step and clips the gradients with its
  ``grad_clip`` first, in place and on the device: for
  ``ClipGradByGlobalNorm`` the global norm of all gradients in f32, then
  ``scale = min(1, clip_norm / max(gn, 1e-12))`` (``nn/clip.py``), the
  JAX step's rule; its bias correction counts the step's own steps
  (``t = step + 1``), as the JAX train state does.

``state_dict()`` / ``load_state_dict()`` carry the train state in the JAX
step's canonical ``train_state_v2`` layout: ``params``, ``slots``
(``{name: {slot: tensor}}``), ``buffers``, ``step``, ``opt_step_count``
and ``meta``, by the port's parameter names and shapes
(``models.convert`` maps a JAX snapshot onto them and back).  The step
updates the module's own parameters in place, so ``sync_to_model()`` has
nothing to write back.

``run_steps(*stacked)`` takes ``[K, B, ...]`` stacks of K batches and runs
K steps, returning the K losses as one f32 tensor; where the JAX step
scans them in one program, the port loops in Python (one CUDA-graph
capture of the step is later work).

The twin of "one train-step compile": PyTorch runs eagerly, so nothing is
compiled; the step builds its per-signature state (the split of the batch
and the cast list) once per batch signature (shapes and dtypes) and
``compile_count`` counts the signatures.  A later CUDA-graph capture of
the step keys on the same signature.  A mesh and gradient accumulation
raise ``NotImplementedError`` (ROADMAP module item 11); the JAX step's
sharding and offload options are not taken.
"""
from __future__ import annotations

import numpy as np
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
        self._step = 0          # the train state's step (JAX TrainState)

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
        self._step += 1
        with torch.no_grad():
            self.optimizer._apply(self._step, clip_in_place=True)
        self.optimizer._step_count += 1
        return loss.detach()

    def run_steps(self, *stacked):
        """K steps over ``[K, B, ...]`` stacks; returns the K losses."""
        stacked = tuple(torch.as_tensor(b, device=self.device)
                        for b in stacked)
        return torch.stack([self(*(b[i] for b in stacked))
                            for i in range(int(stacked[0].shape[0]))])

    # -- the train state -----------------------------------------------------
    def _entries(self):
        """(trainable parameters, everything else in the state dict): the
        JAX step's ``params`` and ``buffers``.  A parameter's second name
        (BERT's tied ``cls.decoder_weight``) is neither."""
        params = {n: p for n, p in self.model.named_parameters()
                  if p.requires_grad}
        trained = {id(p) for p in params.values()}
        buffers = {n: t.detach()
                   for n, t in self.model.state_dict(keep_vars=True).items()
                   if n not in params and id(t) not in trained}
        return params, buffers

    def state_dict(self) -> dict:
        """A host snapshot of the train state (CPU copies: one wait for
        the device) in the ``train_state_v2`` layout.  Slots of a
        parameter not updated yet are zeros, as the JAX state starts
        them."""
        params, buffers = self._entries()

        def host(t):
            return t.detach().to("cpu", copy=True)

        opt = self.optimizer
        return {
            "params": {n: host(p) for n, p in params.items()},
            "slots": {n: {k: host(v) for k, v in opt.slots_of(n, p).items()}
                      for n, p in params.items()},
            "buffers": {n: host(t) for n, t in buffers.items()},
            "step": torch.tensor(self._step, dtype=torch.int32),
            "opt_step_count": torch.tensor(opt._step_count,
                                           dtype=torch.int64),
            "meta": {"format": "train_state_v2", "mesh": {}}}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Restore :meth:`state_dict` (tensors or numpy arrays).  Every
        leaf is checked before anything is written: a missing leaf raises
        ``KeyError`` and a shape that does not fit ``ValueError``, each
        naming the leaf, and leave the step as it was."""
        params, buffers = self._entries()
        opt = self.optimizer

        def leaf(tree, key, like, section):
            if key not in tree:
                raise KeyError(f"train state: {section} leaf {key!r} is "
                               f"missing")
            v = tree[key]
            v = v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
            if tuple(v.shape) != tuple(like.shape):
                raise ValueError(f"train state: {section} leaf {key!r} has "
                                 f"shape {tuple(v.shape)}, this step needs "
                                 f"{tuple(like.shape)}")
            return v

        src_slots = state.get("slots", {})
        new_p = {n: leaf(state.get("params", {}), n, p, "params")
                 for n, p in params.items()}
        new_s = {n: {k: leaf(src_slots.get(n, {}), k, p, f"slots/{n}")
                     for k in opt.slots_of(n, p)}
                 for n, p in params.items()}
        new_b = {n: leaf(state.get("buffers", {}), n, t, "buffers")
                 for n, t in buffers.items()}
        step, count = int(state["step"]), int(state["opt_step_count"])
        for n, p in params.items():
            p.copy_(new_p[n])
            slots = opt.slots_of(n, p)
            for k, dst in slots.items():
                dst.copy_(new_s[n][k])
            opt._slots[n] = slots
        for n, t in buffers.items():
            t.copy_(new_b[n])
        self._step = step
        opt._step_count = count

    def sync_to_model(self) -> None:
        """Nothing to do: the step updates the module's own parameters
        and buffers in place (the JAX step keeps its own copies and
        writes them back here)."""


def make_train_step(model, optimizer, loss_fn=None,
                    **kwargs) -> ShardedTrainStep:
    return ShardedTrainStep(model, optimizer, loss_fn, **kwargs)
