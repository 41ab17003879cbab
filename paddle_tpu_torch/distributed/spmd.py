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
* ``Embedding(sparse=True)`` tables get dense gradients, as the JAX
  step's do (``core.selected_rows.dense_gradients``);
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
(``models.convert`` maps a JAX snapshot onto them and back), and ``rng``:
the states of the generators the step's dropout draws from, as uint8
tensors: ``{"port": {device: state}}``, the port's generators of
``core.random`` (paddle's ``F.dropout`` and ``nn.Dropout``), and
``{"torch": {device: state}}``, torch's default generator of the step's
device (the models' ``torch.nn.Dropout`` and attention dropout), so a
restored step continues bit for bit.
Where the JAX step keeps its dropout key (``rng_key``) the port keeps
these: the two packages' draws differ by design.  A snapshot without
``rng`` (a JAX one, through ``models.load_jax_train_state``) leaves the
generators as they are.  The step updates the module's own parameters in
place, so ``sync_to_model()`` has nothing to write back.

``attach_saver(AsyncCheckpointSaver(...))`` makes the step its own
preemption point, as the JAX step is: when ``framework.preemption`` has a
request (a SIGTERM under ``preemption.guard()``), the end of ``__call__``
and of ``run_steps`` writes a blocking checkpoint of ``state_dict()`` at
the optimizer's step count inside a ``checkpoint.emergency`` span, calls
``preemption.mark_saved`` and raises ``TrainingPreempted(step)``.

``run_steps(*stacked)`` takes ``[K, B, ...]`` stacks of K batches and runs
K steps, returning the K losses as one f32 tensor; where the JAX step
scans them in one program, the port loops in Python (one CUDA-graph
capture of the step is later work).

The twin of "one train-step compile": PyTorch runs eagerly, so nothing is
compiled; the step builds its per-signature state (the split of the batch
and the cast list) once per batch signature (shapes and dtypes) and
``compile_count`` counts the signatures.  A later CUDA-graph capture of
the step keys on the same signature.  The retrace sentinel
(``observability.retrace``) wraps the step as ``"spmd_train_step"`` and
``run_steps`` as ``"spmd_train_step_multi"``, the JAX step's names, and
with telemetry on each call books ``observability.steps.record_step``
(``fn="train_step"``; ``run_steps`` one ``"train_step_multi"`` sample of
the K steps' mean) and the device memory gauges, as the JAX step does.
A mesh and gradient accumulation raise ``NotImplementedError`` (ROADMAP
module item 11); the JAX step's sharding and offload options are not
taken.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..core import op as _op
from ..core import random as random_mod
from ..core import selected_rows
from ..core.tensor import Tensor
from ..observability import instrument_jit
from ..observability import steps as _steps
from ..observability import trace as _trace

__all__ = ["ShardedTrainStep", "make_train_step"]


def _unported(what: str):
    return NotImplementedError(f"{what} is not ported yet: the port has the "
                               f"single-device step (ROADMAP module item 11)")


def _as_torch(v) -> torch.Tensor:
    """A restored leaf (a torch tensor, a surface Tensor as
    ``load_sharded`` returns it, a numpy array) as a torch tensor."""
    if isinstance(v, Tensor):
        return v._value
    return v if torch.is_tensor(v) else torch.from_numpy(np.array(v))


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
        self.device = next(torch.nn.Module.parameters(model)).device
        optimizer.name_parameters(model)
        self._plans: dict = {}
        self._step = 0          # the train state's step (JAX TrainState)
        self._saver = None      # the emergency checkpoint's target
        # the retrace sentinel's books (the JAX step's entry-point names)
        self._jitted = instrument_jit(self._one_step, "spmd_train_step")
        self._jitted_multi = instrument_jit(self._k_steps,
                                            "spmd_train_step_multi")

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
                      for n, p in torch.nn.Module.named_parameters(self.model)}
            out = torch.func.functional_call(self.model, values, tuple(x))
        loss = out if self.loss_fn is None else self.loss_fn(
            out, *(batch[i] for i in plan.y_idx))
        if loss.dim():
            loss = loss.mean()
        return loss.float()

    def __call__(self, *batch):
        t0 = time.perf_counter() if _op.TELEMETRY else 0.0
        batch = tuple(self._on_device(b) for b in batch)
        with _trace.span("train_step", fn="spmd_train_step",
                         step=self.optimizer._step_count + 1):
            loss = self._jitted(*batch)
        if _op.TELEMETRY:
            n = batch[0].shape[0] if batch and batch[0].dim() else None
            _steps.record_step(time.perf_counter() - t0, examples=n,
                               fn="train_step")
            _steps.record_memory_stats()
        self._maybe_emergency_save()
        return loss

    def _on_device(self, b):
        """A batch argument (a tensor, a surface Tensor as a
        ``DevicePrefetcher`` delivers it, an array) on the step's device."""
        if isinstance(b, Tensor):
            b = b._value
        return torch.as_tensor(b, device=self.device)

    def _one_step(self, *batch):
        sig = tuple((tuple(b.shape), b.dtype) for b in batch)
        plan = self._plans.get(sig)
        if plan is None:
            plan = self._plans[sig] = _Plan(
                len(batch), [b.dtype for b in batch], self.loss_fn is not None,
                self.num_labels, self.compute_dtype)
        self.model.train()
        self.optimizer.clear_grad()
        # the tables get dense gradients here, as in the JAX step
        with selected_rows.dense_gradients():
            loss = self._loss(plan, batch)
        loss.backward()
        self._step += 1
        with torch.no_grad():
            self.optimizer._apply(self._step, clip_in_place=True)
        self.optimizer._step_count += 1
        return loss.detach()

    def run_steps(self, *stacked):
        """K steps over ``[K, B, ...]`` stacks; returns the K losses."""
        t0 = time.perf_counter() if _op.TELEMETRY else 0.0
        stacked = tuple(self._on_device(b) for b in stacked)
        k = int(stacked[0].shape[0])
        with _trace.span("train_step", fn="spmd_train_step_multi", steps=k,
                         step=self.optimizer._step_count + 1):
            losses = self._jitted_multi(*stacked)
        if _op.TELEMETRY:
            n = stacked[0].shape[1] if stacked[0].dim() > 1 else None
            # one call covers k steps: the per-step series stays
            # comparable with the single-step path
            _steps.record_step((time.perf_counter() - t0) / k, examples=n,
                               fn="train_step_multi")
            _steps.record_memory_stats()
        self._maybe_emergency_save()
        return losses

    def _k_steps(self, *stacked):
        return torch.stack([self._one_step(*(b[i] for b in stacked))
                            for i in range(int(stacked[0].shape[0]))])

    # -- the train state -----------------------------------------------------
    def _entries(self):
        """(trainable parameters, everything else in the state dict): the
        JAX step's ``params`` and ``buffers``.  A parameter's second name
        (BERT's tied ``cls.decoder_weight``) is neither."""
        params = {n: p for n, p in torch.nn.Module.named_parameters(self.model)
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
            "rng": self._rng_state(),
            "meta": {"format": "train_state_v2", "mesh": {}}}

    def _rng_state(self) -> dict:
        """The ``rng`` leaf: the port's generators and torch's default
        generator of the step's device (see the module docstring)."""
        dev = self.device
        default = (torch.cuda.get_rng_state(dev) if dev.type == "cuda"
                   else torch.get_rng_state())
        return {"port": random_mod.get_rng_state(),
                "torch": {str(dev): default}}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Restore :meth:`state_dict` (tensors, surface Tensors or numpy
        arrays).  Every
        leaf is checked before anything is written: a missing leaf raises
        ``KeyError`` and a shape that does not fit ``ValueError``, each
        naming the leaf, and leave the step as it was."""
        params, buffers = self._entries()
        opt = self.optimizer

        def leaf(tree, key, like, section):
            if key not in tree:
                raise KeyError(f"train state: {section} leaf {key!r} is "
                               f"missing")
            v = _as_torch(tree[key])
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
        rng = {part: {d: _as_torch(s).to("cpu", torch.uint8)
                      for d, s in state["rng"].get(part, {}).items()}
               for part in ("port", "torch")} if "rng" in state else None
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
        if rng is not None:
            random_mod.set_rng_state(rng["port"])
            for d, s in rng["torch"].items():
                if torch.device(d).type == "cuda":
                    torch.cuda.set_rng_state(s, d)
                else:
                    torch.set_rng_state(s)

    # -- preemption ----------------------------------------------------------
    def attach_saver(self, saver):
        """Attach an ``AsyncCheckpointSaver`` as the emergency checkpoint's
        target (see the module docstring); returns the step."""
        self._saver = saver
        return self

    def _maybe_emergency_save(self):
        if self._saver is None:
            return
        from ..framework import preemption
        if not preemption.requested():
            return
        from ..framework.checkpoint import mesh_axes_of
        step_no = int(self.optimizer._step_count)
        with _trace.span("checkpoint.emergency", step=step_no):
            self._saver.save(self.state_dict(), step=step_no, blocking=True)
        preemption.mark_saved(step_no, topology=mesh_axes_of(None))
        raise preemption.TrainingPreempted(step_no)

    def sync_to_model(self) -> None:
        """Nothing to do: the step updates the module's own parameters
        and buffers in place (the JAX step keeps its own copies and
        writes them back here)."""


def make_train_step(model, optimizer, loss_fn=None,
                    **kwargs) -> ShardedTrainStep:
    return ShardedTrainStep(model, optimizer, loss_fn, **kwargs)
