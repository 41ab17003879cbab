"""hapi Model — parity with python/paddle/hapi/model.py:915 (prepare:1499,
fit, evaluate, predict, train_batch/eval_batch/predict_batch, save/load);
the port's copy of ``paddle_tpu/hapi/model.py``.

The reference maintains dual static/dygraph engines; here there is one
eager engine: the network's Layers run on surface Tensors on the current
place (the card unless the caller set the CPU), and its attention reaches
the flash kernels through ``nn.functional``.  Losses stay on the card
(:class:`DeviceLossList`) until a consumer reads them, so a fit loop over
a ``DevicePrefetcher`` whose callbacks read losses only at their log
points queues steps ahead of the card without waiting for it."""
from __future__ import annotations

import os
import warnings

import numpy as np
import torch

from ..core.tensor import Tensor
from ..framework.io import load as _load, save as _save
from ..io.dataloader import DataLoader, _place
from . import callbacks as callbacks_mod


def _to_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _to_tensor(x):
    if isinstance(x, Tensor):
        return x
    return _place(x if isinstance(x, torch.Tensor) else np.asarray(x))


def _detached(loss):
    """A loss as the list keeps it: its tensor, off the autograd graph."""
    v = loss._value if isinstance(loss, Tensor) else loss
    return v.detach() if isinstance(v, torch.Tensor) else v


class DeviceLossList:
    """Per-batch losses kept as tensors on the card — the dispatch-ahead
    loss path.  Nothing is fetched when the list is made: the WHOLE list
    crosses to the host with one device-to-host copy (the first element
    of each loss, stacked on the card) the first time a consumer needs
    floats (``float()``, indexing, iteration, ``np.asarray``).  A fit loop
    whose callbacks only read losses at ``log_freq``/epoch end therefore
    queues K steps ahead of the card instead of waiting on each one."""

    __slots__ = ("_arrays", "_host")

    def __init__(self, arrays):
        self._arrays = list(arrays)
        self._host = None

    @property
    def fetched(self) -> bool:
        return self._host is not None

    def _fetch(self):
        if self._host is None:
            if not self._arrays:
                self._host = []
            else:
                firsts = torch.stack([torch.as_tensor(a).reshape(-1)[0]
                                      .float() for a in self._arrays])
                self._host = firsts.cpu().tolist()      # the one copy
        return self._host

    def __len__(self):
        return len(self._arrays)

    def __bool__(self):
        return bool(self._arrays)

    def __iter__(self):
        return iter(self._fetch())

    def __getitem__(self, i):
        return self._fetch()[i]

    def __float__(self):
        return float(self._fetch()[0])

    def __array__(self, dtype=None, copy=None):
        a = np.asarray(self._fetch())
        return a if dtype is None else a.astype(dtype)

    def __repr__(self):
        if self._host is None:
            return f"DeviceLossList(<{len(self._arrays)} unfetched>)"
        return repr(self._host)


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self.stop_training = False
        self.prefetcher = None

    # -- setup ---------------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        """model.py:1499 parity."""
        self._optimizer = optimizer
        if loss is not None and not callable(loss):
            raise TypeError("loss must be a callable (Layer or function)")
        self._loss = loss
        self._metrics = _to_list(metrics)
        self._amp_configs = amp_configs
        return self

    # -- batch-level ---------------------------------------------------------
    def train_batch(self, inputs, labels=None, update=True):
        inputs = [_to_tensor(t) for t in _to_list(inputs)]
        labels = [_to_tensor(t) for t in _to_list(labels)]
        self.network.train()
        outputs = self.network(*inputs)
        outs = _to_list(outputs)
        losses = self._loss(*(outs + labels)) if self._loss else outputs
        loss_list = _to_list(losses)
        total = loss_list[0]
        for extra in loss_list[1:]:
            total = total + extra
        total.backward()
        if update and self._optimizer is not None:
            self._optimizer.step()
            self._optimizer.clear_grad()
        metrics = []
        for m in self._metrics:
            m.update(*_to_list(m.compute(*(outs + labels))))
            metrics.append(m.accumulate())
        # losses stay on device; one gather when a consumer reads them
        out_loss = DeviceLossList(
            [_detached(l) for l in loss_list])
        return (out_loss, metrics) if metrics else out_loss

    @torch.no_grad()
    def _eval_batch_impl(self, inputs, labels=None):
        """Always returns (loss_list, metrics) so log packing can't confuse
        metric values for losses."""
        inputs = [_to_tensor(t) for t in _to_list(inputs)]
        labels = [_to_tensor(t) for t in _to_list(labels)]
        self.network.eval()
        outputs = self.network(*inputs)
        outs = _to_list(outputs)
        loss_list = []
        if self._loss:
            losses = self._loss(*(outs + labels))
            loss_list = DeviceLossList(
                [_detached(l) for l in _to_list(losses)])
        metrics = []
        for m in self._metrics:
            m.update(*_to_list(m.compute(*(outs + labels))))
            metrics.append(m.accumulate())
        return loss_list, metrics

    def eval_batch(self, inputs, labels=None):
        loss_list, metrics = self._eval_batch_impl(inputs, labels)
        if loss_list and metrics:
            return loss_list, metrics
        return loss_list if loss_list else metrics

    @torch.no_grad()
    def predict_batch(self, inputs):
        inputs = [_to_tensor(t) for t in _to_list(inputs)]
        self.network.eval()
        outputs = self.network(*inputs)
        return [o.numpy() for o in _to_list(outputs)]

    # -- loops ---------------------------------------------------------------
    def _loader(self, data, batch_size, shuffle, num_workers,
                drop_last=False, prefetch=False, prefetch_depth=2):
        from ..io.prefetch import DevicePrefetcher
        if isinstance(data, DevicePrefetcher):
            return data
        if data is None:
            return None
        loader = data if isinstance(data, DataLoader) else DataLoader(
            data, batch_size=batch_size, shuffle=shuffle,
            num_workers=num_workers, drop_last=drop_last)
        if prefetch:
            return DevicePrefetcher(loader, depth=prefetch_depth,
                                    name="hapi_fit")
        return loader

    @staticmethod
    def _split_batch(batch):
        batch = list(batch) if isinstance(batch, (list, tuple)) else [batch]
        if len(batch) == 1:
            return batch, []
        return batch[:-1], batch[-1:]

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None, prefetch=False,
            prefetch_depth=2, resume=None):
        """model.py fit parity: epoch/step loops with the callback protocol.

        `prefetch=True` routes the train loader through a DevicePrefetcher
        (`prefetch_depth` batches kept device-resident ahead of the loop);
        combined with the deferred DeviceLossList losses the loop dispatches
        ahead of the device instead of syncing per batch.  A pre-built
        DevicePrefetcher may also be passed directly as `train_data`.

        `resume="auto"` restores the latest valid checkpoint written by a
        :class:`~paddle_tpu_torch.hapi.callbacks.CheckpointCallback` (which must
        be in `callbacks`) and continues from the recorded epoch/step with
        the saved optimizer state and RNG — bit-identical to the
        uninterrupted run; `resume=<path>` loads an explicit checkpoint
        step dir (or walks a checkpoint base dir).  While fitting, SIGTERM
        /SIGINT request an emergency checkpoint at the next step boundary
        (framework.preemption) instead of killing the run."""
        assert train_data is not None, "train_data must be given!"
        loader = self._loader(train_data, batch_size, shuffle, num_workers,
                              drop_last=drop_last, prefetch=prefetch,
                              prefetch_depth=prefetch_depth)
        from ..io.prefetch import DevicePrefetcher
        # the last fit's prefetcher (its stats()), None without one
        self.prefetcher = loader if isinstance(loader, DevicePrefetcher) \
            else None
        eval_loader = self._loader(eval_data, batch_size, False, num_workers)
        steps = len(loader) if hasattr(loader, "__len__") else None
        # per-rank batch size (world-size-aware checkpoints record global
        # sample offsets = steps x this x dp world); a pre-built loader
        # (or the one inside a DevicePrefetcher) carries its own
        per_rank_bs = getattr(loader, "batch_size", None) or getattr(
            getattr(loader, "data", None), "batch_size", None)
        cbks = callbacks_mod.config_callbacks(
            callbacks, model=self, epochs=epochs, steps=steps,
            batch_size=per_rank_bs,
            log_freq=log_freq, verbose=verbose, save_freq=save_freq,
            save_dir=save_dir, metrics=self._metrics)
        ckpt_cb = next((c for c in cbks.callbacks if isinstance(
            c, callbacks_mod.CheckpointCallback)), None)
        start_epoch = start_step = 0
        if resume:
            start_epoch, start_step = self._restore_for_resume(
                resume, ckpt_cb, per_rank_bs)

        from ..framework import preemption
        self.stop_training = False
        cbks.on_train_begin({})
        with preemption.guard():
            for epoch in range(start_epoch, epochs):
                if self.stop_training:
                    break
                if ckpt_cb is not None:
                    # deterministic per-epoch shuffle: a resumed run must
                    # draw the SAME permutation this epoch saw originally
                    np.random.seed((ckpt_cb.data_seed + epoch) % (2 ** 32))
                cbks.on_epoch_begin(epoch, {})
                for m in self._metrics:
                    m.reset()
                logs = {}
                pending_update = False
                skip = start_step if epoch == start_epoch else 0
                for step, batch in enumerate(loader):
                    if step < skip:
                        continue  # replayed prefix of a resumed epoch
                    cbks.on_train_batch_begin(step, {})
                    ins, lbs = self._split_batch(batch)
                    update = (step + 1) % accumulate_grad_batches == 0
                    res = self.train_batch(ins, lbs, update=update)
                    pending_update = not update
                    logs = self._pack_logs(res)
                    cbks.on_train_batch_end(step, logs)
                    if self.stop_training:
                        break  # preempted: checkpoint already on disk
                    if num_iters is not None and step + 1 >= num_iters:
                        break
                if self.stop_training:
                    break
                if pending_update and self._optimizer is not None:
                    # flush a trailing partial accumulation group so grads
                    # never leak across epochs
                    self._optimizer.step()
                    self._optimizer.clear_grad()
                cbks.on_epoch_end(epoch, logs)

                if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                    eval_logs = self._run_eval(eval_loader, cbks)
                    cbks.on_eval_end(eval_logs)
        if self.prefetcher is not None:
            # an epoch left early (preempted, num_iters) stops its producer
            # and the loader's workers now, not at garbage collection
            self.prefetcher.close()
        cbks.on_train_end({})

    def _restore_for_resume(self, resume, ckpt_cb, per_rank_bs=None):
        """Resolve `resume` ("auto" | checkpoint dir) to a restored state;
        returns (start_epoch, start_step_in_epoch).

        World-size-aware (elastic) resume: when the checkpoint carries a
        global sample offset (``samples_in_epoch``) and this run's global
        batch (per-rank batch x the CheckpointCallback's ``dp_world_size``)
        is known, the skip prefix is recomputed in the NEW topology's step
        units — the epoch permutation is drawn dataset-level from
        ``data_seed + epoch``, so the global sample order is preserved
        across a dp world-size change.  A sample offset the new global
        batch cannot hit raises :class:`ElasticResumeError` instead of
        silently replaying from a misaligned sample."""
        from ..framework.checkpoint import (AsyncCheckpointSaver, _MANIFEST,
                                            ElasticResumeError, load_sharded)
        if resume == "auto":
            if ckpt_cb is None:
                raise ValueError(
                    "fit(resume='auto') needs a CheckpointCallback in "
                    "callbacks= (it owns the checkpoint directory)")
            _, state = ckpt_cb.saver.restore_latest_valid()
            if state is None:
                return 0, 0  # nothing saved yet: fresh start
        elif os.path.isfile(os.path.join(str(resume), _MANIFEST)):
            state = load_sharded(str(resume))
        else:
            _, state = AsyncCheckpointSaver(
                str(resume)).restore_latest_valid()
            if state is None:
                raise FileNotFoundError(
                    f"no valid checkpoint under {resume!r}")
        train = (ckpt_cb.restore_into(state) if ckpt_cb is not None
                 else callbacks_mod.restore_checkpoint_state(self, state))
        start_epoch = int(train.get("epoch", 0))
        start_step = int(train.get("step_in_epoch", 0))
        samples = train.get("samples_in_epoch")
        if samples is not None and ckpt_cb is not None and per_rank_bs:
            new_global = int(per_rank_bs) * ckpt_cb.dp_world_size
            samples = int(samples)
            if samples % new_global:
                raise ElasticResumeError(
                    f"elastic resume: checkpoint stopped at global sample "
                    f"offset {samples} of the epoch (written at global "
                    f"batch {train.get('global_batch_size')}, dp world "
                    f"{train.get('dp_world_size')}), which this topology's "
                    f"global batch {new_global} (= {per_rank_bs} x dp "
                    f"world {ckpt_cb.dp_world_size}) cannot reach",
                    samples=samples, global_batch_size=new_global)
            start_step = samples // new_global
        return start_epoch, start_step

    def _pack_logs(self, res):
        logs = {}
        if isinstance(res, tuple):
            loss_list, metrics = res
        else:
            loss_list, metrics = res, []
        if loss_list:
            logs["loss"] = loss_list
        for m, v in zip(self._metrics, metrics):
            name = m.name()
            if isinstance(name, (list, tuple)):
                vals = v if isinstance(v, (list, tuple, np.ndarray)) else [v]
                for n_, v_ in zip(name, vals):
                    logs[n_] = v_
            else:
                logs[name] = v
        return logs

    def _run_eval(self, eval_loader, cbks):
        for m in self._metrics:
            m.reset()
        steps = len(eval_loader) if hasattr(eval_loader, "__len__") else None
        cbks.on_eval_begin({"steps": steps})
        logs = {}
        for step, batch in enumerate(eval_loader):
            cbks.on_eval_batch_begin(step, {})
            ins, lbs = self._split_batch(batch)
            logs = self._pack_logs(self._eval_batch_impl(ins, lbs))
            cbks.on_eval_batch_end(step, logs)
        return logs

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_iters=None,
                 prefetch=False, prefetch_depth=2):
        loader = self._loader(eval_data, batch_size, False, num_workers,
                              prefetch=prefetch,
                              prefetch_depth=prefetch_depth)
        cbks = callbacks_mod.config_callbacks(
            callbacks, model=self, log_freq=log_freq, verbose=verbose,
            metrics=self._metrics, mode="eval")
        for m in self._metrics:
            m.reset()
        steps = len(loader) if hasattr(loader, "__len__") else None
        cbks.on_eval_begin({"steps": steps})
        logs = {}
        for step, batch in enumerate(loader):
            ins, lbs = self._split_batch(batch)
            logs = self._pack_logs(self._eval_batch_impl(ins, lbs))
            cbks.on_eval_batch_end(step, logs)
            if num_iters is not None and step + 1 >= num_iters:
                break
        cbks.on_eval_end(logs)
        result = {}
        if "loss" in logs:
            # materialize here (one gather): evaluate() returns plain floats
            result["loss"] = [float(v) for v in logs["loss"]]
        for m in self._metrics:
            name = m.name()
            result[name if not isinstance(name, list) else name[0]] = \
                m.accumulate()
        return result

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        loader = self._loader(test_data, batch_size, False, num_workers)
        cbks = callbacks_mod.config_callbacks(
            callbacks, model=self, verbose=verbose, mode="predict")
        cbks.on_predict_begin({})
        outputs = []
        for step, batch in enumerate(loader):
            ins, _ = self._split_batch(batch)
            # a loss-prepared model treats the trailing field as the label;
            # otherwise every field is an input (reference: predict uses
            # declared inputs when given, else the whole sample)
            use_ins = (self._labels is not None or self._loss is not None)
            outs = self.predict_batch(ins if use_ins else list(batch))
            outputs.append(outs)
            cbks.on_predict_batch_end(step, {})
        cbks.on_predict_end({})
        # regroup: list over outputs, each a list over batches
        n_out = len(outputs[0]) if outputs else 0
        grouped = [[b[i] for b in outputs] for i in range(n_out)]
        if stack_outputs:
            grouped = [np.concatenate(g, axis=0) for g in grouped]
        return grouped

    # -- persistence ---------------------------------------------------------
    def save(self, path, training=True):
        """model.py save parity: `path.pdparams` (+ `.pdopt` when training)."""
        dirname = os.path.dirname(path)
        if dirname:
            os.makedirs(dirname, exist_ok=True)
        _save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            _save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        param_path = path if path.endswith(".pdparams") else path + ".pdparams"
        state = _load(param_path)
        if skip_mismatch:
            own = self.network.state_dict()
            filtered = {}
            for k, v in state.items():
                if k in own and tuple(own[k].shape) == tuple(v.shape):
                    filtered[k] = v
                else:
                    warnings.warn(f"skip loading {k} (missing or mismatched)")
            state = filtered
        self.network.set_state_dict(state)
        opt_path = path.replace(".pdparams", "") + ".pdopt"
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(opt_path):
            self._optimizer.set_state_dict(_load(opt_path,
                                                 return_numpy=True))

    # -- misc ----------------------------------------------------------------
    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype=None):
        from .summary import summary as _summary
        return _summary(self.network, input_size, dtype)
