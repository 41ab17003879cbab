"""hapi callbacks — parity with python/paddle/hapi/callbacks.py
(ProgBarLogger, ModelCheckpoint:534, LRScheduler:599, EarlyStopping:690,
VisualDL:844, ReduceLROnPlateau:960); the port's copy of
``paddle_tpu/hapi/callbacks.py``.

Where the port differs: a checkpoint's RNG block holds the port's
generators (``core.random.get_rng_state``: one ``torch.Generator`` state
per device, as uint8 leaves under ``train/rng/<device>``) in place of the
JAX key and counter.  The draws differ from the JAX package's, but a
resumed run repeats its own uninterrupted run."""
from __future__ import annotations

import numbers
import os
import warnings

import numpy as np
import torch

from .progressbar import ProgressBar


def _scalar(v):
    """First scalar of a logs value.  Plain numbers pass through; lists,
    arrays and deferred DeviceLossList losses (anything array-convertible)
    fetch here — the ONE place the dispatch-ahead loss path syncs, so a
    callback that never reads a loss never forces it to host."""
    if isinstance(v, numbers.Number):
        return v
    return float(np.ravel(np.asarray(v))[0])


def config_callbacks(callbacks=None, model=None, batch_size=None, epochs=None,
                     steps=None, log_freq=2, verbose=2, save_freq=1,
                     save_dir=None, metrics=None, mode="train"):
    cbks = callbacks if callbacks is not None else []
    cbks = cbks if isinstance(cbks, (list, tuple)) else [cbks]
    if not any(isinstance(k, ProgBarLogger) for k in cbks) and verbose:
        cbks = [ProgBarLogger(log_freq, verbose=verbose)] + list(cbks)
    if not any(isinstance(k, LRScheduler) for k in cbks):
        cbks = [LRScheduler()] + list(cbks)
    from .. import observability as _obs
    if _obs.enabled() and \
            not any(isinstance(k, TelemetryCallback) for k in cbks):
        cbks = list(cbks) + [TelemetryCallback()]
    if save_dir and not any(isinstance(k, ModelCheckpoint) for k in cbks):
        cbks = list(cbks) + [ModelCheckpoint(save_freq, save_dir)]
    cbk_list = CallbackList(cbks)
    cbk_list.set_model(model)
    metrics = metrics or []
    params = {"batch_size": batch_size, "epochs": epochs, "steps": steps,
              "verbose": verbose, "metrics": metrics}
    cbk_list.set_params(params)
    return cbk_list


class CallbackList:
    def __init__(self, callbacks):
        self.callbacks = list(callbacks)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def _call(self, name, *args):
        for c in self.callbacks:
            getattr(c, name)(*args)

    def __getattr__(self, name):
        if name.startswith("on_"):
            return lambda *args: self._call(name, *args)
        raise AttributeError(name)


class Callback:
    """hapi/callbacks.py Callback base: all hooks are no-ops."""

    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_predict_begin(self, logs=None):
        pass

    def on_predict_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass

    def on_predict_batch_begin(self, step, logs=None):
        pass

    def on_predict_batch_end(self, step, logs=None):
        pass


class TelemetryCallback(Callback):
    """Feeds paddle_tpu_torch.observability step metrics from the hapi fit loop:
    per-batch latency + examples/s (`paddle_tpu_step_latency_seconds{fn=
    hapi_train_batch}`), per-epoch device-memory gauges.  Auto-inserted by
    config_callbacks when telemetry is enabled; inert (records nothing)
    when it is off."""

    def __init__(self, fn: str = "hapi_train_batch"):
        super().__init__()
        self.fn = fn
        self._t0 = None
        self._span = None

    @staticmethod
    def _obs():
        from .. import observability
        return observability

    def on_train_batch_begin(self, step, logs=None):
        if self._obs().enabled():
            import time

            # batch span: the hapi fit loop shows up on the chrome-trace
            # timeline (and in the flight record) next to the train
            # step's own train_step spans
            self._span = self._obs().trace.span("hapi.train_batch",
                                                step=step)
            self._span.__enter__()
            self._t0 = time.perf_counter()

    def on_train_batch_end(self, step, logs=None):
        obs = self._obs()
        if self._span is not None:
            self._span.__exit__(None, None, None)
            self._span = None
        if not obs.enabled() or self._t0 is None:
            return
        import time
        dt = time.perf_counter() - self._t0
        self._t0 = None
        bs = (logs or {}).get("batch_size") or self.params.get("batch_size")
        obs.steps.record_step(dt, examples=bs, fn=self.fn)

    def on_epoch_end(self, epoch, logs=None):
        if self._obs().enabled():
            self._obs().steps.record_memory_stats()


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_train_begin(self, logs=None):
        self.epochs = self.params.get("epochs")
        names = []
        for m in self.params.get("metrics", []):
            n = m.name()
            names.extend(n if isinstance(n, (list, tuple)) else [n])
        self.train_metrics = ["loss"] + names

    def on_epoch_begin(self, epoch, logs=None):
        self.steps = self.params.get("steps")
        self.epoch = epoch
        self.train_step = 0
        if self.verbose and self.epochs:
            print(f"Epoch {epoch + 1}/{self.epochs}")
        self.progbar = ProgressBar(num=self.steps, verbose=self.verbose)

    def _updates(self, logs):
        values = []
        for k in getattr(self, "train_metrics", ["loss"]):
            if k in (logs or {}):
                values.append((k, _scalar(logs[k])))
        return values

    def on_train_batch_end(self, step, logs=None):
        self.train_step += 1
        if self.verbose and self.train_step % self.log_freq == 0:
            self.progbar.update(self.train_step, self._updates(logs))

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            self.progbar.update(self.train_step, self._updates(logs))

    def on_eval_begin(self, logs=None):
        self.eval_steps = (logs or {}).get("steps")
        self.eval_progbar = ProgressBar(num=self.eval_steps,
                                        verbose=self.verbose)
        if self.verbose:
            print("Eval begin...")

    def on_eval_batch_end(self, step, logs=None):
        if self.verbose and (step + 1) % self.log_freq == 0:
            self.eval_progbar.update(step + 1, self._updates(logs))

    def on_eval_end(self, logs=None):
        if self.verbose:
            items = ", ".join(f"{k}: {v}" for k, v in (logs or {}).items()
                              if k != "batch_size")
            print(f"Eval samples done — {items}")


class ModelCheckpoint(Callback):
    """hapi/callbacks.py:534: save every `save_freq` epochs + final."""

    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.model is not None and self.save_dir and \
                epoch % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.model is not None and self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


def _raw(tree):
    """A restored tree with each surface Tensor as its torch value."""
    from ..core.tensor import Tensor
    if isinstance(tree, dict):
        return {k: _raw(v) for k, v in tree.items()}
    return tree._value if isinstance(tree, Tensor) else tree


def restore_checkpoint_state(model, state) -> dict:
    """Apply a checkpoint tree (as written by CheckpointCallback) to a
    hapi Model: weights, optimizer state (scheduler scalars coerced back
    from their 0-d round-trip form), and the port's generators.  Returns
    the ``train`` block as python scalars (``rng`` stays a dict of
    generator states)."""
    from ..core import random as random_mod

    def as_int(v):
        return int(np.ravel(np.asarray(
            v.cpu() if isinstance(v, torch.Tensor) else v))[0])

    model.network.set_state_dict(state["model"])
    if model._optimizer is not None and "optimizer" in state:
        opt_state = _raw(dict(state["optimizer"]))
        lrs = opt_state.get("LR_Scheduler")
        if isinstance(lrs, dict):
            opt_state["LR_Scheduler"] = {
                k: (np.ravel(np.asarray(
                    v.cpu() if isinstance(v, torch.Tensor) else v))[0].item()
                    if not isinstance(v, (numbers.Number, str)) else v)
                for k, v in lrs.items()}
        model._optimizer.set_state_dict(opt_state)
    train = _raw(state.get("train", {}))
    if "rng" in train:
        from ..testing import faults
        faults.fault_point("restore.rng")
        random_mod.set_rng_state({
            dev: torch.as_tensor(np.asarray(
                s.cpu() if isinstance(s, torch.Tensor) else s),
                dtype=torch.uint8).cpu()
            for dev, s in train["rng"].items()})
    return {k: (as_int(v) if k != "rng" else v) for k, v in train.items()}


class CheckpointCallback(Callback):
    """Validated-checkpoint save/resume for the fit loop.

    Writes sharded, CRC-validated, COMMITTED-marked checkpoints through
    :class:`~paddle_tpu.framework.checkpoint.AsyncCheckpointSaver`:
    model weights + optimizer state + a ``train`` scalar block (epoch,
    step-in-epoch, optimizer step count, the port's generator states,
    dataloader epoch seed) — everything ``Model.fit(resume=...)`` needs to continue
    a killed run bit-identically.

    Saves every ``save_freq`` epochs, optionally every ``every_n_steps``
    batches (async: the fit loop never blocks on disk), and — the
    preemption path — a *blocking* emergency save at the first step
    boundary after ``framework.preemption`` flags a SIGTERM, after which
    ``model.stop_training`` ends the run cleanly.

    World-size awareness (elastic resume): ``dp_world_size`` is the
    data-parallel replica count this rank trains in (default: the
    launcher's ``PADDLE_TRAINERS_NUM`` / ``PADDLE_WORLD_SIZE`` /
    ``WORLD_SIZE``, else 1).  The ``train`` block then records
    the GLOBAL sample offset of the epoch (``samples_in_epoch`` =
    steps x per-rank batch x dp world) instead of only the per-rank step
    index, so ``Model.fit(resume=...)`` on a DIFFERENT topology can
    recompute the skip prefix in its own step units and preserve the
    global sample order.
    """

    def __init__(self, save_dir, save_freq=1, every_n_steps=None,
                 keep_last=3, fs=None, data_seed=0, dp_world_size=None):
        super().__init__()
        from ..framework.checkpoint import AsyncCheckpointSaver
        self.saver = AsyncCheckpointSaver(save_dir, keep_last=keep_last,
                                          fs=fs)
        self.save_freq = save_freq
        self.every_n_steps = every_n_steps
        self.data_seed = int(data_seed)
        if dp_world_size is None:
            from ..distributed import env as dist_env
            dp_world_size = max(1, dist_env.get_world_size())
        self.dp_world_size = int(dp_world_size)
        self.preempted = False
        self._epoch = 0
        self._global_step = 0

    # -- state assembly ------------------------------------------------------
    def _train_block(self, epoch, step_in_epoch):
        from ..core import random as random_mod
        block = {"epoch": int(epoch), "step_in_epoch": int(step_in_epoch),
                 "opt_step_count": int(getattr(
                     self.model._optimizer, "_step_count", 0)),
                 "rng": {dev: s.numpy().copy() for dev, s in
                         random_mod.get_rng_state().items()},
                 "data_seed": self.data_seed,
                 "dp_world_size": self.dp_world_size}
        per_rank_bs = self.params.get("batch_size")
        if per_rank_bs:
            # global offsets, not per-rank steps: the resume topology may
            # run a different dp world size / per-rank batch
            gbs = int(per_rank_bs) * self.dp_world_size
            block["global_batch_size"] = gbs
            block["samples_in_epoch"] = int(step_in_epoch) * gbs
        return block

    def _save(self, epoch, step_in_epoch, blocking=False):
        state = {"model": self.model.network.state_dict(),
                 "train": self._train_block(epoch, step_in_epoch)}
        if self.model._optimizer is not None:
            state["optimizer"] = self.model._optimizer.state_dict()
        self.saver.save(state, step=self._global_step, blocking=blocking)

    def restore_into(self, state):
        """Apply a loaded checkpoint tree to the model; returns the
        ``train`` scalar block (``Model.fit`` consumes epoch/step/rng)."""
        train = restore_checkpoint_state(self.model, state)
        if "data_seed" in train:
            self.data_seed = int(train["data_seed"])
        self._global_step = int(train.get("opt_step_count", 0))
        return train

    # -- hooks ---------------------------------------------------------------
    def on_epoch_begin(self, epoch, logs=None):
        self._epoch = epoch

    def on_train_batch_end(self, step, logs=None):
        from ..framework import preemption
        from ..testing import faults
        self._global_step += 1
        faults.fault_point("train.step", step=self._global_step)
        if preemption.requested():
            self._save(self._epoch, step + 1, blocking=True)
            preemption.mark_saved(self._global_step)
            self.preempted = True
            self.model.stop_training = True
            return
        if self.every_n_steps and self._global_step % self.every_n_steps == 0:
            self._save(self._epoch, step + 1)

    def on_epoch_end(self, epoch, logs=None):
        if not self.preempted and (epoch + 1) % self.save_freq == 0:
            # epoch done: resume point is the NEXT epoch at step 0
            self._save(epoch + 1, 0)

    def on_train_end(self, logs=None):
        self.saver.wait()


class LRScheduler(Callback):
    """hapi/callbacks.py:599: step the optimizer's LRScheduler."""

    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        if by_step and by_epoch:
            raise ValueError("by_step and by_epoch are mutually exclusive")
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_lr", None) if opt else None
        return lr if hasattr(lr, "step") else None

    def on_epoch_end(self, epoch, logs=None):
        if self.by_epoch:
            s = self._sched()
            if s is not None:
                s.step()

    def on_train_batch_end(self, step, logs=None):
        if self.by_step:
            s = self._sched()
            if s is not None:
                s.step()


class EarlyStopping(Callback):
    """hapi/callbacks.py:690."""

    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.verbose = verbose
        self.baseline = baseline
        self.min_delta = abs(min_delta)
        self.wait_epoch = 0
        self.best_weights = None
        self.stopped_epoch = 0
        self.save_best_model = save_best_model
        if mode not in ("auto", "min", "max"):
            warnings.warn(f"EarlyStopping mode {mode} unknown, using 'auto'")
            mode = "auto"
        if mode == "min" or (mode == "auto" and "acc" not in monitor):
            self.monitor_op = np.less
            self.min_delta *= -1
        else:
            self.monitor_op = np.greater

    def on_train_begin(self, logs=None):
        self.wait_epoch = 0
        self.epoch = 0
        if self.baseline is not None:
            self.best_value = self.baseline
        else:
            self.best_value = np.inf if self.monitor_op == np.less else -np.inf

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch

    def on_eval_end(self, logs=None):
        if logs is None or self.monitor not in logs:
            warnings.warn(f"Monitor of EarlyStopping should be loss or metric "
                          f"name; {self.monitor} missing in eval logs")
            return
        current = _scalar(logs[self.monitor])
        if self.monitor_op(current - self.min_delta, self.best_value):
            self.best_value = current
            self.wait_epoch = 0
            if self.save_best_model and self.model is not None:
                import copy
                self.best_weights = copy.deepcopy(
                    {k: v.numpy() for k, v in
                     self.model.network.state_dict().items()})
        else:
            self.wait_epoch += 1
        if self.wait_epoch >= self.patience:
            self.stopped_epoch = self.epoch
            self.model.stop_training = True
            if self.verbose > 0:
                print(f"Epoch {self.stopped_epoch + 1}: early stopping")

    def on_train_end(self, logs=None):
        # restore the best weights seen during training (reference saves the
        # best model to save_dir; without a dir we restore in place)
        if self.save_best_model and self.best_weights is not None and \
                self.model is not None:
            self.model.network.set_state_dict(self.best_weights)


class ReduceLROnPlateau(Callback):
    """hapi/callbacks.py:960: scale LR by `factor` after `patience` epochs
    without improvement."""

    def __init__(self, monitor="loss", factor=0.1, patience=10, verbose=1,
                 mode="auto", min_delta=1e-4, cooldown=0, min_lr=0):
        super().__init__()
        self.monitor = monitor
        if factor >= 1.0:
            raise ValueError("ReduceLROnPlateau does not support factor >= 1")
        self.factor = factor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = min_delta
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.cooldown_counter = 0
        self.wait = 0
        if mode == "min" or (mode == "auto" and "acc" not in monitor):
            self.monitor_op = lambda a, b: np.less(a, b - self.min_delta)
            self.best = np.inf
        else:
            self.monitor_op = lambda a, b: np.greater(a, b + self.min_delta)
            self.best = -np.inf

    def on_eval_end(self, logs=None):
        if logs is None or self.monitor not in logs:
            warnings.warn(f"Monitor {self.monitor} missing in eval logs")
            return
        current = _scalar(logs[self.monitor])
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.wait = 0
        if self.monitor_op(current, self.best):
            self.best = current
            self.wait = 0
        elif self.cooldown_counter <= 0:
            self.wait += 1
            if self.wait >= self.patience:
                opt = getattr(self.model, "_optimizer", None)
                if opt is not None:
                    old_lr = opt.get_lr()
                    new_lr = max(old_lr * self.factor, self.min_lr)
                    if old_lr - new_lr > 1e-12:
                        try:
                            opt.set_lr(new_lr)
                            if self.verbose:
                                print(f"ReduceLROnPlateau: lr {old_lr} -> "
                                      f"{new_lr}")
                        except RuntimeError:
                            warnings.warn(
                                "ReduceLROnPlateau cannot override an "
                                "LRScheduler-driven optimizer; skipping")
                self.cooldown_counter = self.cooldown
                self.wait = 0


class VisualDL(Callback):
    """hapi/callbacks.py:844 — VisualDL isn't installed in this build; logs
    scalars to a jsonl file under log_dir instead (same call pattern)."""

    def __init__(self, log_dir):
        super().__init__()
        self.log_dir = log_dir
        self.epochs = None
        self.steps = None
        self.epoch = 0
        os.makedirs(log_dir, exist_ok=True)
        self._file = None

    def _log(self, tag, values, step):
        import json
        if self._file is None:
            self._file = open(os.path.join(self.log_dir, "scalars.jsonl"),
                              "a", buffering=1)
        for k, v in (values or {}).items():
            if not isinstance(v, numbers.Number):
                try:
                    v = _scalar(v)
                except (TypeError, ValueError):
                    continue
            self._file.write(json.dumps({"tag": f"{tag}/{k}",
                                         "value": float(v),
                                         "step": int(step)}) + "\n")

    def on_train_end(self, logs=None):
        if self._file is not None:
            self._file.close()
            self._file = None

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch

    def on_train_batch_end(self, step, logs=None):
        self._log("train_batch", logs, step)

    def on_epoch_end(self, epoch, logs=None):
        self._log("train", logs, epoch)

    def on_eval_end(self, logs=None):
        self._log("eval", logs, self.epoch)
