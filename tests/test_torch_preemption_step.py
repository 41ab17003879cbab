"""The train step's own preemption and its RNG state, on the CPU.

* The RNG leaf: gpt-tiny with dropout on (hidden and attention, 0.1)
  through the port's ``make_train_step``: 3 steps, ``state_dict()``
  through ``AsyncCheckpointSaver``, 3 more; a fresh step restored from
  the checkpoint runs the same 3 steps with the same losses and weights,
  bit for bit.  Without the ``rng`` leaf the tails differ (the dropout
  masks are drawn from generators that moved on).
* The emergency save (``attach_saver``; the JAX spec is
  ``tests/test_robustness.py::test_train_step_emergency_checkpoint_on_
  preemption``): a request, then the next ``__call__`` (or ``run_steps``)
  writes a blocking checkpoint inside a ``checkpoint.emergency`` span,
  marks it saved and raises ``TrainingPreempted`` at the optimizer's step
  count, as the JAX step does on the same schedule; a fresh step restored
  from it continues the uninterrupted run bit for bit.  A real SIGTERM
  under ``preemption.guard()`` takes the same path (the single-device half
  of ``tests/test_elastic.py``; the mesh is ROADMAP module entry 11).
"""
import os
import signal

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import paddle_tpu as jpaddle
import paddle_tpu.distributed as jdist
import paddle_tpu.nn as jnn
from paddle_tpu.framework import preemption as jpreemption
from paddle_tpu.framework.checkpoint import \
    AsyncCheckpointSaver as JaxSaver

from _torch_cpu_place import cpu_place  # noqa: F401
from paddle_tpu_torch.core import random as random_mod
from paddle_tpu_torch.distributed import make_train_step
from paddle_tpu_torch.framework import preemption
from paddle_tpu_torch.framework.checkpoint import (AsyncCheckpointSaver,
                                                   load_sharded,
                                                   save_sharded)
from paddle_tpu_torch.models import GPTPretrainingCriterion, build_gpt
from paddle_tpu_torch.observability import trace
from paddle_tpu_torch.optimizer import AdamW

torch.set_num_threads(1)
T = 32


@pytest.fixture(autouse=True)
def _clean():
    for mod in (preemption, jpreemption):
        mod.clear()
    yield
    for mod in (preemption, jpreemption):
        mod.clear()
        mod.uninstall()


def _seed(s):
    """Seed both generators dropout draws from: the port's (F.dropout)
    and torch's default one (attention dropout)."""
    random_mod.seed(s)
    torch.manual_seed(s)


def _step(seed=0):
    model = build_gpt("gpt-tiny", device="cpu", seed=seed,
                      hidden_dropout_prob=0.1, attention_dropout_prob=0.1)
    opt = AdamW(learning_rate=1e-3, parameters=model, weight_decay=0.01)
    return make_train_step(model, opt, loss_fn=GPTPretrainingCriterion())


def _batches(n, b=2):
    ids = np.random.RandomState(7).randint(0, 1024, size=(n, b, T + 1))
    return [(torch.from_numpy(i[:, :-1]), torch.from_numpy(i[:, 1:]))
            for i in ids.astype(np.int64)]


def _params(step):
    return {n: p.detach().clone() for n, p in
            torch.nn.Module.named_parameters(step.model)}


def _bits(losses):
    return [float(v) for v in losses]


def test_dropout_run_resumes_bit_for_bit(tmp_path):
    _seed(3)
    data = _batches(6)
    step = _step()
    for x, y in data[:3]:
        step(x, y)
    saver = AsyncCheckpointSaver(str(tmp_path / "ck"))
    saver.save(step.state_dict(), step=3, blocking=True)
    tail = _bits(step(x, y) for x, y in data[3:])
    want = _params(step)

    fresh = _step(seed=9)
    _, snap = saver.restore_latest_valid(return_numpy=True)
    fresh.load_state_dict(snap)
    got = _bits(fresh(x, y) for x, y in data[3:])
    assert got == tail
    for n, p in _params(fresh).items():
        assert torch.equal(p, want[n]), n


def test_the_dropout_masks_come_from_the_saved_generators(tmp_path):
    """Without its ``rng`` leaf the same restore gives another tail: the
    leaf is what makes the resume above bit for bit."""
    _seed(3)
    data = _batches(5)
    step = _step()
    for x, y in data[:2]:
        step(x, y)
    snap = step.state_dict()
    tail = _bits(step(x, y) for x, y in data[2:])
    fresh = _step()
    fresh.load_state_dict({k: v for k, v in snap.items() if k != "rng"})
    assert _bits(fresh(x, y) for x, y in data[2:]) != tail


def test_rng_leaf_round_trips_as_plain_arrays(tmp_path):
    random_mod.generator("cpu")     # what a paddle nn.Dropout draws from
    step = _step()
    x, y = _batches(1)[0]
    step(x, y)
    sd = step.state_dict()
    assert set(sd["rng"]) == {"port", "torch"}
    assert set(sd["rng"]["torch"]) == {"cpu"} and "cpu" in sd["rng"]["port"]
    save_sharded(sd, str(tmp_path / "s"))
    back = load_sharded(str(tmp_path / "s"), return_numpy=True)
    for part in ("port", "torch"):
        for dev, s in sd["rng"][part].items():
            arr = back["rng"][part][dev]
            assert isinstance(arr, np.ndarray) and arr.dtype == np.uint8
            np.testing.assert_array_equal(arr, s.numpy())


# -- the emergency save, against the JAX step ----------------------------------

def _jax_step():
    jpaddle.seed(0)
    net = jnn.Sequential(jnn.Linear(4, 8), jnn.ReLU(), jnn.Linear(8, 2))
    opt = jpaddle.optimizer.Adam(parameters=net.parameters(),
                                 learning_rate=1e-2)
    return jdist.make_train_step(net, opt, loss_fn=jnn.MSELoss())


def _jax_batches(n, bs=4):
    rs = np.random.RandomState(0)
    return [(rs.randn(bs, 4).astype("float32"),
             rs.randn(bs, 2).astype("float32")) for _ in range(n)]


def _stack(batches):
    return tuple(np.stack([b[i] for b in batches]) if isinstance(
        batches[0][i], np.ndarray) else torch.stack([b[i] for b in batches])
        for i in range(2))


def _preempted(pkg, step, saver, first, second, run_steps):
    """One step (or one ``run_steps`` of two), a request, then the next:
    what the preemption left behind."""
    mod = jpreemption if pkg == "jax" else preemption
    step.attach_saver(saver)
    if run_steps:
        step.run_steps(*_stack(first))
    else:
        step(*first[0])
    mod.request()
    with pytest.raises(mod.TrainingPreempted) as ei:
        if run_steps:
            step.run_steps(*_stack(second))
        else:
            step(*second[0])
    return dict(raised=ei.value.step, saved=saver.steps(),
                last=mod.last_saved_step(), count=step.optimizer._step_count)


@pytest.mark.parametrize("run_steps", [False, True], ids=["call",
                                                          "run_steps"])
def test_emergency_save_matches_the_jax_step(tmp_path, run_steps):
    k = 2 if run_steps else 1
    jdata = _jax_batches(4 * k)
    jres = _preempted("jax", _jax_step(), JaxSaver(str(tmp_path / "j")),
                      jdata[:k], jdata[k:2 * k], run_steps)

    _seed(5)
    data = _batches(4 * k)
    n_spans = len(trace.spans("checkpoint.emergency"))
    saver = AsyncCheckpointSaver(str(tmp_path / "p"))
    pres = _preempted("port", _step(), saver, data[:k], data[k:2 * k],
                      run_steps)
    assert pres == jres == dict(raised=2 * k, saved=[2 * k], last=2 * k,
                                count=2 * k)
    spans = trace.spans("checkpoint.emergency")[n_spans:]
    assert [s["attrs"]["step"] for s in spans] == [2 * k]

    # a fresh step restores and continues where the kill landed, as an
    # unbroken run of the same seed does (run first: the generators are
    # the process's)
    preemption.clear()
    _seed(5)
    ref = _step()
    for x, y in data[:2 * k]:
        ref(x, y)
    want = _bits(ref(x, y) for x, y in data[2 * k:])
    fresh = _step(seed=9)
    _, snap = saver.restore_latest_valid()
    fresh.load_state_dict(snap)
    if run_steps:
        got = _bits(fresh.run_steps(*_stack(data[2 * k:3 * k])))
        got += _bits(fresh.run_steps(*_stack(data[3 * k:])))
    else:
        got = _bits(fresh(x, y) for x, y in data[2 * k:])
    assert got == want


def test_no_saver_no_emergency_save(tmp_path):
    step = _step()
    x, y = _batches(1)[0]
    preemption.request()
    step(x, y)             # no saver attached: the step carries on
    assert step.optimizer._step_count == 1


def test_sigterm_under_guard_saves_and_stops(tmp_path):
    _seed(11)
    data = _batches(5)
    saver = AsyncCheckpointSaver(str(tmp_path / "ck"))
    step = _step().attach_saver(saver)
    losses = []
    with preemption.guard():
        with pytest.raises(preemption.TrainingPreempted) as ei:
            for i, (x, y) in enumerate(data):
                if i == 3:
                    os.kill(os.getpid(), signal.SIGTERM)
                losses.append(float(step(x, y)))
    assert ei.value.step == 4 and saver.steps() == [4]
    assert len(losses) == 3 and preemption.requested()
    preemption.clear()
    _seed(11)
    ref = _step()
    want = _bits(ref(x, y) for x, y in data)
    fresh = _step(seed=1)
    _, snap = saver.restore_latest_valid()
    fresh.load_state_dict(snap)
    assert losses == want[:3]
    assert _bits([fresh(*data[4])]) == want[4:]
