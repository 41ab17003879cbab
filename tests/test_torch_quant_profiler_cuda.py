"""Quantization, the profiler and the step's preemption on the card.

* ``HistObserver`` on card tensors bins on the device: the same counts
  as a CPU observer on the same batches (the bins' counts are the only
  copy to the host), so every algo's threshold lies within one bin width
  of the CPU's.
* The abs-max EMA observer, a QAT ``QuantedLinear`` forward and backward
  and the fake quant's STE run under ``set_sync_debug_mode("error")``:
  no host sync per forward.
* A GPU-target ``Profiler`` window writes a ``torch.profiler`` trace that
  names the window's kernels and its ``RecordEvent`` spans.
* A card step with dropout, saved and restored through
  ``AsyncCheckpointSaver``, continues bit for bit (the ``rng`` leaf holds
  the card generators' states).

Every test here is marked ``cuda`` and skips without a card (decided in a
fixture at run time); this file imports no JAX.  Run on the chip:
``python -m pytest -m cuda tests/test_torch_*.py``.
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import profiler as pprof
from paddle_tpu_torch import quantization as pq
from paddle_tpu_torch.framework import preemption

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the chip)")
    torch.backends.cuda.matmul.allow_tf32 = False
    paddle.set_device("gpu")
    preemption.clear()
    yield torch.device("cuda", 0)
    torch.cuda.set_sync_debug_mode("default")
    preemption.clear()
    paddle.set_device("cpu")


@pytest.mark.parametrize("algo", ["kl", "hist", "mse", "avg", "abs_max"])
def test_device_histogram_matches_the_cpus(cuda, algo):
    rs = np.random.RandomState(0)
    batches = [np.concatenate([rs.standard_normal(200000) * s,
                               [40.0 * s]]).astype(np.float32)
               for s in (1.0, 2.5, 0.7, 4.0)]
    obs = {}
    for where in ("cpu", cuda):
        o = pq.HistObserver(algo=algo).to(where)
        for b in batches:
            o(torch.from_numpy(b).to(where))
        o.finalize()
        obs[str(where)] = o
    c, g = obs["cpu"], obs[str(cuda)]
    assert g._range == c._range
    np.testing.assert_array_equal(g._hist, c._hist)
    bw = c._range / c.bins
    assert abs(float(g._buffers["scale"]) - float(c._buffers["scale"])) \
        <= bw
    assert g._buffers["scale"].device.type == "cuda"


def test_ema_observer_and_qat_forward_do_not_sync(cuda):
    torch.manual_seed(0)
    with torch.device(cuda):
        net = pnn.Sequential(pnn.Linear(64, 64), pnn.ReLU(),
                             pnn.Linear(64, 8))
    net = pq.QAT(pq.QuantConfig()).quantize(net)
    x = torch.randn(32, 64, device=cuda)
    net(x).sum().backward()                     # warm: allocations
    obs = pq.FakeQuanterWithAbsMaxObserver().to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            loss = net(x).square().mean()
            loss.backward()
        for _ in range(3):
            obs(x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    w = net[0].inner._parameters["weight"]
    assert w.grad is not None and float(w.grad.abs().sum()) > 0
    assert obs._buffers["scale"].device.type == "cuda"
    np.testing.assert_allclose(float(obs._buffers["scale"]),
                               float(x.abs().max()), rtol=1e-6)


def test_gpu_target_profiler_trace_names_kernels(cuda, tmp_path):
    a = torch.randn(512, 512, device=cuda)
    p = pprof.Profiler(targets=[pprof.ProfilerTarget.CPU,
                                pprof.ProfilerTarget.GPU],
                       scheduler=(1, 3),
                       on_trace_ready=pprof.export_chrome_tracing(
                           str(tmp_path)))
    p.start()
    for _ in range(4):
        with pprof.RecordEvent("matmul_step"):
            (a @ a).sum()
        p.step()
    p.stop()
    assert len(p.device_trace_paths) == 1
    events = json.load(open(p.device_trace_path))["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    assert kernels, "the device trace holds no kernel"
    marks = [e for e in events if e.get("name") == "matmul_step"]
    assert len(marks) >= 2
    assert "matmul_step" in p.summary()
    assert len(list(tmp_path.glob("*.paddle_trace.json"))) == 1


def test_card_step_with_dropout_resumes_bit_for_bit(cuda, tmp_path):
    from paddle_tpu_torch.distributed import make_train_step
    from paddle_tpu_torch.framework.checkpoint import AsyncCheckpointSaver
    from paddle_tpu_torch.models import GPTPretrainingCriterion, build_gpt
    from paddle_tpu_torch.optimizer import AdamW

    def step_of(seed):
        m = build_gpt("gpt-tiny", device=cuda, seed=seed,
                      hidden_dropout_prob=0.1, attention_dropout_prob=0.1)
        return make_train_step(m, AdamW(learning_rate=1e-3, parameters=m),
                               loss_fn=GPTPretrainingCriterion(),
                               compute_dtype=torch.bfloat16)

    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, 1024, (5, 4, 129))).to(cuda)
    torch.manual_seed(1)
    paddle.seed(1)
    saver = AsyncCheckpointSaver(str(tmp_path / "ck"))
    step = step_of(0).attach_saver(saver)
    for i in range(2):
        step(ids[i, :, :-1], ids[i, :, 1:])
    preemption.request()
    with pytest.raises(preemption.TrainingPreempted):
        step(ids[2, :, :-1], ids[2, :, 1:])
    preemption.clear()
    assert saver.steps() == [3]
    want = [float(step(ids[i, :, :-1], ids[i, :, 1:])) for i in (3, 4)]
    fresh = step_of(7)
    _, snap = saver.restore_latest_valid()
    fresh.load_state_dict(snap)
    got = [float(fresh(ids[i, :, :-1], ids[i, :, 1:])) for i in (3, 4)]
    assert got == want
