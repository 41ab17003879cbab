"""The training loop around the model on the card: the ``DevicePrefetcher``
(pinned staging, its own copy stream, no device sync when warm),
DataLoader workers forked after CUDA is initialised, checkpoints of card
tensors (bf16 included), and a preempted ``Model.fit`` resumed bit for
bit.

Every test here is marked ``cuda`` and skips without a card (decided in a
fixture at run time); this file imports no JAX.  Run on the chip:
``python -m pytest -m cuda tests/test_torch_*.py``.
"""
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch.framework import preemption
from paddle_tpu_torch.framework.checkpoint import (AsyncCheckpointSaver,
                                                   load_sharded,
                                                   save_sharded)
from paddle_tpu_torch.hapi import DeviceLossList
from paddle_tpu_torch.io import DataLoader, Dataset, DevicePrefetcher
from paddle_tpu_torch.io import dataloader as dl_mod
from paddle_tpu_torch.io import prefetch as pf_mod


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
    preemption.uninstall()
    paddle.set_device("cpu")


class Rows(Dataset):
    def __init__(self, n=64, width=256):
        self.n, self.width = n, width

    def __getitem__(self, i):
        rs = np.random.RandomState(i)
        return rs.randn(self.width).astype(np.float32), np.int64(i % 5)

    def __len__(self):
        return self.n


@pytest.mark.cuda
def test_prefetcher_copies_on_its_own_stream(cuda, monkeypatch):
    made = []

    class Recorded(torch.cuda.Stream):
        def __new__(cls, *a, **k):
            s = super().__new__(cls, *a, **k)
            if "stream_id" not in k:      # a new stream, not a handle
                made.append(s)
            return s

    monkeypatch.setattr(pf_mod.torch.cuda, "Stream", Recorded)
    placed = []
    real = dl_mod._place
    monkeypatch.setattr(dl_mod, "_place",
                        lambda v: placed.append(1) or real(v))
    loader = DataLoader(Rows(), batch_size=8, num_workers=2)
    pf = DevicePrefetcher(loader, depth=2)
    got = [(x.value.clone(), y.value.clone()) for x, y in pf]
    assert len(made) == 1
    assert made[0] != torch.cuda.default_stream(cuda)
    assert placed == []                  # the loader never copied
    monkeypatch.undo()
    ref = list(DataLoader(Rows(), batch_size=8))
    assert len(got) == len(ref) == 8
    for (gx, gy), (rx, ry) in zip(got, ref):
        assert gx.is_cuda and gy.is_cuda
        assert torch.equal(gx, rx.value) and torch.equal(gy, ry.value)
    assert pf.stats()["batches"] == 8


@pytest.mark.cuda
def test_prefetch_warm_loop_waits_for_no_device(cuda):
    w = torch.randn(256, 256, device=cuda)
    pf = DevicePrefetcher(DataLoader(Rows(n=256), batch_size=16,
                                     num_workers=2), depth=3)
    it = iter(pf)
    x, _ = next(it)
    acc = x.value @ w
    time.sleep(0.3)                       # the buffer fills
    n = 0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for x, y in it:                   # a sync anywhere here raises
            acc = acc + (x.value @ w).sum() * y.value.float().mean()
            n += 1
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert n == 15 and torch.isfinite(acc).all()


def _growing(n):
    """``n`` batches whose leaves grow from batch to batch (padded or
    length-bucketed batches), each one's values set by its index."""
    for k in range(n):
        rs = np.random.RandomState(k)
        yield (rs.randn(4, 64 * (k + 1)).astype(np.float32),
               {"ids": np.arange(3 * (k + 1), dtype=np.int64) + k})


@pytest.mark.cuda
def test_prefetch_leaves_growing_batch_to_batch(cuda):
    n, got, errors = 96, [], []
    w = torch.randn(64, 64, device=cuda)

    def consume():
        try:
            for k, (x, d) in enumerate(DevicePrefetcher(_growing(n),
                                                         depth=2)):
                # queue work on the batch so copies overlap compute
                y = x.value.reshape(-1, 64) @ w
                got.append((x.value.cpu(), d["ids"].value.cpu(),
                            bool(torch.isfinite(y).all())))
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive(), f"prefetcher hung after {len(got)} batches"
    assert not errors, errors
    assert len(got) == n
    for (x, ids, finite), (rx, rd) in zip(got, _growing(n)):
        assert finite
        np.testing.assert_array_equal(x.numpy(), rx)
        np.testing.assert_array_equal(ids.numpy(), rd["ids"])


@pytest.mark.cuda
def test_workers_forked_after_cuda_init(cuda):
    torch.zeros(1, device=cuda)
    assert torch.cuda.is_initialized()
    for shm in (True, False):
        loader = DataLoader(Rows(), batch_size=8, num_workers=2,
                            use_shared_memory=shm)
        batches = list(loader)
        assert len(batches) == 8
        assert all(t.value.is_cuda for b in batches for t in b)
        assert loader.shm_batches == (8 if shm else 0)
        want = Rows()[9][0]
        np.testing.assert_array_equal(batches[1][0].numpy()[1], want)


class CardRows(Dataset):
    def __init__(self):
        self.t = torch.zeros(3, device="cuda")

    def __getitem__(self, i):
        return self.t

    def __len__(self):
        return 4


@pytest.mark.cuda
def test_worker_refuses_a_cuda_tensor(cuda):
    with pytest.raises(RuntimeError, match="must never touch CUDA"):
        list(DataLoader(CardRows(), batch_size=2, num_workers=1))


@pytest.mark.cuda
def test_checkpoint_round_trip_of_card_tensors(cuda, tmp_path):
    state = {"w": torch.randn(64, 32, device=cuda),
             "bf": torch.randn(16, 8, device=cuda).to(torch.bfloat16),
             "ids": torch.arange(5, device=cuda),
             "nested": {"s": torch.tensor(3.5, device=cuda)}}
    d = str(tmp_path / "ck")
    save_sharded(state, d)
    out = load_sharded(d)
    for key, want in (("w", state["w"]), ("bf", state["bf"]),
                      ("ids", state["ids"])):
        got = out[key].value
        assert got.is_cuda and got.dtype == want.dtype
        assert torch.equal(got, want)
    assert float(out["nested"]["s"]) == 3.5
    # snapshot isolation: an in-place update right after save()
    saver = AsyncCheckpointSaver(str(tmp_path / "a"))
    before = state["bf"].clone()
    saver.save(state, step=1)
    state["bf"].mul_(0).add_(7)
    saver.wait()
    restored = saver.restore(1)["bf"].value
    assert torch.equal(restored, before)


@pytest.mark.cuda
def test_device_loss_list_one_copy(cuda):
    losses = [torch.tensor(float(i), device=cuda) for i in range(10)]
    dl = DeviceLossList(losses)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        len(dl)                           # no fetch, no sync
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert list(dl) == [float(i) for i in range(10)]


class _SigtermAt(paddle.callbacks.Callback):
    def __init__(self, at):
        super().__init__()
        self.at, self.n = at, 0

    def on_train_batch_end(self, step, logs=None):
        self.n += 1
        if self.n == self.at:
            os.kill(os.getpid(), signal.SIGTERM)


class _Rec(paddle.callbacks.Callback):
    def __init__(self):
        super().__init__()
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(logs["loss"])


@pytest.mark.cuda
def test_fit_preempt_resume_bit_identical_on_the_card(cuda, tmp_path):
    nn = paddle.nn

    def run(ckdir, extra=(), resume=None):
        paddle.seed(1)
        net = nn.Sequential(nn.Linear(256, 128), nn.GELU(), nn.Dropout(0.2),
                            nn.Linear(128, 5))
        model = paddle.Model(net)
        model.prepare(paddle.optimizer.AdamW(
            learning_rate=1e-3, parameters=net.parameters(),
            grad_clip=nn.ClipGradByGlobalNorm(1.0)), nn.CrossEntropyLoss())
        rec = _Rec()
        ck = paddle.callbacks.CheckpointCallback(str(ckdir), every_n_steps=3,
                                                 data_seed=4)
        model.fit(DataLoader(Rows(), batch_size=8, shuffle=True,
                             num_workers=2), epochs=2, verbose=0,
                  prefetch=True, callbacks=[rec, *extra, ck], resume=resume)
        return [float(v[0]) for v in rec.losses], ck

    a, _ = run(tmp_path / "ref")
    b, ck = run(tmp_path / "ck", extra=[_SigtermAt(5)])
    assert ck.preempted and len(b) == 5
    preemption.clear()
    c, _ = run(tmp_path / "ck", resume="auto")
    assert len(a) == 16 and b + c == a
