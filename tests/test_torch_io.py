"""The port's input pipeline against the JAX package's: datasets,
samplers, the DataLoader (single process, forked workers over the
shared-memory ring or a pickling queue) and the ``DevicePrefetcher``.

The samplers draw from ``np.random`` as the JAX ones do, so the same
seeds give the same index sequences, and the loaders give the same
batches.  The shm ring is the port's own copy of ``shm_ring.cpp``, built
with g++ at first use into ``build/``.  Every ``DevicePrefetcher``
contract of the JAX package's ``test_prefetch.py`` that needs no mesh
holds here on the CPU (the card's copy stream is in
``test_torch_fit_cuda.py``).
"""
import threading
import time

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import paddle_tpu.io as jio

import paddle_tpu_torch as paddle
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.distributed import make_train_step
from paddle_tpu_torch.io import (BatchSampler, ChainDataset, ComposeDataset,
                                 ConcatDataset, DataLoader, Dataset,
                                 DevicePrefetcher, DistributedBatchSampler,
                                 IterableDataset, RandomSampler,
                                 SequenceSampler, Subset, TensorDataset,
                                 WeightedRandomSampler, default_collate_fn,
                                 get_worker_info, random_split)
from paddle_tpu_torch.io import dataloader as dl_mod
from paddle_tpu_torch.io import shm_channel
from paddle_tpu_torch.io.shm_channel import (ShmQueue, decode_batch,
                                             encode_batch)
from paddle_tpu_torch.observability import flight
from paddle_tpu_torch.observability import steps as steps_mod
from paddle_tpu_torch.utils import native_build

from _torch_cpu_place import cpu_place  # noqa: F401


class Rows:
    """A map-style dataset of seeded rows, defined for both packages."""

    def __init__(self, n, base):
        self.n = n
        self.base = base

    def __getitem__(self, i):
        rs = np.random.RandomState(100 + i)
        return (rs.randn(3).astype(np.float32), np.int64(i),
                rs.randint(0, 5, (2,)).astype(np.int64))

    def __len__(self):
        return self.n


def _rows(pkg, n=22):
    cls = type("Rows", (Rows, pkg.Dataset), {})
    return cls(n, pkg)


def _as_np(batch):
    return [t.numpy() for t in batch]


# -- samplers ------------------------------------------------------------------

def _seq(make, seed):
    np.random.seed(seed)
    return [list(b) if isinstance(b, list) else b for b in make()]


@pytest.mark.parametrize("case", ["random", "random_replacement",
                                  "weighted", "batch_shuffle",
                                  "batch_sequence_drop_last"])
def test_sampler_sequences_equal_jax(case):
    data = list(range(23))

    def make(pkg):
        if case == "random":
            return pkg.RandomSampler(data)
        if case == "random_replacement":
            return pkg.RandomSampler(data, replacement=True, num_samples=40)
        if case == "weighted":
            return pkg.WeightedRandomSampler(np.arange(1, 24), 30)
        if case == "batch_shuffle":
            return pkg.BatchSampler(data, shuffle=True, batch_size=5)
        return pkg.BatchSampler(data, shuffle=False, batch_size=5,
                                drop_last=True)

    for seed in (0, 7):
        got = _seq(lambda: list(make(paddle.io)), seed)
        want = _seq(lambda: list(make(jio)), seed)
        assert got == want
    assert len(make(paddle.io)) == len(make(jio))


@pytest.mark.parametrize("shuffle", [False, True])
def test_distributed_batch_sampler_equal_jax(shuffle, monkeypatch):
    data = list(range(21))
    for rank in range(3):
        got = DistributedBatchSampler(data, 4, num_replicas=3, rank=rank,
                                      shuffle=shuffle)
        want = jio.DistributedBatchSampler(data, 4, num_replicas=3,
                                           rank=rank, shuffle=shuffle)
        for epoch in range(2):
            got.set_epoch(epoch)
            want.set_epoch(epoch)
            assert list(got) == list(want)
        assert len(got) == len(want)
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    s = DistributedBatchSampler(data, 4)
    assert (s.nranks, s.local_rank) == (2, 1)


def test_random_split_and_datasets_equal_jax():
    np.random.seed(3)
    got = [list(s.indices) for s in random_split(list(range(10)), [3, 7])]
    np.random.seed(3)
    want = [list(s.indices) for s in jio.random_split(list(range(10)),
                                                       [3, 7])]
    assert got == want
    t = TensorDataset([np.arange(6).reshape(3, 2), np.arange(3)])
    assert len(t) == 3 and t[1][1] == 1
    assert Subset(t, [2, 0])[0][1] == 2
    c = ConcatDataset([list(range(3)), list(range(10, 14))])
    assert len(c) == 7 and c[4] == 11 and c[-1] == 13
    comp = ComposeDataset([TensorDataset([np.arange(3)]),
                           TensorDataset([np.arange(3) * 2])])
    assert comp[2] == (2, 4)

    class It(IterableDataset):
        def __init__(self, n):
            self.n = n

        def __iter__(self):
            return iter(range(self.n))

    assert [v for v in ChainDataset([It(2), It(3)])] == [0, 1, 0, 1, 2]
    assert list(SequenceSampler(list(range(4)))) == [0, 1, 2, 3]


def test_default_collate_equal_jax():
    samples = [{"a": np.full((2,), i, "f4"), "b": (i, float(i))}
               for i in range(3)]
    got, want = default_collate_fn(samples), jio.default_collate_fn(samples)
    np.testing.assert_array_equal(got["a"], want["a"])
    for g, w in zip(got["b"], want["b"]):
        np.testing.assert_array_equal(g, w)
    # CPU tensors (surface or torch) collate to a host array
    out = default_collate_fn([paddle.to_tensor(np.ones(2, "f4")),
                              torch.zeros(2)])
    assert isinstance(out, np.ndarray) and out.shape == (2, 2)


# -- loaders -----------------------------------------------------------------

def _loader_batches(pkg, seed, **kw):
    np.random.seed(seed)
    loader = pkg.DataLoader(_rows(pkg), batch_size=4, **kw)
    return [_as_np(b) for b in loader], loader


@pytest.mark.parametrize("workers,shm", [(0, True), (2, True), (3, False)],
                         ids=["single", "workers-shm", "workers-queue"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_loaders_equal_each_other_and_jax(workers, shm, shuffle):
    """The same batches as the JAX loader with the same workers; without
    a shuffle, the same as the single-process loader too (with one, a
    worker loader draws the workers' seed from ``np.random`` before the
    permutation, in both packages)."""
    kw = dict(shuffle=shuffle, num_workers=workers, use_shared_memory=shm)
    want, _ = _loader_batches(jio, 5, **kw)
    got, loader = _loader_batches(paddle.io, 5, **kw)
    single, _ = _loader_batches(paddle.io, 5, shuffle=shuffle)
    assert len(got) == len(want) == len(single) == 6
    for g, w, one in zip(got, want, single):
        for a, b, c in zip(g, w, one):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
            if not shuffle:
                np.testing.assert_array_equal(a, c)
    assert loader.shm_batches == (6 if workers and shm else 0)


def test_loader_batches_are_tensors_on_the_current_place():
    batch = next(iter(DataLoader(_rows(paddle.io), batch_size=4,
                                 num_workers=2)))
    assert all(isinstance(t, paddle.Tensor) for t in batch)
    assert {str(t.place) for t in batch} == {str(paddle.CPUPlace())}
    # the host iterator hands the prefetcher unplaced host values
    host = next(iter(DataLoader(_rows(paddle.io), batch_size=4)._host_iter()))
    assert all(isinstance(a, np.ndarray) for a in host)


def test_iterable_dataset_in_workers_and_worker_info():
    class Stream(IterableDataset):
        def __iter__(self):
            info = get_worker_info()
            wid = -1 if info is None else info.id
            for i in range(6):
                yield np.array([i, wid], np.int64)

    single = [b.numpy() for b in DataLoader(Stream(), batch_size=4)]
    assert [b[:, 1].tolist() for b in single] == [[-1] * 4, [-1] * 2]
    multi = [b.numpy() for b in DataLoader(Stream(), batch_size=3,
                                           num_workers=2)]
    assert {int(b[0, 1]) for b in multi} == {0, 1}


class _Boom(Dataset):
    def __getitem__(self, i):
        if i == 5:
            raise KeyError("bad row 5")
        return np.zeros(2, np.float32)

    def __len__(self):
        return 12


@pytest.mark.parametrize("shm", [True, False])
def test_worker_error_propagates(shm):
    loader = DataLoader(_Boom(), batch_size=2, num_workers=2,
                        use_shared_memory=shm)
    it = iter(loader)
    next(it)
    next(it)
    with pytest.raises(RuntimeError, match="bad row 5"):
        next(it)


def test_shm_ring_builds_into_the_build_dir():
    assert shm_channel.available()
    root = native_build.BUILD_ROOT
    assert root.parts[-3:] == ("build", "paddle_tpu_torch", "native")
    assert list(root.glob("*/libshm_ring.so"))


def test_codec_roundtrip():
    arrs = [np.arange(12, dtype="float32").reshape(3, 4),
            np.array([7], "int64"), np.zeros((), "float64")]
    bid, out = decode_batch(encode_batch(3, arrs))
    assert bid == 3 and isinstance(out, list)
    for a, b in zip(arrs, out):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert isinstance(decode_batch(encode_batch(4, tuple(arrs)))[1], tuple)
    assert isinstance(decode_batch(encode_batch(5, arrs[0]))[1], np.ndarray)
    obj = np.array([None, "x"], dtype=object)
    assert decode_batch(encode_batch(6, [obj]))[1][0].tolist() == [None, "x"]
    assert decode_batch(encode_batch(9, {"k": [1, 2]})) == (9, {"k": [1, 2]})
    # the JAX package's codec reads the port's messages and back
    from paddle_tpu.io import shm_channel as jshm
    assert jshm.decode_batch(encode_batch(7, arrs))[0] == 7
    np.testing.assert_array_equal(
        decode_batch(jshm.encode_batch(8, arrs))[1][0], arrs[0])


def test_ring_backpressure_and_oversized_message():
    q = ShmQueue(capacity=1 << 11)
    msg = encode_batch(0, [np.zeros(450, "float32")])
    q.put(msg)
    with pytest.raises(TimeoutError):
        q.put(msg, timeout_ms=200)
    q.get()
    q.put(msg, timeout_ms=200)
    q.close()
    q.free()
    q = ShmQueue(capacity=1 << 12)
    with pytest.raises(ValueError, match="exceeds ring capacity"):
        q.put(b"x" * (1 << 13))
    q.close()
    with pytest.raises(BrokenPipeError):
        q.put(b"x")
    q.free()


def test_shm_build_failure_raises(monkeypatch, tmp_path):
    """No fallback: a ring that cannot be built fails the loader."""
    monkeypatch.setattr(shm_channel, "_LIB", None)
    monkeypatch.setattr(shm_channel, "_LIB_ERR", RuntimeError("no g++"))
    with pytest.raises(RuntimeError, match="shm ring unavailable"):
        iter(DataLoader(_rows(paddle.io), batch_size=4, num_workers=1))


# -- DevicePrefetcher ----------------------------------------------------------

class Range(Dataset):
    def __init__(self, n):
        self.n = n

    def __getitem__(self, i):
        return np.full((4,), i, np.float32), np.int64(i % 3)

    def __len__(self):
        return self.n


def _loader(n=12, batch_size=4, **kw):
    return DataLoader(Range(n), batch_size=batch_size, shuffle=False, **kw)


@pytest.mark.parametrize("workers", [0, 2])
def test_prefetch_ordering_parity_with_unwrapped_loader(workers):
    loader = _loader(20, num_workers=workers)
    pf = DevicePrefetcher(loader, depth=2)
    got = [(x.numpy().copy(), y.numpy().copy()) for x, y in pf]
    ref = [(x.numpy(), y.numpy()) for x, y in loader]
    assert len(got) == len(ref) == 5
    for (gx, gy), (rx, ry) in zip(got, ref):
        np.testing.assert_array_equal(gx, rx)
        np.testing.assert_array_equal(gy, ry)
    assert pf.stats()["batches"] == 5


def test_prefetcher_takes_the_loaders_host_batches(monkeypatch):
    """The loader never places a batch itself when wrapped: the one copy
    is the prefetcher's."""
    placed = []
    real = dl_mod._place
    monkeypatch.setattr(dl_mod, "_place",
                        lambda v: placed.append(1) or real(v))
    assert len(list(DevicePrefetcher(_loader(8), depth=2))) == 2
    assert placed == []
    list(_loader(8))
    assert len(placed) == 4


def test_prefetch_reiterable_fresh_epochs():
    pf = DevicePrefetcher(_loader(8), depth=2)
    for _ in range(2):
        assert sum(1 for _ in pf) == 2
    assert len(pf) == 2


def test_prefetch_bounded_buffer_never_runs_ahead():
    pulled = [0]

    def src():
        for i in range(16):
            pulled[0] += 1
            yield (np.full((2,), i, np.float32),)

    depth = 2
    got = 0
    for _ in DevicePrefetcher(src(), depth=depth):
        got += 1
        time.sleep(0.01)
        assert pulled[0] <= got + depth + 1, (pulled[0], got)
    assert got == 16


def test_prefetch_producer_exception_propagates_in_order():
    def src():
        yield (np.zeros((2,), np.float32),)
        raise ValueError("boom at batch 1")

    it = iter(DevicePrefetcher(src(), depth=2))
    next(it)
    with pytest.raises(ValueError, match="boom at batch 1"):
        next(it)
    with pytest.raises(StopIteration):
        next(it)


def test_prefetch_early_exit_shuts_down_producer_and_workers():
    loader = _loader(400, batch_size=1, num_workers=2)
    pf = DevicePrefetcher(loader, depth=2, name="earlyexit")
    it = iter(pf)
    next(it)
    it.close()
    deadline = time.time() + 5
    while time.time() < deadline:
        alive = [t for t in threading.enumerate()
                 if t.name.startswith("prefetch-earlyexit") and t.is_alive()]
        if not alive:
            break
        time.sleep(0.02)
    assert not alive, f"leaked producer threads: {alive}"
    import multiprocessing as mp
    deadline = time.time() + 5
    while mp.active_children() and time.time() < deadline:
        time.sleep(0.05)
    assert not mp.active_children()


def test_prefetch_mesh_raises_unported():
    with pytest.raises(NotImplementedError, match="module item 11"):
        DevicePrefetcher(_loader(8), mesh=object())


def test_prefetched_stack_feeds_run_steps():
    paddle.seed(4)
    torch.manual_seed(4)
    model = torch.nn.Linear(4, 2)
    step = make_train_step(model, paddle.optimizer.Adam(
        learning_rate=0.05, parameters=model), loss_fn=torch.nn.MSELoss())
    rs = np.random.RandomState(0)
    xs = rs.randn(3, 8, 4).astype(np.float32)
    ys = rs.randn(3, 8, 2).astype(np.float32)
    (px, py), = list(DevicePrefetcher([(xs, ys)], depth=1, stacked=True))
    assert isinstance(px, paddle.Tensor) and px.shape == [3, 8, 4]
    out = step.run_steps(px, py)
    assert out.shape == (3,) and torch.isfinite(out).all()
    assert step.compile_count == 1


def test_prefetch_metrics_and_stall_flight_event():
    def slow_src():
        for i in range(4):
            time.sleep(0.05)
            yield (np.full((2,), i, np.float32),)

    obs.enable(True)
    try:
        flight.clear()
        pf = DevicePrefetcher(slow_src(), depth=2, name="stall_probe")
        assert len(list(pf)) == 4
        st = pf.stats()
        assert st["wait_seconds"] > 0 and st["stalls"] >= 1
        reg = obs.registry()
        assert reg.get(steps_mod.HOST_INPUT_WAIT).total() > 0
        assert reg.get(steps_mod.PREFETCH_DEPTH) is not None
        assert reg.get(steps_mod.PREFETCH_BATCHES).value(
            labels={"fn": "stall_probe"}) == 4
        assert reg.get(steps_mod.PIPELINE_STALLS).total() >= 1
        evs = flight.events("pipeline_stall")
        assert evs and evs[0]["name"] == "stall_probe"
        assert evs[0]["attrs"]["waited_ms"] > 0
    finally:
        obs.disable()
        obs.registry().reset()


def test_prefetch_warm_buffer_records_no_stall():
    def fast_src():
        for i in range(6):
            yield (np.full((2,), i, np.float32),)

    flight.clear()
    pf = DevicePrefetcher(fast_src(), depth=2, name="warm_probe")
    it = iter(pf)
    assert next(it) is not None      # cold: a wait, not a stall
    time.sleep(0.1)
    rest = []
    for b in it:
        rest.append(b)
        time.sleep(0.02)
    assert len(rest) == 5 and pf.stats()["stalls"] == 0
    assert not [e for e in flight.events("pipeline_stall")
                if e["name"] == "warm_probe"]


def test_prefetch_leaves_growing_batch_to_batch():
    def growing(n):
        for k in range(n):
            rs = np.random.RandomState(k)
            yield (rs.randn(2, 8 * (k + 1)).astype(np.float32),
                   np.arange(k + 1, dtype=np.int64))

    got = list(DevicePrefetcher(growing(40), depth=2, device="cpu"))
    ref = list(growing(40))
    assert len(got) == len(ref)
    for (x, i), (rx, ri) in zip(got, ref):
        np.testing.assert_array_equal(x.numpy(), rx)
        np.testing.assert_array_equal(i.numpy(), ri)


def test_prefetch_nests_and_dtypes():
    src = [{"x": np.ones((2, 3), np.float16), "y": [np.arange(2), 7],
            "t": torch.zeros(2, dtype=torch.bfloat16)}]
    (b,) = list(DevicePrefetcher(src, depth=1))
    assert b["x"].dtype == torch.float16 and b["x"].shape == [2, 3]
    assert b["y"][0].numpy().tolist() == [0, 1] and b["y"][1] == 7
    assert b["t"].dtype == torch.bfloat16
