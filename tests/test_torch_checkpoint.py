"""The port's checkpoints against the JAX package's: ``save_sharded`` /
``load_sharded``, ``AsyncCheckpointSaver``, the fault points, preemption,
``TrainEpochRange``, the filesystem clients and ``paddle.save`` /
``paddle.load``.

Both packages write the same layout (one ``.npy`` a leaf, the manifest
with dtypes, shapes and CRC32s, the ``COMMITTED`` marker last), so the
same f32 state gives the same manifest, and each package restores the
other's files.  The port writes a bf16 leaf as its 16-bit pattern with
``"dtype": "bfloat16"`` (the JAX package's layout) and restores it as
bf16; the JAX package cannot restore one (``load_sharded`` raises, and
``return_numpy=True`` gives ``|V2``), a quirk the port does not copy.
The port's step updates tensors in place, so an async ``save()`` copies
every leaf before it returns (snapshot isolation).
"""
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp

import paddle_tpu as jpaddle
from paddle_tpu.framework import checkpoint as jck
from paddle_tpu.framework import io as jio
from paddle_tpu.incubate.checkpoint import TrainEpochRange as JaxRange

import paddle_tpu_torch as paddle
from paddle_tpu_torch import nn
from paddle_tpu_torch.distributed import make_train_step
from paddle_tpu_torch.distributed.fleet.utils.fs import HDFSClient, LocalFS
from paddle_tpu_torch.framework import preemption
from paddle_tpu_torch.framework.checkpoint import (AsyncCheckpointSaver,
                                                   CheckpointCorruptError,
                                                   is_committed,
                                                   load_sharded,
                                                   save_sharded)
from paddle_tpu_torch.incubate.checkpoint import TrainEpochRange
from paddle_tpu_torch.observability import flight, registry
from paddle_tpu_torch.testing import FaultInjected, faults
from paddle_tpu_torch.utils.retry import retry_call

from _torch_cpu_place import cpu_place  # noqa: F401


@pytest.fixture(autouse=True)
def _clean():
    faults.reset()
    preemption.clear()
    yield
    faults.reset()
    preemption.clear()
    preemption.uninstall()


def _state(scale=1.0):
    return {"w": np.arange(8, dtype="float32") * scale,
            "nested": {"b": np.ones((3, 2), "float32") * scale},
            "step": np.array(3)}


def _manifest(d):
    with open(os.path.join(d, "manifest.json")) as fh:
        return json.load(fh)


# -- the format against the JAX package's ------------------------------------

def test_roundtrip_of_every_leaf_kind(tmp_path):
    d = str(tmp_path / "ck")
    bf = torch.randn(4, 3).to(torch.bfloat16)
    state = {"t": torch.arange(6, dtype=torch.float32).reshape(2, 3),
             "bf": bf, "i": torch.tensor([1, 2], dtype=torch.int64),
             "surface": paddle.to_tensor(np.ones(2, "float32")),
             "np": np.arange(3, dtype="int32"), "scalar": 7,
             "name": "run-1", "nested": {"x": np.zeros((2, 2), "f4")}}
    save_sharded(state, d)
    assert is_committed(d)
    out = load_sharded(d, return_numpy=True)
    np.testing.assert_array_equal(out["t"], state["t"].numpy())
    assert out["bf"].dtype == torch.bfloat16
    assert torch.equal(out["bf"], bf)
    np.testing.assert_array_equal(out["i"], [1, 2])
    np.testing.assert_array_equal(out["surface"], [1.0, 1.0])
    assert out["scalar"] == 7 and out["name"] == "run-1"
    assert out["nested"]["x"].shape == (2, 2)
    as_tensors = load_sharded(d)
    assert isinstance(as_tensors["bf"], paddle.Tensor)
    assert as_tensors["bf"].dtype == torch.bfloat16
    assert _manifest(d)["tensors"]["bf"]["dtype"] == "bfloat16"


def test_manifest_equal_to_jax_for_the_same_state(tmp_path):
    rs = np.random.RandomState(0)
    state = {"model": {"w": rs.randn(4, 5).astype("f4"),
                       "b": rs.randn(5).astype("f4")},
             "ids": rs.randint(0, 9, (3,)).astype("int64"), "epoch": 2}
    save_sharded(state, str(tmp_path / "port"))
    jck.save_sharded(state, str(tmp_path / "jax"))
    a, b = _manifest(str(tmp_path / "port")), _manifest(str(tmp_path / "jax"))
    assert a["tensors"] == b["tensors"]
    assert a["scalars"] == b["scalars"] and a["format"] == b["format"]
    for meta in a["tensors"].values():
        with open(tmp_path / "port" / meta["file"], "rb") as x, \
                open(tmp_path / "jax" / meta["file"], "rb") as y:
            assert x.read() == y.read()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cross_reads(tmp_path, writer):
    d = str(tmp_path / "ck")
    (jck.save_sharded if writer == "jax" else save_sharded)(_state(2.0), d)
    for load in (jck.load_sharded, load_sharded):
        out = load(d, return_numpy=True)
        np.testing.assert_array_equal(out["w"], _state(2.0)["w"])
        np.testing.assert_array_equal(out["nested"]["b"],
                                      _state(2.0)["nested"]["b"])
        assert int(np.asarray(out["step"])) == 3


def test_jax_written_bf16_leaf_restores_as_bf16(tmp_path):
    d = str(tmp_path / "ck")
    vals = np.random.RandomState(1).randn(6).astype("f4")
    jck.save_sharded({"w": jnp.asarray(vals, jnp.bfloat16)}, d)
    meta = _manifest(d)["tensors"]["w"]
    assert meta["dtype"] == "bfloat16"
    out = load_sharded(d, return_numpy=True)["w"]
    assert out.dtype == torch.bfloat16
    want = torch.from_numpy(vals).to(torch.bfloat16)
    assert torch.equal(out, want)
    # the port writes the same bytes and CRC for the same values
    save_sharded({"w": want}, str(tmp_path / "port"))
    assert _manifest(str(tmp_path / "port"))["tensors"]["w"] == meta


def test_jax_cannot_restore_a_bf16_leaf(tmp_path):
    """The JAX package's quirk the port does not copy: its own bf16 leaf
    comes back as raw ``|V2`` bytes, or not at all."""
    d = str(tmp_path / "ck")
    jck.save_sharded({"w": jnp.ones(3, jnp.bfloat16)}, d)
    assert jck.load_sharded(d, return_numpy=True)["w"].dtype == \
        np.dtype("V2")
    with pytest.raises(TypeError):
        jck.load_sharded(d)
    assert load_sharded(d, return_numpy=True)["w"].dtype == torch.bfloat16


def test_load_rejects_uncommitted_and_corrupt(tmp_path):
    d = str(tmp_path / "ck")
    save_sharded(_state(), d)
    os.remove(os.path.join(d, "COMMITTED"))
    with pytest.raises(CheckpointCorruptError, match="COMMITTED"):
        load_sharded(d)
    d2 = str(tmp_path / "ck2")
    save_sharded(_state(), d2)
    fname = _manifest(d2)["tensors"]["w"]["file"]
    np.save(os.path.join(d2, fname), np.arange(8, dtype="float32") + 99)
    with pytest.raises(CheckpointCorruptError, match="CRC32") as ei:
        load_sharded(d2)
    assert ei.value.leaf == "w"
    d3 = str(tmp_path / "ck3")
    save_sharded(_state(), d3)
    with open(os.path.join(d3, fname), "r+b") as fh:
        fh.truncate(10)
    with pytest.raises(CheckpointCorruptError):
        load_sharded(d3)


def test_mesh_restore_raises_unported(tmp_path):
    saver = AsyncCheckpointSaver(str(tmp_path / "a"))
    saver.save(_state(), step=1, blocking=True)
    with pytest.raises(NotImplementedError, match="module item 11"):
        saver.restore_latest_valid(target_mesh=object())
    with pytest.raises(NotImplementedError):
        load_sharded(saver._step_dir(1), target_mesh=object())
    assert saver.steps() == [1]            # never quarantined


# -- the async saver -----------------------------------------------------------

def test_async_saver_snapshot_isolation(tmp_path):
    """The async write captures values at save() time: the port updates
    parameters in place, after save() returns."""
    saver = AsyncCheckpointSaver(str(tmp_path / "iso"), keep_last=2)
    net = nn.Sequential(nn.Linear(4, 3))
    w_before = net.state_dict()["0.weight"].numpy().copy()
    slow = faults.arm("checkpoint.write", mode="delay", seconds=0.2,
                      times=None)
    saver.save({"model": net.state_dict(),
                "raw": {"w": net[0].weight.value}}, step=0)
    with torch.no_grad():
        net[0].weight.value.fill_(5.0)          # in place
    saver.wait()
    assert slow.triggered >= 2
    restored = saver.restore(0, return_numpy=True)
    np.testing.assert_array_equal(restored["model"]["0.weight"], w_before)
    np.testing.assert_array_equal(restored["raw"]["w"], w_before)


def test_async_saver_and_prune(tmp_path):
    saver = AsyncCheckpointSaver(str(tmp_path / "a"), keep_last=2)
    for s in range(4):
        saver.save(_state(float(s)), step=s)
    saver.wait()
    assert saver.steps() == [2, 3]
    np.testing.assert_array_equal(saver.restore(return_numpy=True)["w"],
                                  _state(3.0)["w"])


LOCAL_CRASH_POINTS = ["checkpoint.write", "checkpoint.manifest",
                      "checkpoint.commit", "checkpoint.promote"]


@pytest.mark.parametrize("mode", ["raise", "torn"])
@pytest.mark.parametrize("point", LOCAL_CRASH_POINTS)
def test_crash_matrix_local_leaves_prior_restorable(tmp_path, point, mode):
    saver = AsyncCheckpointSaver(str(tmp_path / "a"), keep_last=3)
    saver.save(_state(1.0), step=1, blocking=True)
    with faults.inject(point, mode=mode):
        with pytest.raises(RuntimeError):
            saver.save(_state(2.0), step=2, blocking=True)
    assert saver.steps() == [1]
    step, state = saver.restore_latest_valid(return_numpy=True)
    assert step == 1
    np.testing.assert_array_equal(state["w"], _state(1.0)["w"])
    saver.save(_state(3.0), step=3, blocking=True)
    assert [n for n in os.listdir(saver.base_dir)
            if n.endswith(".tmp") or n.endswith(".old")] == []
    assert saver.steps() == [1, 3]


class _FakeRemoteFS(LocalFS):
    """LocalFS with the remote contract (HDFS without a hadoop install)."""

    def need_upload_download(self):
        return True


@pytest.mark.parametrize("point", ["checkpoint.upload",
                                   "checkpoint.upload_commit"])
def test_crash_matrix_remote_upload(tmp_path, point):
    saver = AsyncCheckpointSaver(str(tmp_path / "bucket"), keep_last=3,
                                 fs=_FakeRemoteFS())
    saver.save(_state(1.0), step=1, blocking=True)
    with faults.inject(point):
        with pytest.raises(RuntimeError):
            saver.save(_state(2.0), step=2, blocking=True)
    assert saver.steps() == [1]
    step, state = saver.restore_latest_valid(return_numpy=True)
    assert step == 1
    np.testing.assert_array_equal(state["w"], _state(1.0)["w"])


def test_remote_download_retries_then_surfaces(tmp_path):
    saver = AsyncCheckpointSaver(str(tmp_path / "bucket"), keep_last=3,
                                 fs=_FakeRemoteFS())
    saver.save(_state(1.0), step=1, blocking=True)
    with faults.inject("fs.download", times=None):
        with pytest.raises(FaultInjected):
            saver.restore(return_numpy=True)
    assert saver.restore_latest_valid(return_numpy=True)[0] == 1
    with faults.inject("fs.download", exc=OSError("blip"), times=1):
        state = saver.restore(return_numpy=True)
    np.testing.assert_array_equal(state["w"], _state(1.0)["w"])


def test_remote_upload_retries_transient_failure(tmp_path):
    saver = AsyncCheckpointSaver(str(tmp_path / "bucket"), keep_last=3,
                                 fs=_FakeRemoteFS())
    with faults.inject("fs.upload", exc=OSError("blip"), times=1):
        saver.save(_state(1.0), step=1, blocking=True)
    assert saver.steps() == [1]
    c = registry().get("paddle_tpu_checkpoint_retries_total")
    assert c is not None and c.value(labels={"fn": "fs.upload"}) >= 1
    # a remote checkpoint the JAX package wrote restores here too
    jsaver = jck.AsyncCheckpointSaver(str(tmp_path / "jbucket"),
                                      fs=_FakeRemoteFS())
    jsaver.save(_state(4.0), step=2, blocking=True)
    other = AsyncCheckpointSaver(str(tmp_path / "jbucket"),
                                 fs=_FakeRemoteFS())
    np.testing.assert_array_equal(
        other.restore(return_numpy=True)["w"], _state(4.0)["w"])


def test_corrupt_latest_falls_back_and_quarantines(tmp_path):
    saver = AsyncCheckpointSaver(str(tmp_path / "a"), keep_last=3)
    saver.save(_state(1.0), step=1, blocking=True)
    saver.save(_state(2.0), step=2, blocking=True)
    d2 = saver._step_dir(2)
    np.save(os.path.join(d2, _manifest(d2)["tensors"]["w"]["file"]),
            np.zeros(8, "float32"))
    step, state = saver.restore_latest_valid(return_numpy=True)
    assert step == 1
    np.testing.assert_array_equal(state["w"], _state(1.0)["w"])
    assert os.path.isdir(d2 + ".corrupt") and not os.path.exists(d2)
    evs = [e for e in flight.events("checkpoint")
           if e["name"] == "quarantine"]
    assert evs and evs[-1]["attrs"]["step"] == 2


def test_async_failure_is_loud_at_failure_time(tmp_path):
    saver = AsyncCheckpointSaver(str(tmp_path / "a"), keep_last=3)
    faults.arm("checkpoint.write")
    saver.save(_state(), step=1)
    saver._thread.join()
    faults.reset()
    evs = [e for e in flight.events("checkpoint")
           if e["name"] == "write_failed"]
    assert evs and evs[-1]["attrs"]["step"] == 1
    c = registry().get("paddle_tpu_checkpoint_failures_total")
    assert c.value(labels={"phase": "async_write"}) >= 1
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        saver.wait()


def test_prune_sweeps_crash_debris(tmp_path):
    base = tmp_path / "a"
    saver = AsyncCheckpointSaver(str(base), keep_last=2)
    os.makedirs(base / "step_9.tmp")
    os.makedirs(base / "step_4.old")
    os.makedirs(base / "step_3")
    (base / "step_3" / "manifest.json").write_text("{}")
    saver.save(_state(), step=5, blocking=True)
    names = sorted(os.listdir(base))
    assert names == ["step_5"]


def test_train_step_state_roundtrip_bit_identical_no_rebuild(tmp_path):
    saver = AsyncCheckpointSaver(str(tmp_path / "ck"))
    paddle.seed(0)
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.ReLU(),
                              torch.nn.Linear(8, 2))
    step = make_train_step(net, paddle.optimizer.Adam(
        learning_rate=1e-2, parameters=net), loss_fn=torch.nn.MSELoss())
    rs = np.random.RandomState(0)
    data = [(torch.from_numpy(rs.randn(4, 4).astype("f4")),
             torch.from_numpy(rs.randn(4, 2).astype("f4")))
            for _ in range(6)]
    for x, y in data[:3]:
        step(x, y)
    saver.save(step.state_dict(), step=3)
    tail_a = [float(step(x, y)) for x, y in data[3:]]     # in place
    saver.wait()
    _, snap = saver.restore_latest_valid(return_numpy=True)
    step.load_state_dict(snap)
    assert step.optimizer._step_count == 3
    assert [float(step(x, y)) for x, y in data[3:]] == tail_a
    assert step.compile_count == 1 and len(step._jitted._signatures) == 1


# -- faults, retries, preemption ---------------------------------------------

def test_fault_point_modes(tmp_path):
    faults.fault_point("nothing.armed")
    with faults.inject("p.raise"):
        with pytest.raises(FaultInjected):
            faults.fault_point("p.raise")
        faults.fault_point("p.raise")
    with faults.inject("p.after", after=2):
        faults.fault_point("p.after")
        faults.fault_point("p.after")
        with pytest.raises(FaultInjected):
            faults.fault_point("p.after")
    assert faults.hits("p.after") == 3
    f = tmp_path / "x.bin"
    f.write_bytes(b"0123456789")
    with faults.inject("p.torn", mode="torn"):
        with pytest.raises(FaultInjected):
            faults.fault_point("p.torn", path=str(f))
    assert f.read_bytes() == b"01234"
    mine, other = object(), object()
    with faults.inject("p.match", match={"owner": mine}):
        faults.fault_point("p.match", owner=other)      # not counted
        with pytest.raises(FaultInjected):
            faults.fault_point("p.match", owner=mine)


def test_fault_env_spec_and_kill():
    faults._load_env("a.b:raise:times=2,c.d:delay:seconds=0.5")
    for _ in range(2):
        with pytest.raises(FaultInjected):
            faults.fault_point("a.b")
    faults.fault_point("a.b")
    faults.reset()
    code = ("from paddle_tpu_torch.testing import faults\n"
            "for i in range(5): faults.fault_point('train.step')\n")
    env = dict(os.environ, PADDLE_TPU_FAULTS="train.step:kill:after=2")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, timeout=120,
                       cwd=os.path.dirname(os.path.dirname(
                           os.path.abspath(__file__))))
    assert r.returncode == 43


def test_retry_recovers_and_counts():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    assert retry_call(flaky, name="unit.flaky", tries=4, base_delay=0.001,
                      counter="paddle_tpu_checkpoint_retries_total") == "ok"
    c = registry().get("paddle_tpu_checkpoint_retries_total")
    assert c.value(labels={"fn": "unit.flaky"}) >= 2
    assert any(e["name"] == "unit.flaky" for e in flight.events("retry"))
    with pytest.raises(OSError, match="always"):
        retry_call(lambda: (_ for _ in ()).throw(OSError("always")),
                   name="unit.always", tries=2, base_delay=0.001)


def test_preemption_signal_chain():
    """The first SIGTERM sets the request (the process survives); the
    handlers are restored after."""
    prev = signal.getsignal(signal.SIGTERM)
    assert preemption.install()
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        for _ in range(200):
            if preemption.requested():
                break
            time.sleep(0.005)
        assert preemption.requested()
        preemption.mark_saved(7, topology={"dp": 1})
        assert preemption.last_saved_step() == 7
    finally:
        preemption.uninstall()
    assert signal.getsignal(signal.SIGTERM) is prev
    with preemption.guard():
        assert preemption.installed()
    assert not preemption.installed()
    evs = [e["name"] for e in flight.events("preemption")]
    assert evs[:2] == ["requested", "emergency_checkpoint"]


# -- auto-checkpoint, fs clients, paddle.save ----------------------------------

def test_train_epoch_range_resume(tmp_path):
    d = str(tmp_path / "acp")

    def net_fn():
        return nn.Sequential(nn.Linear(4, 2))

    def opt_fn(net):
        return paddle.optimizer.Adam(learning_rate=0.1,
                                     parameters=net.parameters())

    net = net_fn()
    opt = opt_fn(net)
    r = TrainEpochRange(3, name="job1", checkpoint_dir=d)
    r.register(net, "model").register(opt, "opt")
    for epoch in r:
        loss = (net(paddle.to_tensor(np.ones((2, 4), "float32"))) ** 2).sum()
        loss.backward()
        opt.step()
        opt.clear_grad()
    w = net.state_dict()["0.weight"].numpy().copy()
    r2 = TrainEpochRange(5, name="job1", checkpoint_dir=d)
    net2 = net_fn()
    r2.register(net2, "model")
    assert r2.start_epoch == 3
    np.testing.assert_array_equal(net2.state_dict()["0.weight"].numpy(), w)
    assert list(r2) == [3, 4]
    # the JAX package's range resumes from the port's checkpoints
    jr = JaxRange(6, name="job1", checkpoint_dir=d)
    assert jr.start_epoch == 5


def test_local_fs_client_and_hdfs_without_hadoop(tmp_path):
    fs = LocalFS()
    root = str(tmp_path / "fsroot")
    fs.mkdirs(root + "/a/b")
    fs.touch(root + "/a/f.txt")
    assert fs.ls_dir(root + "/a") == (["b"], ["f.txt"])
    assert fs.is_dir(root + "/a/b") and fs.is_file(root + "/a/f.txt")
    assert not fs.need_upload_download()
    fs.mv(root + "/a/f.txt", root + "/a/g.txt")
    assert fs.is_exist(root + "/a/g.txt")
    fs.delete(root + "/a")
    assert not fs.is_exist(root + "/a")
    with pytest.raises(Exception, match="hadoop|HADOOP"):
        HDFSClient(hadoop_home=str(tmp_path / "no_hadoop"),
                   configs={}).ls_dir("/x")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_paddle_save_load_cross_reads(tmp_path, writer):
    path = str(tmp_path / "m.pdparams")
    arrays = {"w": np.arange(6, dtype="f4").reshape(2, 3),
              "b": np.ones(3, "f4")}
    if writer == "jax":
        jio.save({k: jpaddle.to_tensor(v) for k, v in arrays.items()}
                 | {"raw": np.arange(2), "epoch": 3}, path)
    else:
        paddle.save({k: paddle.to_tensor(v) for k, v in arrays.items()}
                    | {"raw": np.arange(2), "epoch": 3}, path)
    port = paddle.load(path)
    assert isinstance(port["w"], paddle.Tensor) and port["epoch"] == 3
    np.testing.assert_array_equal(port["w"].numpy(), arrays["w"])
    jax = jio.load(path)
    assert isinstance(jax["b"], jpaddle.Tensor)
    np.testing.assert_array_equal(jax["b"].numpy(), arrays["b"])
    raw = paddle.load(path, return_numpy=True)
    np.testing.assert_array_equal(raw["raw"], [0, 1])
