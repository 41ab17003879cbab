"""The port's hapi (``paddle.Model``, callbacks, metrics, summary)
against the JAX package's.

Both packages' networks start from the same weights (numpy state carried
from the JAX net), shuffle from the same ``np.random`` seeds and train
f32 with dropout 0: ``fit`` / ``evaluate`` / ``predict`` losses and
metrics agree within 1e-5 relative (the JAX side at "highest" matmul
precision, ``tests/conftest.py``).  Callbacks act alike (the epoch early
stopping ends at, the rate after a plateau, the scheduler's steps,
VisualDL's scalars).  ``Accuracy`` ranks tied scores as ``lax.top_k``
does (the lower index first).  A preempted ``fit`` resumed with
``resume="auto"`` repeats the port's own uninterrupted run bit for bit,
dropout included (the port's generators ride the checkpoint), and stays
within 1e-5 of the JAX package's series with dropout 0.
"""
import json
import os
import signal

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import paddle_tpu as jpaddle
import paddle_tpu.nn as jnn
from paddle_tpu.framework import preemption as jpreemption
from paddle_tpu.hapi import Model as JaxModel
from paddle_tpu.hapi import callbacks as jcb
from paddle_tpu.hapi.model import DeviceLossList as JaxLossList
from paddle_tpu.metric import Accuracy as JaxAccuracy
from paddle_tpu.metric import accuracy as jax_accuracy

import paddle_tpu_torch as paddle
from paddle_tpu_torch import metric, nn
from paddle_tpu_torch.framework import preemption
from paddle_tpu_torch.framework.checkpoint import ElasticResumeError
from paddle_tpu_torch.hapi import DeviceLossList, Model
from paddle_tpu_torch.hapi import callbacks as cb
from paddle_tpu_torch.testing import FaultInjected, faults

from _torch_cpu_place import cpu_place  # noqa: F401

RTOL = 1e-5


@pytest.fixture(autouse=True)
def _clean():
    for p in (preemption, jpreemption):
        p.clear()
    faults.reset()
    yield
    for p in (preemption, jpreemption):
        p.clear()
        p.uninstall()
    faults.reset()


class Rows:
    """Seeded (x, label) rows: x [6] f32, label in [0, 3)."""

    def __init__(self, n=24, seed=0):
        self.n, self.seed = n, seed

    def __getitem__(self, i):
        rs = np.random.RandomState(self.seed + i)
        return rs.randn(6).astype(np.float32), np.int64(rs.randint(0, 3))

    def __len__(self):
        return self.n


def _data(pkg, **kw):
    return type("Rows", (Rows, pkg.io.Dataset), {})(**kw)


def _pair(dropout=0.0, lr=1e-2, metrics=None, sched=None):
    """A JAX Model and a port Model over the same weights."""
    jpaddle.seed(0)
    jnet = jnn.Sequential(jnn.Linear(6, 16), jnn.ReLU(),
                          jnn.Dropout(dropout), jnn.Linear(16, 3))
    paddle.seed(0)
    net = nn.Sequential(nn.Linear(6, 16), nn.ReLU(), nn.Dropout(dropout),
                        nn.Linear(16, 3))
    net.set_state_dict({k: v.numpy() for k, v in jnet.state_dict().items()})
    out = []
    for pkg, mod, n, M in ((jpaddle, jnn, jnet, JaxModel),
                           (paddle, nn, net, Model)):
        lr_ = sched(pkg) if sched else lr
        m = M(n)
        m.prepare(optimizer=pkg.optimizer.Adam(
            learning_rate=lr_, parameters=n.parameters()),
            loss=mod.CrossEntropyLoss(),
            metrics=metrics(pkg) if metrics else None)
        out.append(m)
    return out


def _recorder(base):
    class Rec(base):
        def __init__(self):
            super().__init__()
            self.losses = []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(float(np.ravel(np.asarray(logs["loss"]))[0]))

    return Rec()


def _close(a, b, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=rtol,
                               atol=1e-7)


# -- fit / evaluate / predict --------------------------------------------------

@pytest.mark.parametrize("workers,prefetch", [(0, False), (2, True)],
                         ids=["plain", "workers-prefetch"])
def test_fit_evaluate_predict_equal_jax(workers, prefetch):
    jm, tm = _pair(metrics=lambda pkg: pkg.metric.Accuracy(topk=(1, 2)))
    series = []
    for pkg, m, callbacks in ((jpaddle, jm, jcb), (paddle, tm, cb)):
        rec = _recorder(callbacks.Callback)
        np.random.seed(5)
        m.fit(_data(pkg), epochs=2, batch_size=4, verbose=0, shuffle=True,
              callbacks=[rec], num_workers=workers, prefetch=prefetch)
        res = m.evaluate(_data(pkg, n=12, seed=50), batch_size=4, verbose=0)
        pred = m.predict(_data(pkg, n=10, seed=70), batch_size=4,
                         stack_outputs=True)
        series.append((rec.losses, res, pred))
    (jl, jres, jpred), (tl, tres, tpred) = series
    assert len(tl) == len(jl) == 12
    _close(tl, jl)
    assert sorted(tres) == sorted(jres)
    _close(tres["loss"], jres["loss"])
    _close(tres["acc_top1"], jres["acc_top1"])
    assert tpred[0].shape == jpred[0].shape == (10, 3)
    _close(tpred[0], jpred[0])


def test_train_eval_predict_batch_and_lazy_losses(tmp_path):
    jm, tm = _pair(metrics=lambda pkg: pkg.metric.Accuracy())
    x = np.random.RandomState(0).randn(8, 6).astype("f4")
    y = np.random.RandomState(1).randint(0, 3, (8,)).astype("int64")
    outs = []
    for m in (jm, tm):
        res = [m.train_batch([x], [y]) for _ in range(5)]
        losses, accs = zip(*res)
        assert not losses[-1].fetched
        outs.append(([float(l) for l in losses], list(accs),
                     m.eval_batch([x], [y]), m.predict_batch([x])[0]))
    (jl, ja, je, jp), (tl, ta, te, tp) = outs
    _close(tl, jl)
    assert tl[-1] < tl[0]
    _close(ta, ja)
    _close(float(te[0]), float(je[0]))
    _close(tp, jp)
    # save / load round trip, and across the packages
    path = str(tmp_path / "ck" / "model")
    tm.save(path)
    assert os.path.exists(path + ".pdparams") and \
        os.path.exists(path + ".pdopt")
    jm2, tm2 = _pair()
    tm2.load(path)
    jm2.load(path)
    for k, v in tm.network.state_dict().items():
        np.testing.assert_array_equal(tm2.network.state_dict()[k].numpy(),
                                      v.numpy())
        np.testing.assert_array_equal(jm2.network.state_dict()[k].numpy(),
                                      v.numpy())
    assert tm2._optimizer._step_count == tm._optimizer._step_count


def test_device_loss_list_is_lazy_and_list_like():
    dl = DeviceLossList([torch.tensor(1.5), torch.tensor([2.5, 9.0])])
    assert not dl.fetched and len(dl) == 2 and bool(dl)
    assert not dl.fetched
    assert dl[0] == 1.5 and dl.fetched
    assert float(dl) == 1.5 and list(dl) == [1.5, 2.5]
    np.testing.assert_allclose(np.asarray(dl), [1.5, 2.5])
    j = JaxLossList([np.float32(1.5), np.array([2.5, 9.0], "f4")])
    assert list(j) == list(dl)
    assert list(DeviceLossList([])) == []
    # one copy for the whole list: the stacked firsts cross once
    calls = []
    real = torch.Tensor.cpu

    def counting(self, *a, **k):
        calls.append(1)
        return real(self, *a, **k)

    torch.Tensor.cpu = counting
    try:
        lazy = DeviceLossList([torch.tensor(float(i)) for i in range(20)])
        assert list(lazy) == [float(i) for i in range(20)]
    finally:
        torch.Tensor.cpu = real
    assert len(calls) == 1


# -- callbacks -------------------------------------------------------------

def test_early_stopping_equal_jax():
    stops = []
    for pkg, m, callbacks in zip((jpaddle, paddle), _pair(lr=0.5),
                                 (jcb, cb)):
        es = callbacks.EarlyStopping(monitor="loss", patience=1, verbose=0,
                                     save_best_model=True)
        np.random.seed(1)
        m.fit(_data(pkg), eval_data=_data(pkg, n=8, seed=30), epochs=10,
              batch_size=4, verbose=0, callbacks=[es])
        stops.append((es.stopped_epoch, es.wait_epoch, m.stop_training,
                      float(es.best_value)))
    assert stops[0][:3] == stops[1][:3]
    _close(stops[1][3], stops[0][3])


def test_reduce_lr_on_plateau_equal_jax():
    lrs = []
    for m, callbacks in zip(_pair(lr=0.1), (jcb, cb)):
        r = callbacks.ReduceLROnPlateau(monitor="loss", factor=0.5,
                                        patience=1, cooldown=1, verbose=0)
        r.set_model(m)
        seen = []
        for v in (1.0, 2.0, 2.0, 3.0, 0.5, 4.0, 4.0):
            r.on_eval_end({"loss": [v]})
            seen.append(m._optimizer.get_lr())
        lrs.append(seen)
    assert lrs[0] == lrs[1]
    assert lrs[1][-1] < 0.1


def test_lr_scheduler_steps_equal_jax():
    got = []
    for pkg, m in zip((jpaddle, paddle), _pair(
            sched=lambda pkg: pkg.optimizer.lr.StepDecay(
                learning_rate=0.1, step_size=2, gamma=0.5))):
        np.random.seed(0)
        m.fit(_data(pkg, n=12), epochs=2, batch_size=4, verbose=0)
        got.append((m._optimizer.get_lr(), m._optimizer._lr.last_epoch))
    assert got[0] == got[1] and got[1][0] < 0.1


def test_visualdl_scalars_equal_jax(tmp_path):
    logs = []
    for pkg, m, callbacks in zip((jpaddle, paddle), _pair(), (jcb, cb)):
        d = str(tmp_path / pkg.__name__)
        np.random.seed(2)
        m.fit(_data(pkg, n=8), eval_data=_data(pkg, n=4, seed=9), epochs=2,
              batch_size=4, verbose=0, callbacks=[callbacks.VisualDL(d)])
        with open(os.path.join(d, "scalars.jsonl")) as fh:
            logs.append([json.loads(line) for line in fh])
    (j, t) = logs
    assert [(r["tag"], r["step"]) for r in t] == \
        [(r["tag"], r["step"]) for r in j]
    _close([r["value"] for r in t], [r["value"] for r in j])


def test_model_checkpoint_and_callback_order(tmp_path):
    events = []

    class Recorder(cb.Callback):
        def on_train_begin(self, logs=None):
            events.append("train_begin")

        def on_epoch_begin(self, epoch, logs=None):
            events.append(f"epoch_{epoch}")

        def on_train_end(self, logs=None):
            events.append("train_end")

    _, m = _pair()
    m.fit(_data(paddle, n=8), epochs=2, batch_size=4, verbose=0,
          save_dir=str(tmp_path), save_freq=1, callbacks=[Recorder()])
    assert events == ["train_begin", "epoch_0", "epoch_1", "train_end"]
    for name in ("0", "final"):
        assert os.path.exists(str(tmp_path / f"{name}.pdparams"))


def test_progbar_logger_reads_losses_at_log_points(monkeypatch):
    import io

    from paddle_tpu_torch.hapi import progressbar

    buf = io.StringIO()
    bar = progressbar.ProgressBar(num=2, verbose=2, file=buf)
    bar.update(1, [("loss", 0.5)])
    assert buf.getvalue().startswith("step 1/2 - loss: 0.5000")
    seen = []
    monkeypatch.setattr(progressbar.ProgressBar, "update",
                        lambda self, n, values=None: seen.append((n, values)))
    _, m = _pair()
    m.fit(_data(paddle, n=16), epochs=1, batch_size=4, verbose=2, log_freq=2)
    assert [n for n, _ in seen] == [2, 4, 4]
    assert all(v[0][0] == "loss" and isinstance(v[0][1], float)
               for _, v in seen)


# -- metrics -------------------------------------------------------------------

def test_accuracy_top_k_with_ties_equal_jax():
    pred = np.array([[0.5, 0.5, 0.2, 0.5], [0.1, 0.3, 0.3, 0.3],
                     [0.0, 0.0, 0.0, 0.0], [0.9, 0.1, 0.9, 0.4]], "f4")
    label = np.array([[3], [2], [1], [2]], "int64")
    got, want = metric.Accuracy(topk=(1, 2, 3)), JaxAccuracy(topk=(1, 2, 3))
    gc = got.compute(paddle.to_tensor(pred), paddle.to_tensor(label))
    wc = want.compute(jpaddle.to_tensor(pred), jpaddle.to_tensor(label))
    np.testing.assert_array_equal(gc.numpy(), wc.numpy())
    assert got.update(gc) == want.update(wc)
    assert got.accumulate() == want.accumulate()
    assert got.name() == want.name()
    for k in (1, 2, 3):
        assert float(metric.accuracy(paddle.to_tensor(pred),
                                     paddle.to_tensor(label), k=k)) == \
            float(jax_accuracy(jpaddle.to_tensor(pred),
                               jpaddle.to_tensor(label), k=k))
    # the rule itself: the lower index first among equal scores
    idx = metric.top_k_indices(torch.tensor([[1.0, 3.0, 3.0, 1.0, 3.0]]), 4)
    assert idx.tolist() == [[1, 2, 4, 0]]


def test_precision_recall_auc_equal_jax():
    rs = np.random.RandomState(0)
    preds = rs.rand(40).astype("f4")
    labels = rs.randint(0, 2, 40).astype("int64")
    for name in ("Precision", "Recall", "Auc"):
        g, w = getattr(metric, name)(), getattr(jpaddle.metric, name)()
        for i in range(0, 40, 10):
            g.update(paddle.to_tensor(preds[i:i + 10]),
                     paddle.to_tensor(labels[i:i + 10]))
            w.update(jpaddle.to_tensor(preds[i:i + 10]),
                     jpaddle.to_tensor(labels[i:i + 10]))
        assert g.accumulate() == pytest.approx(w.accumulate(), rel=1e-12)
        assert g.name() == w.name()


def test_summary_counts_equal_jax(capsys):
    jm, tm = _pair()
    got = paddle.summary(tm.network, (2, 6))
    want = jpaddle.summary(jm.network, (2, 6))
    assert got == want == {"total_params": 6 * 16 + 16 + 16 * 3 + 3,
                           "trainable_params": 6 * 16 + 16 + 16 * 3 + 3}
    assert tm.summary((2, 6)) == got
    assert "Linear" in capsys.readouterr().out


# -- preemption and resume -----------------------------------------------------

class _SigtermAt:
    def __new__(cls, base, at):
        class S(base):
            def __init__(self):
                super().__init__()
                self.n = 0

            def on_train_batch_end(self, step, logs=None):
                self.n += 1
                if self.n == at:
                    os.kill(os.getpid(), signal.SIGTERM)
        return S()


def _preempt_resume(pkg, pair_idx, callbacks, tmp_path, dropout, **fit):
    def model():
        return _pair(dropout=dropout)[pair_idx]

    def run(ckdir, extra=(), resume=None, seed=11):
        rec = _recorder(callbacks.Callback)
        ck = callbacks.CheckpointCallback(str(ckdir), every_n_steps=2,
                                          data_seed=seed)
        (paddle if pkg is paddle else jpaddle).seed(3)
        model().fit(_data(pkg), epochs=2, batch_size=4, verbose=0,
                    shuffle=True, callbacks=[rec, *extra, ck],
                    resume=resume, **fit)
        return rec.losses, ck

    a, _ = run(tmp_path / f"{pkg.__name__}_ref")
    b, ck_b = run(tmp_path / f"{pkg.__name__}_ck",
                  extra=[_SigtermAt(callbacks.Callback, 7)])
    assert ck_b.preempted and len(b) == 7
    (preemption if pkg is paddle else jpreemption).clear()
    c, ck_c = run(tmp_path / f"{pkg.__name__}_ck", resume="auto", seed=0)
    assert ck_c.data_seed == 11 and len(c) == 5
    return a, b, c


@pytest.mark.parametrize("workers,prefetch", [(0, False), (2, True)],
                         ids=["plain", "workers-prefetch"])
def test_preempt_then_resume_auto_bit_identical(tmp_path, workers,
                                                prefetch):
    """A real SIGTERM at global step 7: the emergency checkpoint, then a
    fresh model with ``resume="auto"``; dropout 0.3 rides the port's
    generators in the checkpoint."""
    a, b, c = _preempt_resume(paddle, 1, cb, tmp_path, 0.3,
                              num_workers=workers, prefetch=prefetch)
    assert len(a) == 12
    assert b + c == a


def test_preempted_series_within_jax(tmp_path):
    ja, jb, jc = _preempt_resume(jpaddle, 0, jcb, tmp_path, 0.0)
    ta, tb, tc = _preempt_resume(paddle, 1, cb, tmp_path, 0.0)
    assert tb + tc == ta and jb + jc == ja
    _close(tb + tc, jb + jc)


def test_resume_from_epoch_checkpoint_and_missing_dir(tmp_path):
    _, m = _pair()
    rec_a = _recorder(cb.Callback)
    np.random.seed(0)
    m.fit(_data(paddle), epochs=2, batch_size=4, verbose=0, shuffle=False,
          callbacks=[rec_a])
    ck = str(tmp_path / "ck")
    _, m = _pair()
    m.fit(_data(paddle), epochs=1, batch_size=4, verbose=0, shuffle=False,
          callbacks=[cb.CheckpointCallback(ck)])
    rec_c = _recorder(cb.Callback)
    _, m = _pair()
    m.fit(_data(paddle), epochs=2, batch_size=4, verbose=0, shuffle=False,
          resume="auto", callbacks=[rec_c, cb.CheckpointCallback(ck)])
    assert rec_c.losses == rec_a.losses[6:]
    with pytest.raises(ValueError, match="CheckpointCallback"):
        m.fit(_data(paddle), epochs=1, batch_size=4, verbose=0,
              resume="auto")
    with pytest.raises(FileNotFoundError):
        m.fit(_data(paddle), epochs=1, batch_size=4, verbose=0,
              resume=str(tmp_path / "nowhere"))


def test_train_step_seam_crash_leaves_periodic_checkpoint(tmp_path):
    c = cb.CheckpointCallback(str(tmp_path / "ck"), every_n_steps=2)
    _, m = _pair()
    with faults.inject("train.step", after=3):
        with pytest.raises(FaultInjected):
            m.fit(_data(paddle), epochs=2, batch_size=4, verbose=0,
                  shuffle=False, callbacks=[c])
    assert faults.hits("train.step") == 4
    c.saver.wait()
    assert c.saver.steps() == [2]
    step, state = c.saver.restore_latest_valid(return_numpy=True)
    assert step == 2 and state["train"]["rng"]


def test_world_size_aware_resume(tmp_path, monkeypatch):
    """``dp_world_size`` comes from the launcher's environment; a resume
    recomputes the skip in the new global batch, and an offset the new
    batch cannot reach raises."""
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    ck_dir = str(tmp_path / "ck")
    c = cb.CheckpointCallback(ck_dir, every_n_steps=3)
    assert c.dp_world_size == 2
    _, m = _pair()
    with faults.inject("train.step", after=3):
        with pytest.raises(FaultInjected):
            m.fit(_data(paddle), epochs=1, batch_size=4, verbose=0,
                  callbacks=[c])
    c.saver.wait()
    train = c.saver.restore(return_numpy=True)["train"]
    assert int(train["samples_in_epoch"]) == 3 * 4 * 2
    assert int(train["global_batch_size"]) == 8
    # a new topology: batch 6 x 4 replicas = 24 = the offset: step 1
    _, m = _pair()
    c2 = cb.CheckpointCallback(ck_dir, dp_world_size=4)
    c2.set_model(m)
    c2.set_params({})
    assert m._restore_for_resume("auto", c2, per_rank_bs=6) == (0, 1)
    with pytest.raises(ElasticResumeError):
        m._restore_for_resume("auto", c2, per_rank_bs=5)
