"""The port's serving engine against the JAX package's, on gpt-tiny.

The JAX side is ``Engine(paged_kv=True, page_size=8,
decode_kernel="pallas")`` (its decode kernel in Pallas interpret mode on the
CPU); the port's ``Engine(paged_kv=True, decode_kernel="pallas")`` on a CPU
model runs the plain versions of its kernels. Greedy tokens must be
identical, f32 and int8 pools alike.

Sampling is distributional by decision: the port draws with a
per-request ``torch.Generator`` seeded from ``seed``, the JAX engine with
threefry ``fold_in`` keys, so sampled tokens are not compared across the
packages — only reproducibility within the port, and that every draw
lies in the top-k of the plain forward's logits.
"""
import threading
import time

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

import paddle_tpu as paddle
from paddle_tpu.models import build_gpt as jax_build_gpt
from paddle_tpu.models import gpt_config as jax_gpt_config
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu.serving import engine as jax_engine_mod
from paddle_tpu.serving import kv_quant as jax_kv_quant

from paddle_tpu_torch.models import build_gpt, load_jax_state
from paddle_tpu_torch.serving import (Engine, EngineClosedError,
                                      PageAllocator, QueueFullError,
                                      SlotPool)
from paddle_tpu_torch.serving import engine as engine_mod
from paddle_tpu_torch.serving import kv_quant

# gpt-tiny shapes gain nothing from intra-op threads; one thread keeps
# these tests from crowding the timing-sensitive tests of other workers
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    cfg = jax_gpt_config("gpt-tiny", max_position_embeddings=128,
                         hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    paddle.seed(7)
    jm = jax_build_gpt(cfg)
    jm.eval()
    pm = build_gpt("gpt-tiny", device="cpu", max_position_embeddings=128)
    load_jax_state(pm, {k: np.asarray(v._value)
                        for k, v in jm.state_dict().items()})
    return jm, pm


def _prompts(n=5, seed=11):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 1024, ln).astype(np.int64)
            for ln in (3, 7, 17, 2, 11)[:n]]


def _serve(engine, prompts, new=6, **kw):
    try:
        handles = [engine.submit(p, max_new_tokens=new, **kw)
                   for p in prompts]
        out = [h.result(timeout=120) for h in handles]
        return out, engine.stats()
    finally:
        engine.shutdown()


@pytest.mark.parametrize("kv_dtype,slots", [(None, 2), ("int8", 3),
                                             (None, 4)],
                         ids=["f32-2slots", "int8-3slots", "f32-4slots"])
def test_greedy_tokens_match_jax_engine(models, kv_dtype, slots):
    jm, pm = models
    prompts = _prompts()
    # every prompt is submitted before the engine thread admits any: the
    # default queue (2 * max_slots) is 4 at two slots, so size it to hold
    # them all on both engines
    kw = dict(max_slots=slots, max_len=64, paged_kv=True, page_size=8,
              kv_dtype=kv_dtype, max_queue=len(prompts))
    want, _ = _serve(JaxEngine(jm, decode_kernel="pallas", **kw), prompts)
    got, st = _serve(Engine(pm, decode_kernel="pallas",
                            sample_on_device=False, **kw), prompts)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert st["completed"] == len(prompts)
    assert st["slot_reuses"] > 0 and st["slot_allocs"] == len(prompts)
    assert st["kv_pages_used"] == 0 and st["active_slots"] == 0


def test_quantize_rows_matches_jax():
    x = np.random.RandomState(0).randn(5, 7, 2, 8).astype(np.float32)
    x[0, 0] = 0.0                                    # all-zero row: eps
    x[1, 1, 0, 0] = 2.5 * np.abs(x[1, 1]).max()      # exact .5 ties
    jq, js = (np.asarray(a) for a in jax_kv_quant.quantize_rows(
        jnp.asarray(x)))
    q, s = kv_quant.quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), jq)
    np.testing.assert_array_equal(s.numpy(), js)
    np.testing.assert_array_equal(
        kv_quant.dequantize_pool(q, s).numpy(),
        np.asarray(jax_kv_quant.dequantize_pool(jnp.asarray(jq),
                                                jnp.asarray(js),
                                                jnp.float32)))


def test_bucket_and_pools_match_jax():
    for n, lo, hi in [(1, 8, 64), (9, 8, 64), (100, 8, 64), (17, 1, 640)]:
        assert engine_mod._bucket(n, lo, hi) == jax_engine_mod._bucket(
            n, lo, hi)
    pa = PageAllocator(4, 8)
    assert pa.alloc(5) is None and pa.alloc(3) == [0, 1, 2]
    assert pa.share(1) == 2 and not pa.deref(1) and pa.deref(1)
    with pytest.raises(KeyError):
        pa.deref(1)
    pool = SlotPool(2)
    a, b = pool.alloc("a"), pool.alloc("b")
    assert pool.alloc("c") is None
    pool.free(a)
    assert pool.alloc("c") == a and pool.reuse_total == 1


def test_sampling_is_reproducible_and_in_top_k(models):
    _, pm = models
    prompts = _prompts(3)
    kw = dict(max_slots=2, max_len=64, page_size=8, paged_kv=True,
              decode_kernel="pallas", sample_on_device=False)
    one, _ = _serve(Engine(pm, **kw), prompts, new=5, temperature=0.8,
                    top_k=4, seed=3)
    two, _ = _serve(Engine(pm, **kw), prompts, new=5, temperature=0.8,
                    top_k=4, seed=3)
    greedy, _ = _serve(Engine(pm, **kw), prompts, new=5)
    top1, _ = _serve(Engine(pm, **kw), prompts, new=5, temperature=1.0,
                     top_k=1, seed=9)
    for p, a, b, g, t in zip(prompts, one, two, greedy, top1):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(t, g)        # top-1 is greedy
        seq = np.concatenate([p, a])
        with torch.no_grad():
            logits = pm(torch.from_numpy(seq[None, :-1]))[0].numpy()
        for j, tok in enumerate(a):
            row = logits[len(p) - 1 + j]
            assert tok in np.argsort(row)[-4:]


def test_unported_flags_raise(models):
    """The flags this test once saw refused (the dense pool,
    ``decode_kernel="xla"``, the device sampler) are ported: a bad value
    or combination of any flag raises the JAX engine's ``ValueError``,
    word for word."""
    jm, pm = models
    bad = [dict(decode_kernel="pallas"),          # the kernel needs pages
           dict(page_size=8), dict(num_pages=4), dict(max_pages_per_slot=2),
           dict(paged_kv=True, page_size=0),
           dict(paged_kv=True, max_pages_per_slot=0),
           dict(decode_kernel="cuda"), dict(kv_dtype="fp8"),
           dict(speculative_k=-1), dict(weight_dtype="int4"),
           dict(prefix_cache=True, host_prefix_mb=1.0, host_prefix=object()),
           dict(host_prefix_mb=1.0), dict(paged_kv=True, host_prefix_mb=1.0),
           dict(max_len=1024), dict(max_slots=0)]
    for case in bad:
        kw = dict(dict(max_slots=2, max_len=32), **case)
        with pytest.raises(ValueError) as want:
            JaxEngine(jm, **kw)
        with pytest.raises(ValueError) as got:
            Engine(pm, **kw)
        assert str(got.value) == str(want.value), case
    plain = Engine(pm, max_slots=2, max_len=32, auto_start=False)
    with pytest.raises(ValueError, match="no adapter registry"):
        plain.submit(np.arange(1, 5), adapter="tenant-a")
    plain.shutdown()


def test_admission_limits_queue_and_shutdown(models):
    _, pm = models
    eng = Engine(pm, paged_kv=True, decode_kernel="pallas",
                 sample_on_device=False, max_slots=1, max_len=32, page_size=8,
                 max_queue=2, auto_start=False)
    with pytest.raises(ValueError, match="exceeds the paged limit"):
        eng.submit(np.arange(30), max_new_tokens=5)
    h1 = eng.submit(np.arange(4), max_new_tokens=3)
    h2 = eng.submit(np.arange(5), max_new_tokens=3)
    with pytest.raises(QueueFullError):
        eng.submit(np.arange(6), max_new_tokens=3)
    assert h2.cancel() and h2.done()
    eng.start()
    assert len(h1.result(timeout=60)) == 3
    streamed = []
    h3 = eng.submit(np.arange(3), max_new_tokens=25, stream=streamed.append)
    eng.shutdown()
    assert h3.done() and streamed == h3.tokens
    if len(streamed) < 25:                 # still in flight at shutdown
        assert isinstance(h3.exception(), EngineClosedError)
    st = eng.stats()
    assert st["cancelled"] == 1 and st["rejected"] == 1
    assert st["kv_pages_used"] == 0
    with pytest.raises(EngineClosedError):
        eng.submit(np.arange(3))


def test_page_exhaustion_is_backpressure(models):
    """Three requests that each reserve 3 of 4 pages run one at a time
    through two lanes: the head waits for pages, nobody fails."""
    _, pm = models
    eng = Engine(pm, paged_kv=True, decode_kernel="pallas",
                 sample_on_device=False, max_slots=2, max_len=32, page_size=8,
                 num_pages=4)
    out, st = _serve(eng, _prompts(3), new=10)
    assert [len(o) for o in out] == [10, 10, 10]
    assert st["page_alloc_stalls"] >= 1 and st["completed"] == 3


def test_background_submitter_and_deadline(models):
    _, pm = models
    eng = Engine(pm, paged_kv=True, decode_kernel="pallas",
                 sample_on_device=False, max_slots=2, max_len=64, page_size=8,
                 max_queue=16)
    handles = []

    def feed():
        for p in _prompts():
            handles.append(eng.submit(p, max_new_tokens=4))
            time.sleep(0.001)

    try:
        th = threading.Thread(target=feed)
        th.start()
        th.join(timeout=30)
        assert not th.is_alive()
        late = eng.submit(np.arange(5), max_new_tokens=40, deadline_s=0.0)
        assert all(len(h.result(timeout=60)) == 4 for h in handles)
        assert len(handles) == 5
        assert isinstance(late.exception(timeout=60),
                          engine_mod.DeadlineExceededError)
    finally:
        eng.shutdown()
