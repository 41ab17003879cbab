"""Multi-LoRA adapters and int8 base weights on the port's serving engine.

The port's mirror of ``tests/test_multi_lora.py`` (all but the gateway
routing and the metrics/flight test, which belong to the observability and
gateway module), on the port's ``Engine(paged_kv=True,
decode_kernel="pallas")`` on a CPU model with gpt-tiny weights loaded from
the JAX model; then the port against the JAX package on the same weights,
factors and prompts: the JAX side is ``Engine(paged_kv=True, page_size=8,
decode_kernel="pallas")`` (its kernel in Pallas interpret mode). Greedy
tokens must be identical throughout; ``quantize_state`` must give the JAX
package's int8 values and scales exactly.
"""
import copy
import time

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

import paddle_tpu as paddle
from paddle_tpu.models import build_gpt as jax_build_gpt
from paddle_tpu.models import gpt_config as jax_gpt_config
from paddle_tpu.nn.functional_call import state_values
from paddle_tpu.serving import AdapterRegistry as JaxRegistry
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu.serving import make_lora as jax_make_lora
from paddle_tpu.serving.adapters import weight_quant as jax_wq

from paddle_tpu_torch.models import build_gpt, gpt_config, load_jax_state
from paddle_tpu_torch.serving import (AdapterRankError, AdapterRegistry,
                                      AdapterShapeError, Engine,
                                      EngineSupervisor, LoraAdapter,
                                      UnknownAdapterError, make_lora,
                                      merge_into_qkv)
from paddle_tpu_torch.serving.adapters import weight_quant
from paddle_tpu_torch.serving.adapters.registry import AdapterResidency
from paddle_tpu_torch.testing import faults

torch.set_num_threads(1)

TIMEOUT = 120      # every result() and join() is bounded


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


@pytest.fixture(scope="module")
def cfg(models):
    return models[1].config


@pytest.fixture(scope="module")
def adapters(cfg):
    return {name: make_lora(cfg, rank=2 + 2 * i, seed=10 + i, name=name,
                            std=0.2)
            for i, name in enumerate(["tenant-a", "tenant-b", "tenant-c"])}


def _merged(pm, adapter):
    m = copy.deepcopy(pm)
    merge_into_qkv(m, adapter)
    return m


def _engine(model, **kw):
    kw.setdefault("max_queue", 32)
    return Engine(model, paged_kv=True, decode_kernel="pallas",
                  sample_on_device=False, **kw)


def _run(engine, prompts, new=6, shutdown=True, **kw):
    try:
        handles = [engine.submit(p, max_new_tokens=new, **kw)
                   for p in prompts]
        return [h.result(timeout=TIMEOUT) for h in handles]
    finally:
        if shutdown:
            engine.shutdown()


def _prompts(n, length=8, seed=0, vocab=1024):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, vocab, length).astype(np.int64) for _ in range(n)]


# -- units: registry + residency ---------------------------------------------

def test_registry_validation_and_double_register(models, cfg):
    _, pm = models
    reg = AdapterRegistry(pm, max_resident=2, max_rank=8)
    ad = make_lora(cfg, rank=4, seed=0, name="x")
    reg.register(ad)
    assert "x" in reg and len(reg) == 1
    reg.register(make_lora(cfg, rank=4, seed=9, name="x"))
    with pytest.raises(AdapterShapeError, match="rank"):
        reg.register(make_lora(cfg, rank=2, seed=0, name="x"))
    with pytest.raises(AdapterShapeError, match="layers"):
        reg.register(LoraAdapter("bad", [ad.a[0]], [ad.b[0]]))
    wrong = make_lora(gpt_config("gpt-tiny", hidden_size=64), rank=4,
                      seed=0, name="bad")
    with pytest.raises(AdapterShapeError):
        reg.register(wrong)
    with pytest.raises(ValueError, match="rank"):
        LoraAdapter("bad", [np.zeros((8, 4))], [np.zeros((2, 24))])
    with pytest.raises(ValueError, match="compose"):
        LoraAdapter("bad", [np.zeros((8, 4))], [np.zeros(4)])
    with pytest.raises(ValueError):
        AdapterRegistry(object())
    # the same seed draws the JAX package's factors
    jad = jax_make_lora(cfg, rank=4, seed=0, name="x")
    for mine, theirs in zip(ad.a + ad.b, jad.a + jad.b):
        np.testing.assert_array_equal(mine, theirs)
    assert ad.scale == jad.scale
    assert reg.bank_nbytes() == JaxRegistry(
        models[0], max_resident=2, max_rank=8).bank_nbytes()


def test_residency_refcount_lru_units():
    res = AdapterResidency(2)
    s1, cold = res.acquire("a")
    assert cold and s1 in (1, 2) and res.n_resident == 1
    res.mark_loaded("a")
    s2, cold2 = res.acquire("b")
    assert cold2 and s2 != s1
    assert res.acquire("c") is None
    res.release("a")
    s3, cold3 = res.acquire("c")
    assert cold3 and s3 == s1 and res.evictions == 1
    assert res.slot_of("a") is None and res.slot_of("b") == s2
    res.mark_loaded("c")
    s4, cold4 = res.acquire("c")
    assert s4 == s3 and not cold4 and res.hits == 1
    with pytest.raises(AssertionError, match="leaked"):
        res.check()
    res.release("b")
    res.release("c")
    res.release("c")
    res.check()


# -- parity within the port ---------------------------------------------------

def test_adapter_id0_token_identical_to_adapter_free_engine(models,
                                                            adapters):
    _, pm = models
    prompts = _prompts(4)
    base = _run(_engine(pm, max_slots=2, max_len=64), prompts)
    reg = AdapterRegistry(pm, max_resident=2, max_rank=8)
    reg.register(adapters["tenant-a"])
    eng = _engine(pm, max_slots=2, max_len=64, adapters=reg)
    outs = _run(eng, prompts, shutdown=False)
    st = eng.stats()
    eng.shutdown()
    for i, (b, o) in enumerate(zip(base, outs)):
        np.testing.assert_array_equal(b, o, err_msg=f"request {i}")
    assert st["decode_compiles"] == 1
    assert st["adapter_loads"] == 0


def test_adapter_outputs_match_offline_merged_weights(models, adapters):
    """Per-row application == the merged-weights forward, with base and
    adapter rows mixed in the same batches."""
    _, pm = models
    prompts = _prompts(3, seed=1)
    reg = AdapterRegistry(pm, max_resident=3, max_rank=8)
    for ad in adapters.values():
        reg.register(ad)
    eng = _engine(pm, max_slots=4, max_len=64, adapters=reg)
    names = ["tenant-a", "tenant-b", None]
    handles = [eng.submit(p, max_new_tokens=6, adapter=nm)
               for p in prompts for nm in names]
    outs = [h.result(timeout=TIMEOUT) for h in handles]
    st = eng.stats()
    eng.shutdown()
    assert st["decode_compiles"] == 1, st
    by_name = {}
    for (_, nm), o in zip(((i, nm) for i in range(len(prompts))
                           for nm in names), outs):
        by_name.setdefault(nm, []).append(o)
    for nm in ["tenant-a", "tenant-b"]:
        want = _run(_engine(_merged(pm, adapters[nm]), max_slots=2,
                            max_len=64), prompts)
        for i, (w, o) in enumerate(zip(want, by_name[nm])):
            np.testing.assert_array_equal(w, o, err_msg=f"{nm} request {i}")
        assert any(not np.array_equal(w, b)
                   for w, b in zip(want, by_name[None]))


def test_unknown_and_never_fits_typed_errors_at_submit(models, cfg,
                                                       adapters):
    _, pm = models
    reg = AdapterRegistry(pm, max_resident=2, max_rank=4)
    reg.register(adapters["tenant-a"])
    reg.register(make_lora(cfg, rank=6, seed=5, name="too-big"))
    eng = _engine(pm, max_slots=2, max_len=64, adapters=reg,
                  auto_start=False)
    p = np.arange(1, 9).astype(np.int64)
    with pytest.raises(UnknownAdapterError, match="nope"):
        eng.submit(p, adapter="nope")
    with pytest.raises(AdapterRankError, match="never"):
        eng.submit(p, adapter="too-big")
    eng.shutdown()
    plain = _engine(pm, max_slots=2, max_len=64, auto_start=False)
    with pytest.raises(ValueError, match="no adapter registry"):
        plain.submit(p, adapter="tenant-a")
    plain.shutdown()
    with pytest.raises(ValueError, match="weight_dtype"):
        _engine(pm, max_slots=2, max_len=32, weight_dtype="fp4")


def test_pinned_adapter_survives_lru_sweep_mid_flight(models, adapters):
    """With one bank row, a second adapter's request waits (queued) while
    the first is pinned by in-flight work, and the pinned adapter's
    output is untouched by the pressure."""
    _, pm = models
    reg = AdapterRegistry(pm, max_resident=1, max_rank=8)
    reg.register(adapters["tenant-a"])
    reg.register(adapters["tenant-b"])
    eng = _engine(pm, max_slots=2, max_len=64, adapters=reg,
                  prefill_batch=1)
    p = np.arange(3, 11).astype(np.int64)
    long_req = eng.submit(p, max_new_tokens=24, adapter="tenant-a")
    blocked = eng.submit(p, max_new_tokens=4, adapter="tenant-b")
    evictions_seen = []
    deadline = time.perf_counter() + TIMEOUT
    while not long_req.done():
        assert time.perf_counter() < deadline
        evictions_seen.append(eng.stats()["adapter_evictions"])
        time.sleep(0.002)
    long_out = long_req.result(timeout=TIMEOUT)
    blocked_out = blocked.result(timeout=TIMEOUT)
    st = eng.stats()
    eng.shutdown()
    assert all(v == 0 for v in evictions_seen[:-1] or evictions_seen), \
        "the pinned adapter was evicted mid-flight"
    assert st["adapter_load_stalls"] >= 1, st
    assert st["adapter_evictions"] == 1
    ref = _engine(_merged(pm, adapters["tenant-a"]), max_slots=2, max_len=64)
    np.testing.assert_array_equal(long_out, _run(ref, [p], new=24)[0])
    ref = _engine(_merged(pm, adapters["tenant-b"]), max_slots=2, max_len=64)
    np.testing.assert_array_equal(blocked_out, _run(ref, [p], new=4)[0])


def test_eviction_then_rehit_reloads_correctly(models, cfg):
    """a -> b (evicts a) -> a: the reloaded bank row serves the first
    residency's tokens."""
    _, pm = models
    reg = AdapterRegistry(pm, max_resident=1, max_rank=8)
    reg.register(make_lora(cfg, rank=4, seed=20, name="tenant-a", std=0.5))
    reg.register(make_lora(cfg, rank=4, seed=21, name="tenant-b", std=0.5))
    eng = _engine(pm, max_slots=1, max_len=64, adapters=reg)
    p = np.arange(2, 10).astype(np.int64)
    outs = [eng.submit(p, max_new_tokens=6, adapter=nm).result(
        timeout=TIMEOUT) for nm in ("tenant-a", "tenant-b", "tenant-a")]
    st = eng.stats()
    eng.shutdown()
    np.testing.assert_array_equal(outs[0], outs[2])
    assert not np.array_equal(outs[0], outs[1])
    assert st["adapter_loads"] == 3, st
    assert st["adapter_evictions"] == 2, st
    assert st["adapters_resident"] == 1 and st["adapters_pinned"] == 0


def test_prefix_cache_keyed_by_adapter(models, adapters):
    """The same prompt under two adapters never shares pages; a
    same-adapter rerun hits."""
    _, pm = models
    prompt = np.random.RandomState(3).randint(0, 1024, 14).astype(np.int64)
    reg = AdapterRegistry(pm, max_resident=2, max_rank=8)
    reg.register(adapters["tenant-a"])
    eng = _engine(pm, max_slots=3, max_len=64, adapters=reg,
                  prefix_cache=True, prefix_block=4, prefill_batch=1)
    base1 = eng.submit(prompt, max_new_tokens=6).result(timeout=TIMEOUT)
    st0 = eng.stats()
    ha = eng.submit(prompt, max_new_tokens=6, adapter="tenant-a")
    a1 = ha.result(timeout=TIMEOUT)
    st1 = eng.stats()
    assert not ha.prefix_hit
    assert st1["prefix_hits"] == st0["prefix_hits"]
    hb = eng.submit(prompt, max_new_tokens=6)
    ha2 = eng.submit(prompt, max_new_tokens=6, adapter="tenant-a")
    base2, a2 = hb.result(timeout=TIMEOUT), ha2.result(timeout=TIMEOUT)
    st2 = eng.stats()
    eng.shutdown()
    assert hb.prefix_hit and ha2.prefix_hit
    assert st2["prefix_hits"] >= st1["prefix_hits"] + 2
    np.testing.assert_array_equal(base1, base2)
    np.testing.assert_array_equal(a1, a2)
    assert not np.array_equal(base1, a1)
    ref = _engine(_merged(pm, adapters["tenant-a"]), max_slots=2, max_len=64)
    np.testing.assert_array_equal(a1, _run(ref, [prompt])[0])


def test_weight_int8_parity_and_bytes(models):
    """int8 weights: under half the f32 bytes, one decode signature, and
    at least 90% of the f32 engine's greedy tokens (the JAX test's
    bound)."""
    _, pm = models
    prompts = _prompts(4, seed=4)
    f32 = _engine(pm, max_slots=2, max_len=64)
    base = _run(f32, prompts, new=8)
    q = _engine(pm, max_slots=2, max_len=64, weight_dtype="int8")
    got = _run(q, prompts, new=8, shutdown=False)
    st = q.stats()
    q.shutdown()
    assert 0 < q.weight_bytes() < 0.5 * f32.weight_bytes()
    assert st["weight_bytes"] == q.weight_bytes()
    assert st["decode_compiles"] == 1
    match = float(np.mean([np.mean(b == g) for b, g in zip(base, got)]))
    assert match >= 0.9, f"int8 weights diverged: {match:.2f} token match"


def test_all_flags_composed_one_decode_signature(models, adapters):
    """prefix + speculation + int8 KV + adapters + int8 weights: one
    decode signature, and base rows equal the engine without the adapter
    path."""
    _, pm = models
    prompts = _composed_prompts()
    kw = dict(max_slots=3, max_len=64, prefix_cache=True, prefix_block=4,
              speculative_k=3, kv_dtype="int8", weight_dtype="int8")
    base = _run(_engine(pm, **kw), prompts)
    reg = AdapterRegistry(pm, max_resident=2, max_rank=8)
    reg.register(adapters["tenant-a"])
    reg.register(adapters["tenant-b"])
    eng = _engine(pm, adapters=reg, **kw)
    handles = [eng.submit(p, max_new_tokens=6, adapter=nm)
               for p, nm in zip(prompts, COMPOSED_NAMES)]
    outs = [h.result(timeout=TIMEOUT) for h in handles]
    st = eng.stats()
    eng.shutdown()
    assert st["decode_compiles"] == 1, st
    for i, (o, nm) in enumerate(zip(outs, COMPOSED_NAMES)):
        if nm is None:
            np.testing.assert_array_equal(base[i], o, err_msg=f"request {i}")
    assert st["adapter_loads"] == 2 and st["adapters_resident"] == 2
    assert st["prefix_hits"] + st["prefix_misses"] == len(prompts)
    assert st["weight_bytes"] > 0


def test_supervisor_rebuild_fresh_banks_zero_pins(models, adapters):
    """Kill and rebuild with an adapter live: the registry persists, the
    rebuilt engine's banks are fresh (a cold reload), no pin leaks, and
    the adapter's tokens are the same across the restart."""
    _, pm = models
    reg = AdapterRegistry(pm, max_resident=2, max_rank=8)
    reg.register(adapters["tenant-a"])
    built = []

    def factory():
        e = _engine(pm, max_slots=2, max_len=64, adapters=reg)
        built.append(e)
        return e

    sup = EngineSupervisor(factory, name="lora", poll_interval_s=0.02,
                           max_restarts=4)
    p = np.arange(4, 12).astype(np.int64)
    try:
        before = sup.submit(p, max_new_tokens=6,
                            adapter="tenant-a").result(timeout=TIMEOUT)
        assert sup.stats()["adapter_loads"] == 1
        faults.arm("serving.scheduler", times=1)
        deadline = time.perf_counter() + TIMEOUT
        while sup.restarts < 1:
            assert time.perf_counter() < deadline, "kill never absorbed"
            time.sleep(0.01)
        after = sup.submit(p, max_new_tokens=6,
                           adapter="tenant-a").result(timeout=TIMEOUT)
        np.testing.assert_array_equal(before, after)
        assert sup.stats()["adapter_loads"] == 1     # the rebuilt bank
        assert all(b["decode_compiles"] <= 1 for b in sup.builds())
        assert sup.failed is None
    finally:
        faults.reset()
        sup.shutdown()
    for e in built:
        e.shutdown()
        e._adapters.check()
    assert len(built) >= 2


# -- the port against the JAX package -----------------------------------------

COMPOSED_NAMES = [None, "tenant-a", None, "tenant-b", None, "tenant-a"]


def _composed_prompts():
    rs = np.random.RandomState(9)
    shared = rs.randint(0, 1024, 12).astype(np.int64)
    return [np.concatenate([shared, rs.randint(0, 1024, 3).astype(np.int64)])
            for _ in range(6)]


def _jax_registry(jm, adapters, names, **kw):
    reg = JaxRegistry(jm, **kw)
    for nm in names:
        ad = adapters[nm]
        reg.register(jax_make_lora(jm.gpt.config, rank=ad.rank,
                                   seed=10 + ["tenant-a", "tenant-b",
                                              "tenant-c"].index(nm),
                                   name=nm, std=0.2))
    return reg


def _both(jm, pm, adapters, names, prompts, adapter_names, new=6,
          **kw):
    """Greedy tokens of the JAX engine and the port's, adapters ``names``
    registered in both, request i under ``adapter_names[i]``."""
    kw = dict(max_slots=3, max_len=64, page_size=8, max_queue=16, **kw)
    out = []
    for side in ("jax", "port"):
        if side == "jax":
            reg = (_jax_registry(jm, adapters, names, max_resident=2,
                                 max_rank=8) if names else None)
            eng = JaxEngine(jm, paged_kv=True, decode_kernel="pallas",
                            adapters=reg, **kw)
        else:
            reg = None
            if names:
                reg = AdapterRegistry(pm, max_resident=2, max_rank=8)
                for nm in names:
                    reg.register(adapters[nm])
            eng = Engine(pm, paged_kv=True, decode_kernel="pallas",
                         sample_on_device=False, adapters=reg, **kw)
        try:
            hs = [eng.submit(p, max_new_tokens=new, adapter=nm)
                  for p, nm in zip(prompts, adapter_names)]
            out.append(([h.result(timeout=300) for h in hs], eng.stats()))
        finally:
            eng.shutdown()
    return out


def test_mixed_base_and_adapter_rows_match_jax(models, adapters):
    jm, pm = models
    prompts = _prompts(6, length=9, seed=21)
    names = ["tenant-a", None, "tenant-b", None, "tenant-a", "tenant-b"]
    (want, jst), (got, st) = _both(jm, pm, adapters, ["tenant-a", "tenant-b"],
                                   prompts, names)
    for i, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
    assert st["adapter_loads"] == jst["adapter_loads"] == 2
    assert st["decode_compiles"] == 1


def test_quantize_state_and_int8_engine_match_jax(models):
    """int8 values and scales equal the JAX package's exactly (linear
    weights through the transpose), the stored bytes too, and the two int8
    engines' greedy tokens are identical."""
    jm, pm = models
    packed, _ = jax_wq.quantize_state(state_values(jm))
    mine = weight_quant.quantize_state(
        pm.state_dict(), transposed={f"{n}.weight" for n, m in
                                     pm.named_modules()
                                     if isinstance(m, torch.nn.Linear)})
    assert set(mine) == set(packed)
    n_quant = 0
    for name, leaf in mine.items():
        if isinstance(leaf, weight_quant.Int8Leaf):
            q, s = (np.asarray(a) for a in packed[name])
            mq = leaf.q.numpy()
            np.testing.assert_array_equal(mq.T if leaf.dim == 0 else mq, q,
                                          err_msg=name)
            np.testing.assert_array_equal(leaf.scale.numpy(), s,
                                          err_msg=name)
            n_quant += 1
        else:
            assert not isinstance(packed[name], tuple), name
    assert n_quant == 2 + 4 * pm.config.num_layers
    assert weight_quant.state_bytes(mine) == jax_wq.state_bytes(packed)
    # the dequantized weights are the JAX package's too
    deq = weight_quant.dequantize_state(mine)
    jdeq = jax_wq.dequantize_state(packed, {k: jnp.float32 for k, v in
                                            packed.items()
                                            if isinstance(v, tuple)})
    wte = "gpt.embeddings.word_embeddings.weight"
    np.testing.assert_array_equal(deq[wte].numpy(), np.asarray(jdeq[wte]))
    prompts = _prompts(4, seed=4)
    (want, jst), (got, st) = _both(jm, pm, None, [], prompts, [None] * 4,
                                   new=8, weight_dtype="int8")
    for i, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
    assert st["weight_bytes"] == jst["weight_bytes"]


def test_all_flags_composed_match_jax(models, adapters):
    """prefix + speculation + int8 KV + adapters + int8 weights on both
    packages: identical greedy tokens, one decode signature each."""
    jm, pm = models
    (want, jst), (got, st) = _both(
        jm, pm, adapters, ["tenant-a", "tenant-b"], _composed_prompts(),
        COMPOSED_NAMES, prefix_cache=True, prefix_block=4, speculative_k=3,
        kv_dtype="int8", weight_dtype="int8")
    for i, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
    assert st["decode_compiles"] == jst["decode_compiles"] == 1
    assert st["prefix_hits"] == jst["prefix_hits"]
