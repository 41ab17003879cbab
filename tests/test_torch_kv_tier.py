"""The port's host prefix tier (``serving/kv_tier.py``) and the engine's
use of it.

The port's mirror of the 9 tests of ``tests/test_kv_tier.py`` on the port's
tier and ``Engine(paged_kv=True, decode_kernel="pallas")`` on a CPU model
(gpt-tiny, weights loaded from the JAX model; tier payloads are torch
tensors), then: demoted int8 pages come back byte for byte, and the port's
tokens after a promote are the JAX package's (``Engine(paged_kv=True,
decode_kernel="pallas")``, its kernel in Pallas interpret mode) on the same
weights and prompts. Greedy tokens must be identical. Every wait is bounded.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import paddle_tpu as paddle
from paddle_tpu.models import build_gpt as jax_build_gpt
from paddle_tpu.models import gpt_config as jax_gpt_config
from paddle_tpu.serving import Engine as JaxEngine

from paddle_tpu_torch.models import build_gpt, load_jax_state
from paddle_tpu_torch.serving import Engine, HostPrefixTier
from paddle_tpu_torch.testing.load_gen import make_conversation_trace

torch.set_num_threads(1)

TIMEOUT = 120


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


def _ref_greedy_tokens(pm, prompt, n_new):
    """Full-forward (no cache) greedy continuation of one prompt."""
    ids = list(np.asarray(prompt, np.int64))
    out = []
    with torch.no_grad():
        for _ in range(n_new):
            nxt = int(pm(torch.tensor([ids]))[0, -1].argmax())
            out.append(nxt)
            ids.append(nxt)
    return out


def _payload(n_pages, fill, page=4):
    """One pool group of [int8 KV pages, f32 scale sidecar]: 24 bytes a
    page."""
    return [[torch.full((n_pages, page, 2), fill, dtype=torch.int8),
             torch.full((n_pages, page, 1), float(fill))]]


# -- tier unit contract -------------------------------------------------------

def test_tier_demote_lookup_roundtrip():
    tier = HostPrefixTier(capacity_mb=1.0, block=4)
    toks = tuple(range(8))
    assert tier.demote_async(None, toks, _payload(2, 7))
    assert tier.flush()
    assert len(tier) == 1 and tier.bytes_used == 48
    entry, m = tier.lookup(list(range(12)))
    assert m == 8 and entry.tokens == toks
    got = tier.payload(entry, 2)
    assert torch.equal(got[0][0], _payload(2, 7)[0][0])
    assert torch.equal(got[0][1], _payload(2, 7)[0][1])
    _, m2 = tier.lookup(list(range(8)))
    assert m2 == 4
    assert tier.lookup(list(range(12)), ns="other") is None
    assert tier.lookup([0, 1, 2]) is None
    assert not tier.demote_async(None, (1, 2, 3), _payload(1, 1))
    assert not tier.demote_async(None, toks, _payload(2, 9))
    st = tier.stats()
    assert st["demotes"] == 1 and st["dedup_skips"] == 1
    assert st["hits"] == 2 and st["misses"] == 2
    tier.check()
    tier.close()
    assert tier.bytes_used == 0 and len(tier) == 0
    tier.close()
    assert not tier.demote_async(None, (9,) * 8, _payload(2, 1))


def test_tier_capacity_lru_drops_touched_last():
    tier = HostPrefixTier(capacity_mb=100 / (1 << 20), block=4)
    tier.demote_async("a", tuple(range(8)), _payload(2, 1))
    tier.demote_async("a", tuple(range(100, 108)), _payload(2, 2))
    assert tier.flush() and len(tier) == 2
    tier.lookup(list(range(9)), ns="a")          # touch the older entry
    tier.demote_async("a", tuple(range(200, 208)), _payload(2, 3))
    assert tier.flush()
    assert len(tier) == 2 and tier.stats()["drops"] == 1
    assert tier.lookup(list(range(100, 109)), ns="a", peek=True) is None
    assert tier.lookup(list(range(9)), ns="a", peek=True) is not None
    assert tier.lookup(list(range(200, 209)), ns="a", peek=True) is not None
    tier.check()
    tier.close()


def test_tier_refcount_pins_against_capacity_drop():
    tier = HostPrefixTier(capacity_mb=60 / (1 << 20), block=4)
    tier.demote_async(None, tuple(range(8)), _payload(2, 1))
    assert tier.flush()
    e, _ = tier.lookup(list(range(9)))
    tier.acquire(e)
    tier.demote_async(None, tuple(range(50, 58)), _payload(2, 2))
    assert tier.flush()
    assert tier.lookup(list(range(9)), peek=True) is not None
    assert tier.stats()["drops"] == 1
    assert tier.payload(e, 2)[0][0].shape == (2, 4, 2)
    tier.release(e)
    with pytest.raises(KeyError):
        tier.release(e)
    assert tier.drop_all() == 1
    with pytest.raises(KeyError):
        tier.payload(e, 1)
    tier.check()
    tier.close()


def test_tier_and_engine_knob_validation(models):
    _, pm = models
    with pytest.raises(ValueError):
        HostPrefixTier(capacity_mb=0)
    with pytest.raises(ValueError):
        HostPrefixTier(block=0)
    with pytest.raises(ValueError):   # the tier needs the prefix index
        Engine(pm, paged_kv=True, decode_kernel="pallas",
               sample_on_device=False, max_slots=1, max_len=32,
               host_prefix_mb=8)
    tier = HostPrefixTier(capacity_mb=8, block=8)
    with pytest.raises(ValueError):   # both knobs at once
        Engine(pm, paged_kv=True, decode_kernel="pallas",
               sample_on_device=False, max_slots=1, max_len=32,
               prefix_cache=True, prefix_block=4, num_pages=16,
               host_prefix_mb=8, host_prefix=tier)
    with pytest.raises(ValueError):   # shared-tier block mismatch
        Engine(pm, paged_kv=True, decode_kernel="pallas",
               sample_on_device=False, max_slots=1, max_len=32,
               prefix_cache=True, prefix_block=4, num_pages=16,
               host_prefix=tier)
    tier.close()


# -- engine end-to-end --------------------------------------------------------

def _engine(pm, **kw):
    return Engine(pm, paged_kv=True, decode_kernel="pallas",
                  sample_on_device=False, max_slots=2, max_len=48,
                  prefix_cache=True, prefix_block=4, num_pages=24, **kw)


def _conversation_round(eng, p1, fillers, extra):
    """Turn 1 under one conversation id, filler traffic that forces it
    out of the device index, then the warm turn (turn 1's prompt, its
    reply and new tokens).  Returns (t1, warm prompt, warm tokens, warm
    handle)."""
    t1 = np.asarray(eng.submit(p1, max_new_tokens=4, conversation="c1")
                    .result(timeout=300))
    for i, f in enumerate(fillers):
        eng.submit(f, max_new_tokens=4,
                   conversation=f"fill{i}").result(timeout=300)
    if eng._host_tier is not None:
        assert eng._host_tier.flush()
    warm = np.concatenate([p1, t1, extra]).astype(np.int64)
    hw = eng.submit(warm, max_new_tokens=4, conversation="c1")
    tw = np.asarray(hw.result(timeout=300))
    return t1, warm, tw, hw


@pytest.fixture(scope="module")
def conv_inputs():
    rs = np.random.RandomState(11)
    p1 = rs.randint(0, 1024, 12).astype(np.int64)
    fillers = [rs.randint(0, 1024, 12).astype(np.int64) for _ in range(6)]
    extra = rs.randint(0, 1024, 4).astype(np.int64)
    return p1, fillers, extra


def test_warm_turn_after_eviction_promotes_token_identical(models,
                                                          conv_inputs):
    _, pm = models
    p1, fillers, extra = conv_inputs
    eng = _engine(pm, host_prefix_mb=64)
    _, warm, tw, hw = _conversation_round(eng, p1, fillers, extra)
    st = eng.stats()
    eng.shutdown()
    np.testing.assert_array_equal(tw, _ref_greedy_tokens(pm, warm, 4))
    assert hw.prefix_hit, "the warm turn must admit as a (promoted) hit"
    assert st["host_prefix_hits"] == 1
    assert st["host_prefix_promotes"] == 1
    assert st["host_prefix_promoted_pages"] >= 1
    assert st["host_prefix"]["demotes"] >= 1
    assert st["host_prefix"]["hits"] == 1
    assert st["decode_compiles"] == 1
    # the engine-owned tier closed with the engine
    assert eng._host_tier.bytes_used == 0


def test_demotion_disabled_regression_matches_untired_engine(models,
                                                            conv_inputs):
    _, pm = models
    p1, fillers, extra = conv_inputs
    eng = _engine(pm)
    assert eng._host_tier is None
    _, warm, tw, hw = _conversation_round(eng, p1, fillers, extra)
    st = eng.stats()
    eng.shutdown()
    np.testing.assert_array_equal(tw, _ref_greedy_tokens(pm, warm, 4))
    assert not hw.prefix_hit, \
        "filler traffic must evict turn 1: the warm turn re-prefills"
    assert "host_prefix" not in st
    assert st["host_prefix_hits"] == 0 and st["host_prefix_promotes"] == 0
    assert st["decode_compiles"] == 1


def test_shared_tier_survives_engine_rebuild(models, conv_inputs):
    _, pm = models
    p1, fillers, extra = conv_inputs
    tier = HostPrefixTier(capacity_mb=64, block=4)
    eng1 = _engine(pm, host_prefix=tier)
    t1 = np.asarray(eng1.submit(p1, max_new_tokens=4, conversation="c1")
                    .result(timeout=300))
    for i, f in enumerate(fillers):
        eng1.submit(f, max_new_tokens=4,
                    conversation=f"fill{i}").result(timeout=300)
    assert tier.flush()
    eng1.shutdown()
    assert len(tier) > 0 and tier.bytes_used > 0
    tier.check()
    eng2 = _engine(pm, host_prefix=tier)
    warm = np.concatenate([p1, t1, extra]).astype(np.int64)
    hw = eng2.submit(warm, max_new_tokens=4, conversation="c1")
    tw = np.asarray(hw.result(timeout=300))
    st2 = eng2.stats()
    eng2.shutdown()
    np.testing.assert_array_equal(tw, _ref_greedy_tokens(pm, warm, 4))
    assert hw.prefix_hit and st2["host_prefix_promotes"] == 1
    tier.check()
    tier.close()
    assert tier.bytes_used == 0


def test_conversation_namespaces_do_not_share_entries(models):
    _, pm = models
    p = np.random.RandomState(23).randint(0, 1024, 12).astype(np.int64)
    eng = Engine(pm, paged_kv=True, decode_kernel="pallas",
                 sample_on_device=False, max_slots=2, max_len=48,
                 prefix_cache=True, prefix_block=4, num_pages=32)
    ref = eng.submit(p, max_new_tokens=4,
                     conversation="a").result(timeout=TIMEOUT)
    hb = eng.submit(p, max_new_tokens=4, conversation="b")
    out_b = hb.result(timeout=TIMEOUT)
    ha = eng.submit(p, max_new_tokens=4, conversation="a")
    out_a = ha.result(timeout=TIMEOUT)
    st = eng.stats()
    eng.shutdown()
    assert not hb.prefix_hit, "cross-conversation reuse is forbidden"
    assert ha.prefix_hit, "the same conversation re-uses its own turns"
    assert st["prefix_hits"] == 1
    np.testing.assert_array_equal(out_a, ref)
    np.testing.assert_array_equal(out_b, ref)


def test_conversation_trace_warm_turns_hit(models):
    """A seeded multi-turn trace (``paddle_tpu_torch.testing.load_gen``;
    turn N+1's prompt extends turn N's) served turn by turn through the
    tiered engine over a pool small enough to evict: every warm turn
    admits as a hit (on the device or promoted from the host), with the
    tokens of an engine without any prefix reuse."""
    _, pm = models
    trace = make_conversation_trace(40.0, 1.0, seed=3, turns_mean=3.0,
                                    prompt_max=96, out_max=8, vocab=1024)
    convs = {}
    for e in trace:
        convs.setdefault(e["conversation"], []).append(e)
    turns = [e for c in list(convs.values())[:4] for e in c]
    assert any(e["turn"] > 0 for e in turns), "no warm turns"
    tiered = Engine(pm, paged_kv=True, decode_kernel="pallas",
                    sample_on_device=False, max_slots=2, max_len=112,
                    prefix_cache=True, prefix_block=4, num_pages=40,
                    host_prefix_mb=16)
    plain = Engine(pm, paged_kv=True, decode_kernel="pallas",
                   sample_on_device=False, max_slots=2, max_len=112,
                   num_pages=40, page_size=4)
    try:
        for e in turns:
            p = np.asarray(e["prompt"], np.int64)
            h = tiered.submit(p, max_new_tokens=e["max_tokens"],
                              conversation=e["conversation"])
            got = h.result(timeout=TIMEOUT)
            want = plain.submit(p, max_new_tokens=e["max_tokens"]).result(
                timeout=TIMEOUT)
            np.testing.assert_array_equal(got, want)
            assert h.prefix_hit == (e["turn"] > 0), e["turn"]
            tiered._host_tier.flush()
        st = tiered.stats()
    finally:
        tiered.shutdown()
        plain.shutdown()
    assert st["decode_compiles"] == 1


# -- byte identity, and the JAX package ---------------------------------------

def _entry_bytes(eng, ns, n_tokens=None):
    """The device bytes of the prefix entry under ``ns`` (its first
    ``n_tokens`` tokens when given), per pool group per layer."""
    (entry,) = [e for (ens, toks), e in eng._prefix._entries.items()
                if ens == ns and (n_tokens is None or len(toks) == n_tokens)]
    idx = torch.tensor(entry.pages)
    return entry, [[pool.index_select(0, idx) for pool in grp]
                   for grp in eng._pool_groups()]


def test_int8_pages_demote_and_promote_byte_identical(models, conv_inputs):
    """int8 pools: turn 1's pages (int8 payloads and f32 scales) reach
    the host byte for byte, and the promoted pages on the device equal
    them again."""
    _, pm = models
    p1, fillers, extra = conv_inputs
    eng = _engine(pm, host_prefix_mb=64, kv_dtype="int8")
    try:
        t1 = eng.submit(p1, max_new_tokens=4, conversation="c1").result(
            timeout=TIMEOUT)
        entry, before = _entry_bytes(eng, (None, "c1"))
        for i, f in enumerate(fillers):
            eng.submit(f, max_new_tokens=4,
                       conversation=f"fill{i}").result(timeout=TIMEOUT)
        tier = eng._host_tier
        assert tier.flush()
        hentry = tier._entries[((None, "c1"), entry.tokens)]
        assert len(before) == 4                    # k, v, k scales, v scales
        for host_grp, dev_grp in zip(hentry.payload, before):
            for host, dev in zip(host_grp, dev_grp):
                assert host.dtype == dev.dtype and torch.equal(host, dev)
        warm = np.concatenate([p1, t1, extra]).astype(np.int64)
        hw = eng.submit(warm, max_new_tokens=4, conversation="c1")
        hw.result(timeout=TIMEOUT)
        assert hw.prefix_hit and eng.stats()["host_prefix_promotes"] == 1
        m = hw._prefix_match
        q = -(-m // 4)
        _, after = _entry_bytes(eng, (None, "c1"), n_tokens=m)
        for a_grp, b_grp in zip(after, before):
            for a, b in zip(a_grp, b_grp):
                assert torch.equal(a, b[:q])
    finally:
        eng.shutdown()


def test_promoted_tokens_match_jax(models, conv_inputs):
    jm, pm = models
    p1, fillers, extra = conv_inputs
    jeng = JaxEngine(jm, max_slots=2, max_len=48, prefix_cache=True,
                     prefix_block=4, paged_kv=True, num_pages=24,
                     decode_kernel="pallas", host_prefix_mb=64)
    try:
        jt1, _, jtw, jhw = _conversation_round(jeng, p1, fillers, extra)
        jst = jeng.stats()
    finally:
        jeng.shutdown()
    eng = _engine(pm, host_prefix_mb=64)
    try:
        t1, _, tw, hw = _conversation_round(eng, p1, fillers, extra)
        st = eng.stats()
    finally:
        eng.shutdown()
    assert jhw.prefix_hit and hw.prefix_hit
    assert st["host_prefix_promotes"] == jst["host_prefix_promotes"] == 1
    np.testing.assert_array_equal(t1, jt1)
    np.testing.assert_array_equal(tw, jtw)
