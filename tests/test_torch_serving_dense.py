"""The rest of the serving engine against the JAX package's, on gpt-tiny
(f32, the same weights through ``load_jax_state``): the constructor's
surface (parameters, order, defaults), the dense slot pool (f32 and int8,
the prefix cache's retained rows, ``speculative_k``), the paged pool read
by gathering (``decode_kernel="xla"``) and by the kernel (``"pallas"``), a
MoE model, every flag composed at one decode signature, and the device
sampler.  Both engines run with their defaults unless a test says
otherwise, so the port computes what the JAX engine computes: greedy
tokens must be identical bitwise.  The device sampler's draws are the JAX
sampler's in distribution (a chi-square test over 4000 draws), not in
bits.  The card twins carry the ``cuda`` marker.
"""
import inspect

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import paddle_tpu as paddle
from paddle_tpu.models import build_gpt as jax_build_gpt
from paddle_tpu.models import gpt_config as jax_gpt_config
from paddle_tpu.serving import AdapterRegistry as JaxAdapterRegistry
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu.serving import make_lora as jax_make_lora

from paddle_tpu_torch.models import build_gpt, load_jax_state
from paddle_tpu_torch.serving import (AdapterRegistry, Engine, SlotPool,
                                      make_lora)
from paddle_tpu_torch.serving import engine as eng_mod
from test_torch_cuda import cuda  # noqa: F401  (the card fixture)

torch.set_num_threads(1)

VOCAB = 1024


def _pair(seed=7, **overrides):
    cfg = jax_gpt_config("gpt-tiny", max_position_embeddings=128,
                         hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
                         **overrides)
    paddle.seed(seed)
    jm = jax_build_gpt(cfg)
    jm.eval()
    pm = build_gpt("gpt-tiny", device="cpu", max_position_embeddings=128,
                   **overrides)
    load_jax_state(pm, {k: np.asarray(v._value)
                        for k, v in jm.state_dict().items()})
    return jm, pm


@pytest.fixture(scope="module")
def models():
    return _pair()


def _prompts(n, seed=0, lo=3, hi=30):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, VOCAB, rs.randint(lo, hi)).astype(np.int64)
            for _ in range(n)]


def _shared(n, seed=1, shared_len=20):
    rs = np.random.RandomState(seed)
    head = rs.randint(0, VOCAB, shared_len).astype(np.int64)
    return [np.concatenate([head, rs.randint(0, VOCAB, rs.randint(2, 9))])
            for _ in range(n)]


def _serve(engine, prompts, new=8, one_by_one=False, kws=None):
    """Every prompt's tokens and the stats before shutdown.  The engine is
    built with ``auto_start=False``: all the requests are queued before
    its scheduler starts, so the admission waves (and the step counts) do
    not depend on timing; ``one_by_one`` instead finishes each request
    (so a prefix cache retains it) before the next.  Request ``i`` takes
    ``kws[i]`` (sampling arguments) when given."""
    kws = kws or [{}] * len(prompts)
    try:
        if one_by_one:
            outs = []
            for p, kw in zip(prompts, kws):
                h = engine.submit(p, max_new_tokens=new, **kw)
                engine.start()
                outs.append(h.result(timeout=300))
        else:
            hs = [engine.submit(p, max_new_tokens=new, **kw)
                  for p, kw in zip(prompts, kws)]
            engine.start()
            outs = [h.result(timeout=300) for h in hs]
        st = engine.stats()
    finally:
        engine.shutdown()
    return outs, st


def _same(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")


def _both(jm, pm, prompts, one_by_one=False, **kw):
    base = dict(max_slots=3, max_len=64, max_queue=64, auto_start=False)
    base.update(kw)
    want, jst = _serve(JaxEngine(jm, **base), prompts, one_by_one=one_by_one)
    got, pst = _serve(Engine(pm, **base), prompts, one_by_one=one_by_one)
    _same(got, want)
    assert pst["decode_compiles"] == 1
    return jst, pst


# -- the surface -------------------------------------------------------------

def test_constructor_signature_equals_jax():
    """Names, order, kinds and defaults of ``Engine.__init__``'s
    parameters are the JAX package's."""
    def params(cls):
        return [(p.name, p.kind, p.default) for p in
                inspect.signature(cls.__init__).parameters.values()]

    assert params(Engine) == params(JaxEngine)
    sig = inspect.signature(Engine.__init__).parameters
    assert sig["paged_kv"].default is False
    assert sig["decode_kernel"].default == "xla"
    assert sig["sample_on_device"].default is True
    assert list(sig)[1:4] == ["model", "tokenizer", "max_slots"]


def test_slot_pool_cached_state_matches_jax():
    """``retain`` / ``release_cached`` / ``cached``: the JAX pool's
    bookkeeping on the same sequence of calls."""
    from paddle_tpu.serving.slot_pool import SlotPool as JaxSlotPool

    mine, theirs = SlotPool(3), JaxSlotPool(3)
    for pool in (mine, theirs):
        a, b = pool.alloc("a"), pool.alloc("b")
        assert pool.retain(a, "entry") == "a"
        assert pool.n_active == 1 and pool.n_cached == 1
        with pytest.raises(KeyError):
            pool.retain(a, "again")
        pool.alloc("c")
        assert pool.alloc("d") is None
        assert pool.release_cached(a) == "entry"
        with pytest.raises(KeyError):
            pool.release_cached(a)
        pool.free(b)
    assert repr(mine) == repr(theirs)
    assert (mine.cached(), mine.active(), mine.n_free) == \
        (theirs.cached(), theirs.active(), theirs.n_free)


# -- the dense pool ----------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["f32", "int8"])
def test_dense_pool_greedy_matches_jax(models, kv_dtype):
    jm, pm = models
    jst, pst = _both(jm, pm, _prompts(10), kv_dtype=kv_dtype)
    assert pst["completed"] == 10 and pst["slot_reuses"] > 0
    assert "kv_num_pages" not in pst and pst["cached_slots"] == 0
    # the dense rows (+ the spare column) in the model's dtype
    row = 64 * 2 * 4 * 32 * (1 if kv_dtype else 4) + \
        (64 * 2 * 4 if kv_dtype else 0)
    assert pst["kv_pool_bytes"] == 4 * 2 * row * 65 // 64


def test_dense_prefix_cache_matches_jax(models):
    """Retained rows: hits copy the cached row and prefill the tail; the
    hits, misses and inserts are the JAX engine's, and under slot pressure
    the LRU rows go back to the free list as in JAX."""
    jm, pm = models
    prompts = _shared(7)
    jst, pst = _both(jm, pm, prompts, one_by_one=True, prefix_cache=True)
    for key in ("prefix_hits", "prefix_misses", "prefix_inserts",
                "prefix_evictions", "cached_slots", "slot_reuses"):
        assert pst[key] == jst[key], key
    assert pst["prefix_hits"] >= 5 and pst["prefix_copy_compiles"] == 1
    # concurrent hits over a full pool of cached rows evict
    jst, pst = _both(jm, pm, prompts + _shared(5, seed=2), prefix_cache=True,
                     max_slots=2)
    for key in ("prefix_hits", "prefix_misses", "prefix_evictions"):
        assert pst[key] == jst[key], key


def test_dense_retained_row_survives_parked_writes(models):
    """A retained row parks at max_len: the decode steps of other lanes
    write its span onto the spare column, never onto the cached row."""
    _, pm = models
    eng = Engine(pm, max_slots=2, max_len=32, prefix_cache=True,
                 prefix_block=4)
    try:
        eng.submit(np.arange(1, 13), max_new_tokens=3).result(timeout=120)
        slot = next(iter(eng._pool.cached()))
        rows = [p[slot, :32].clone() for p in eng._kpools + eng._vpools]
        eng.submit(np.arange(40, 50), max_new_tokens=6).result(timeout=120)
        for before, p in zip(rows, eng._kpools + eng._vpools):
            assert torch.equal(p[slot, :32], before)
        assert eng.stats()["cached_slots"] == 2
    finally:
        eng.shutdown()
    assert eng.stats()["cached_slots"] == 0


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["f32", "int8"])
def test_dense_speculative_matches_jax(models, kv_dtype):
    jm, pm = models
    rs = np.random.RandomState(5)
    prompts = [np.tile(rs.randint(0, VOCAB, 4), 4) for _ in range(4)] + \
        _prompts(4, seed=6)
    jst, pst = _both(jm, pm, prompts, speculative_k=3, kv_dtype=kv_dtype)
    for key in ("spec_drafted", "spec_accepted", "decode_steps"):
        assert pst[key] == jst[key], key


# -- the paged pool's two reads ----------------------------------------------

@pytest.mark.parametrize("kernel", ["xla", "pallas"])
@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["f32", "int8"])
def test_paged_reads_match_jax(models, kernel, kv_dtype):
    jm, pm = models
    jst, pst = _both(jm, pm, _prompts(9, seed=8), paged_kv=True, page_size=8,
                     decode_kernel=kernel, kv_dtype=kv_dtype,
                     speculative_k=3)
    assert pst["decode_steps"] == jst["decode_steps"]


def test_paged_gather_read_launches_no_kernel(models, monkeypatch):
    """``decode_kernel="xla"`` never reaches the paged kernel's wrapper;
    ``"pallas"`` does for every decode step and tail prefill."""
    _, pm = models
    from paddle_tpu_torch.kernels import paged_attention as pa
    calls = []
    real = pa.paged_decode_attention
    monkeypatch.setattr(
        "paddle_tpu_torch.models.gpt.paged_decode_attention",
        lambda *a, **k: calls.append(1) or real(*a, **k))
    kw = dict(max_slots=2, max_len=48, paged_kv=True, page_size=8,
              prefix_cache=True, prefix_block=8)
    prompts = _shared(3)
    xla, _ = _serve(Engine(pm, decode_kernel="xla", **kw), prompts,
                    one_by_one=True)
    assert not calls
    pallas, _ = _serve(Engine(pm, decode_kernel="pallas", **kw), prompts,
                       one_by_one=True)
    assert calls
    _same(xla, pallas)


# -- MoE ---------------------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_moe_model_matches_jax(paged):
    """gpt-tiny with 4 experts on every 2nd layer (the GShard gate): every
    lane, parked ones too, routes through the capacity dispatch in both
    engines, and the greedy tokens are equal."""
    jm, pm = _pair(seed=11, moe_num_experts=4, moe_every_n_layers=2)
    kw = (dict(paged_kv=True, page_size=8, decode_kernel="pallas")
          if paged else {})
    _both(jm, pm, _prompts(8, seed=9), **kw)


# -- every flag composed -----------------------------------------------------

@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_all_flags_composed_one_decode_signature(models, paged):
    """The prefix cache, speculative_k, int8 pools, LoRA adapters and the
    device sampler on one engine: one decode signature, and the greedy
    rows' tokens equal the JAX engine's with the same flags."""
    jm, pm = models
    names = ["t0", None, "t1", None, "t0", None]
    prompts = _shared(6, seed=3)
    kw = dict(max_slots=3, max_len=64, max_queue=32, prefix_cache=True,
              speculative_k=3, kv_dtype="int8")
    if paged:
        kw.update(paged_kv=True, page_size=16)
    outs = []
    for E, reg_cls, mk, m in ((JaxEngine, JaxAdapterRegistry, jax_make_lora,
                               jm), (Engine, AdapterRegistry, make_lora, pm)):
        reg = reg_cls(m, max_resident=2, max_rank=8)
        for i, name in enumerate(("t0", "t1")):
            reg.register(mk(m.gpt.config, rank=2 + 2 * i, seed=10 + i,
                            name=name))
        eng = E(m, adapters=reg, **kw)
        try:
            hs = [eng.submit(p, max_new_tokens=6, adapter=n)
                  for p, n in zip(prompts, names)]
            outs.append([h.result(timeout=300) for h in hs])
            st = eng.stats()
        finally:
            eng.shutdown()
    _same(outs[1], outs[0])
    assert st["decode_compiles"] == 1 and st["adapter_hits"] + \
        st["adapter_loads"] == 3


# -- the device sampler ------------------------------------------------------

def test_device_sampler_greedy_equals_host_sampler(models):
    _, pm = models
    prompts = _prompts(8, seed=13)
    for kw in ({}, dict(paged_kv=True, page_size=8,
                        decode_kernel="pallas")):
        dev, _ = _serve(Engine(pm, max_slots=3, max_len=64, max_queue=16,
                               sample_on_device=True, **kw), prompts)
        host, _ = _serve(Engine(pm, max_slots=3, max_len=64, max_queue=16,
                                sample_on_device=False, **kw), prompts)
        _same(dev, host)


def _sampled(pm, prompts, seeds, **kw):
    kws = [dict(temperature=0.9, top_k=8, seed=s) for s in seeds]
    outs, st = _serve(Engine(pm, max_slots=3, max_len=64, max_queue=16,
                             **kw), prompts, kws=kws,
                      one_by_one=kw.get("prefix_cache", False))
    return outs, st


def test_device_sampler_reproducible_across_paths(models):
    """Sampled tokens are a function of (seed, position, logits): the same
    per seed, the same with and without drafts, with and without a prefix
    hit (the tail prefill samples the first token at the prompt's last
    position, as the cold prefill does), and on either pool."""
    _, pm = models
    prompts = _shared(5, seed=4)
    seeds = [3, 3, 9, 11, 12]
    base, _ = _sampled(pm, prompts, seeds)
    again, _ = _sampled(pm, prompts, seeds)
    _same(again, base)
    spec, st = _sampled(pm, prompts, seeds, speculative_k=3)
    _same(spec, base)
    hit, st = _sampled(pm, prompts, seeds, prefix_cache=True)
    assert st["prefix_hits"] >= 3
    _same(hit, base)
    paged, _ = _sampled(pm, prompts, seeds, paged_kv=True, page_size=8)
    _same(paged, base)
    other, _ = _sampled(pm, prompts, [s + 100 for s in seeds])
    assert any(not np.array_equal(a, b) for a, b in zip(other, base))
    # every draw lies in the top 8 of the no-cache forward
    for p, g in zip(prompts, base):
        with torch.no_grad():
            lg = pm(torch.from_numpy(np.concatenate([p, g[:-1]])[None]))[0]
        for j, tok in enumerate(g):
            assert tok in torch.topk(lg[len(p) - 1 + j], 8).indices


def test_device_sampler_fits_the_top_k_softmax():
    """4000 draws on fixed logits at temperature 0.9 and top-k 8, keyed by
    4000 positions of one seed and by 4000 seeds at one position: a
    chi-square test against the top-k softmax passes with p > 1e-3 and no
    masked token is ever drawn; temperature 0 is the argmax."""
    from scipy import stats

    V, n, T, K = 64, 4000, 0.9, 8
    logits = torch.from_numpy(
        np.random.RandomState(0).randn(V).astype(np.float32) * 2.0)
    top = torch.topk(logits, K).indices
    p = torch.softmax(logits[top].double() / T, dim=-1).numpy()
    p /= p.sum()
    for seeds, pos in ((torch.full((n,), 5), torch.arange(n)),
                       (torch.arange(n), torch.full((n,), 17))):
        draws = eng_mod._device_sample(
            logits.expand(n, V), torch.full((n,), T), torch.full((n,), K),
            seeds, pos)
        assert bool(torch.isin(draws, top).all())
        counts = np.array([(draws == t).sum().item() for t in top])
        assert stats.chisquare(counts, p * n).pvalue > 1e-3
    greedy = eng_mod._device_sample(
        logits.expand(4, V), torch.zeros(4), torch.full((4,), K),
        torch.arange(4), torch.arange(4))
    assert bool((greedy == logits.argmax()).all())


# -- the card ----------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(), dict(kv_dtype="int8", speculative_k=3, prefix_cache=True),
    dict(paged_kv=True, page_size=8),
    dict(paged_kv=True, page_size=8, decode_kernel="pallas")],
    ids=["dense", "dense-int8-spec-prefix", "paged-xla", "paged-pallas"])
def test_engine_defaults_on_card_match_cpu(cuda, models, kw):
    """The JAX defaults on the card (the dense pool, the device sampler in
    the captured decode graph) and the paged reads: greedy tokens equal
    the CPU engine's, sampled ones are reproducible, one capture."""
    _, pm = models
    card = build_gpt("gpt-tiny", device=cuda, max_position_embeddings=128)
    card.load_state_dict(pm.state_dict())
    prompts = _shared(6, seed=14)
    base = dict(max_slots=3, max_len=64, max_queue=16, **kw)
    one = base.get("prefix_cache", False)
    want, _ = _serve(Engine(pm, **base), prompts, one_by_one=one)
    got, st = _serve(Engine(card, **base), prompts, one_by_one=one)
    _same(got, want)
    assert st["decode_compiles"] == 1 and st["decode_graph_replays"] > 0
    kws = [dict(temperature=0.9, top_k=8, seed=i) for i in range(6)]
    a, _ = _serve(Engine(card, **base), prompts, kws=kws, one_by_one=one)
    b, _ = _serve(Engine(card, **base), prompts, kws=kws, one_by_one=one)
    _same(a, b)
