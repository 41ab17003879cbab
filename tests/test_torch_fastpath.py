"""The port's serving fast path against the JAX package's, on gpt-tiny.

The JAX side is ``Engine(paged_kv=True, decode_kernel="pallas")`` (its paged
kernel in Pallas interpret mode on the CPU) with the same flags; the port's
``Engine(paged_kv=True, decode_kernel="pallas")`` on a CPU model runs the
plain versions of its kernels. Covered: the port's copies of
``NgramDrafter`` and ``PrefixIndex``, prefix hits (zero-copy page sharing,
the copy-on-write boundary page, the tail prefill), speculative decoding,
every flag at once at one decode signature, the pools' bytes after the same
traffic, the spare page that takes the writes a page table cannot place, and
paged reads wider than the kernel's 8 queries as column groups. Greedy
tokens must be identical (f32 and int8 pools); pool bytes and the grouped
read agree to 1e-5.
"""
import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

import paddle_tpu as paddle
from paddle_tpu.kernels import paged_attention as jpa
from paddle_tpu.models import build_gpt as jax_build_gpt
from paddle_tpu.models import gpt_config as jax_gpt_config
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu.serving import NgramDrafter as JaxNgramDrafter
from paddle_tpu.serving import PrefixIndex as JaxPrefixIndex

from paddle_tpu_torch.kernels import layer_norm as ln
from paddle_tpu_torch.kernels import paged_attention as pa
from paddle_tpu_torch.models import build_gpt, load_jax_state
from paddle_tpu_torch.models.gpt import SPARE_PAGE, GPTSelfAttention
from paddle_tpu_torch.serving import Engine, NgramDrafter, PrefixIndex
from test_torch_cuda import _paged_case

# gpt-tiny shapes gain nothing from intra-op threads; one thread keeps
# these tests from crowding the timing-sensitive tests of other workers
torch.set_num_threads(1)

VOCAB = 1024


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


def _shared_prompts(n, shared_len=12, tail_len=3, seed=0):
    rs = np.random.RandomState(seed)
    shared = rs.randint(0, VOCAB, shared_len).astype(np.int64)
    return [np.concatenate([shared, rs.randint(0, VOCAB, tail_len)
                            .astype(np.int64)]) for _ in range(n)]


def _run(engine, prompts, new=6, shutdown=True, **kw):
    """Serve ``prompts`` one after another (each completes, and is
    retained by a prefix cache, before the next is admitted); the stats
    before shutdown, with the free pages after it."""
    try:
        outs = [engine.submit(p, max_new_tokens=new, **kw).result(timeout=300)
                for p in prompts]
        st = engine.stats()
    finally:
        if shutdown:
            engine.shutdown()
    if shutdown:
        st["pages_free_after_shutdown"] = engine.stats()["kv_pages_free"]
    return outs, st


def _jax(jm, **kw):
    return JaxEngine(jm, paged_kv=True, decode_kernel="pallas", **kw)


def _port(pm, **kw):
    return Engine(pm, paged_kv=True, decode_kernel="pallas",
                  sample_on_device=False, **kw)


def _assert_same(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")


# -- the host-side classes ---------------------------------------------------

@pytest.mark.parametrize("ngram", [(3, 1), (2, 2), (4, 1)])
def test_ngram_drafter_matches_jax(ngram):
    rs = np.random.RandomState(sum(ngram))
    contexts = [rs.randint(0, 6, n).astype(np.int64) for n in
                (1, 2, 3, 5, 9, 17, 40)]
    contexts += [np.tile(rs.randint(0, 50, 4), 5), np.arange(12) % 5]
    mine, theirs = NgramDrafter(*ngram), JaxNgramDrafter(*ngram)
    for ctx in contexts:
        for n in (0, 1, 3, 7):
            np.testing.assert_array_equal(mine(ctx, n), theirs(ctx, n))
    with pytest.raises(ValueError, match="min_ngram"):
        NgramDrafter(1, 2)


def test_prefix_index_matches_jax():
    """The same seeded insert / lookup / acquire / evict sequence on both
    indexes gives the same hits, matches, entries and counters."""
    rs = np.random.RandomState(4)
    base = rs.randint(0, 9, 40)
    mine, theirs = PrefixIndex(block=4), JaxPrefixIndex(block=4)
    ids = {}                     # (tokens) -> (my entry, their entry)

    def key(hit):
        return None if hit is None else (hit[0].tokens, hit[1])

    for step in range(120):
        op = rs.randint(5)
        toks = base[:rs.randint(1, 40)].tolist()
        if rs.rand() < 0.3:
            toks = toks + rs.randint(0, 9, rs.randint(1, 6)).tolist()
        if op == 0:
            a = mine.insert(None, toks, pages=list(range(len(toks) // 4)))
            b = theirs.insert(None, toks, pages=list(range(len(toks) // 4)))
            assert (a is None) == (b is None)
            if a is not None:
                ids[a.tokens] = (a, b)
        elif op in (1, 2):
            peek = op == 2
            assert key(mine.lookup(toks, peek=peek)) == \
                key(theirs.lookup(toks, peek=peek))
        elif op == 3 and ids:
            a, b = ids[sorted(ids)[rs.randint(len(ids))]]
            if rs.rand() < 0.5:
                mine.acquire(a), theirs.acquire(b)
            else:
                mine.release(a), theirs.release(b)
        else:
            want = rs.randint(1, 3)
            ea, eb = mine.evict_lru(want), theirs.evict_lru(want)
            assert [e.tokens for e in ea] == [e.tokens for e in eb]
            for e in ea:
                ids.pop(e.tokens, None)
        assert mine.stats() == theirs.stats(), step
    assert len(mine) == len(theirs) and mine.n_cached_tokens == \
        theirs.n_cached_tokens
    assert [e.tokens for e in mine.drop_all()] == \
        [e.tokens for e in theirs.drop_all()]


# -- prefix cache ------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["f32", "int8"])
def test_prefix_hits_match_jax_and_cold(models, kv_dtype):
    """Shared-prompt traffic: tails prefilled over shared pages give the
    JAX engine's tokens and the port's cold engine's; with block == page
    every shared page is whole (zero copy)."""
    jm, pm = models
    prompts = _shared_prompts(5, shared_len=12, tail_len=5, seed=5)
    kw = dict(max_slots=3, max_len=64, kv_dtype=kv_dtype, prefix_cache=True,
              prefix_block=4)
    want, jst = _run(_jax(jm, **kw), prompts)
    got, st = _run(_port(pm, **kw), prompts)
    cold, _ = _run(_port(pm, max_slots=3, max_len=64, kv_dtype=kv_dtype),
                   prompts)
    _assert_same(got, want)
    _assert_same(got, cold)
    assert st["prefix_hits"] == jst["prefix_hits"] >= 3
    assert st["prefix_inserts"] == jst["prefix_inserts"]
    assert st["page_cow_copies"] == 0 and st["prefix_copy_compiles"] == 0
    assert st["tail_prefill_compiles"] >= 1
    assert st["kv_page_size"] == 4              # page_size defaults to block
    assert st["kv_pages_cached"] > 0
    assert st["pages_free_after_shutdown"] == st["kv_num_pages"]


def test_cow_boundary_page(models):
    """block=4, page=8: a hit at 12 shares page 0 whole and page 1 in
    part; exactly one page is cloned and the writer diverges on it, while
    the cached entry's pages stay byte-identical."""
    jm, pm = models
    rs = np.random.RandomState(3)
    shared = rs.randint(0, VOCAB, 13).astype(np.int64)
    p2 = np.concatenate([shared[:12], rs.randint(0, VOCAB, 4)
                         .astype(np.int64)])
    kw = dict(max_slots=3, max_len=64, prefix_cache=True, prefix_block=4,
              page_size=8)
    eng = _port(pm, **kw)
    try:
        eng.submit(shared, max_new_tokens=4).result(timeout=300)
        entry = next(iter(eng._prefix._entries.values()))
        idx = torch.tensor(entry.pages)
        before = [p[idx].clone() for p in eng._kpools + eng._vpools]
        h = eng.submit(p2, max_new_tokens=4)
        out = h.result(timeout=300)
        for i, p in enumerate(eng._kpools + eng._vpools):
            assert torch.equal(p[idx], before[i]), f"reader pool {i} changed"
        st = eng.stats()
    finally:
        eng.shutdown()
    assert h.prefix_hit and h._prefix_match == 12
    assert st["page_cow_copies"] == 1 and st["prefix_copy_compiles"] == 1
    want, _ = _run(_jax(jm, **kw), [shared, p2], new=4)
    cold, _ = _run(_port(pm, max_slots=2, max_len=64), [p2], new=4)
    np.testing.assert_array_equal(out, want[1])
    np.testing.assert_array_equal(out, cold[0])


def test_pages_return_at_refcount_zero(models):
    """An entry evicted from the index while a running request shares
    its pages: the pages go back to the free list only when that request
    drops the last reference; nothing leaks by shutdown."""
    _, pm = models
    rs = np.random.RandomState(6)
    shared = rs.randint(0, VOCAB, 8).astype(np.int64)
    eng = _port(pm, max_slots=2, max_len=32, prefix_cache=True,
                prefix_block=4, page_size=4, num_pages=8, prefill_batch=1,
                auto_start=False)
    eng.start()
    eng.submit(shared, max_new_tokens=2).result(timeout=300)
    entry = next(iter(eng._prefix._entries.values()))
    assert eng.stats()["kv_pages_cached"] == len(entry.pages) == 3
    long_req = eng.submit(np.concatenate([shared, [5, 9]]),
                          max_new_tokens=14)
    other = eng.submit(rs.randint(0, VOCAB, 9).astype(np.int64),
                       max_new_tokens=4)
    long_out = long_req.result(timeout=300)
    other.result(timeout=300)
    st = eng.stats()
    alloc = eng._page_alloc
    alloc.check()
    eng.shutdown()
    assert long_req.prefix_hit and st["prefix_evictions"] >= 1
    assert st["completed"] == 3
    assert eng.stats()["kv_pages_free"] == eng.stats()["kv_num_pages"]
    assert all(alloc.refs(p) == 0 for p in range(alloc.num_pages))
    cold, _ = _run(_port(pm, max_slots=2, max_len=32),
                   [np.concatenate([shared, [5, 9]])], new=14)
    np.testing.assert_array_equal(long_out, cold[0])


# -- speculative decoding ----------------------------------------------------

@pytest.mark.parametrize("k", [3, 4])
def test_speculative_matches_jax_and_plain(models, k):
    """Greedy tokens of the k-wide verify equal the JAX engine's and the
    plain engine's, also when EOS or the budget lands inside an accepted
    run; the step emits more than one token on average."""
    jm, pm = models
    rs = np.random.RandomState(2)
    prompts = [rs.randint(0, VOCAB, n).astype(np.int64) for n in (6, 4, 9)]
    kw = dict(max_slots=3, max_len=64)
    base, pst = _run(_port(pm, **kw), prompts, new=10)
    eos = int(base[0][len(base[0]) // 2])
    got, st = _run(_port(pm, speculative_k=k, **kw), prompts, new=10)
    want, _ = _run(_jax(jm, speculative_k=k, **kw), prompts, new=10)
    _assert_same(got, want)
    _assert_same(got, base)
    assert st["spec_drafted"] > 0 and st["spec_accepted"] > 0
    assert st["decode_steps"] < pst["decode_steps"]
    assert st["decode_compiles"] == 1
    # EOS mid-run: stop exactly where the plain path stops
    got, _ = _run(_port(pm, speculative_k=k, **kw), prompts, new=9,
                  eos_token_id=eos)
    want, _ = _run(_jax(jm, speculative_k=k, **kw), prompts, new=9,
                   eos_token_id=eos)
    _assert_same(got, want)
    for b, g in zip(base, got):
        w = list(b[:9])
        np.testing.assert_array_equal(
            g, w[:w.index(eos) + 1] if eos in w else w)


def test_speculative_sampled_rows_take_one_token_a_step(models):
    """A sampled row rides the k-wide verify with no drafts: one token a
    step, the same draws as a plain engine's with the same seed."""
    _, pm = models
    p = np.arange(3, 11).astype(np.int64)
    kw = dict(new=8, temperature=0.9, top_k=8, seed=11)
    plain, _ = _run(_port(pm, max_slots=2, max_len=64), [p], **kw)
    spec, st = _run(_port(pm, max_slots=2, max_len=64, speculative_k=4),
                    [p], **kw)
    np.testing.assert_array_equal(spec[0], plain[0])
    assert st["spec_drafted"] == 0 and st["decode_steps"] == 7


# -- every flag at once ------------------------------------------------------

def test_all_flags_one_decode_signature(models):
    """Paged + prefix cache (block 4) + speculative_k=3 + int8: the
    int8-only engine's tokens, and the JAX all-flags engine's, at one
    decode signature, with zero-copy hits."""
    jm, pm = models
    prompts = _shared_prompts(5, seed=9)
    base, _ = _run(_port(pm, max_slots=4, max_len=64, kv_dtype="int8"),
                   prompts)
    kw = dict(max_slots=4, max_len=64, prefix_cache=True, prefix_block=4,
              speculative_k=3, kv_dtype="int8")
    got, st = _run(_port(pm, **kw), prompts)
    want, jst = _run(_jax(jm, **kw), prompts)
    _assert_same(got, base)
    _assert_same(got, want)
    assert st["decode_compiles"] == jst["decode_compiles"] == 1
    assert st["prefix_hits"] >= 3 and st["prefix_inserts"] >= 1
    assert st["spec_drafted"] > 0 and st["page_cow_copies"] == 0
    assert st["decode_graph_replays"] == 0          # no graph on the CPU


def test_layernorm_routing_is_a_new_decode_signature(models):
    """The decode signature holds the LayerNorm routing: turning the
    fused LayerNorm on mid-life adds one signature, with the same greedy
    tokens."""
    _, pm = models
    prompts = _shared_prompts(2, seed=1)
    eng = _port(pm, max_slots=2, max_len=64)
    try:
        first, _ = _run(eng, prompts[:1], shutdown=False)
        assert eng.compile_stats()["decode_compiles"] == 1
        ln.enable_fused_layernorm("full")
        second, st = _run(eng, prompts[:1], shutdown=False)
    finally:
        ln.enable_fused_layernorm("off")
        eng.shutdown()
    _assert_same(second, first)
    assert st["decode_compiles"] == 2 and st["prefill_compiles"] == 1


# -- the pools and the spare page ---------------------------------------------

def test_pools_match_jax_after_traffic(models):
    """After the same prefix + speculative traffic every page the
    allocator hands out holds the JAX engine's bytes (1e-5, f32): the
    writes the JAX scatter drops land on the port's spare page, never on
    a page of the pool."""
    jm, pm = models
    prompts = _shared_prompts(4, shared_len=13, tail_len=4, seed=12)
    kw = dict(max_slots=3, max_len=48, prefix_cache=True, prefix_block=4,
              page_size=8, speculative_k=3)
    jeng, peng = _jax(jm, **kw), _port(pm, **kw)
    want, _ = _run(jeng, prompts, shutdown=False)
    got, st = _run(peng, prompts, shutdown=False)
    try:
        _assert_same(got, want)
        NP = st["kv_num_pages"]
        assert st["page_cow_copies"] >= 1 and st["prefix_hits"] >= 2
        jk, jv = jeng._pools[0], jeng._pools[1]
        for i in range(len(jk)):
            for mine, theirs in ((peng._kpools[i], jk[i]),
                                 (peng._vpools[i], jv[i])):
                assert mine.shape[0] == NP + 1       # + the spare page
                np.testing.assert_allclose(mine[:NP].numpy(),
                                           np.asarray(theirs), rtol=1e-5,
                                           atol=1e-5)
    finally:
        jeng.shutdown()
        peng.shutdown()


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_spare_page_takes_only_unplaceable_writes(quant):
    """The paged write in the spare-page form against the dropping form:
    the same output on live rows and the same mappable pages; the spare
    page is written only by sentinel, off-table and parked positions."""
    rs = np.random.RandomState(quant)
    B, t, H, D, P, n_pt, NP = 4, 3, 2, 8, 4, 4, 9
    q, k, v = (torch.from_numpy(rs.randn(B, t, H, D).astype(np.float32))
               for _ in range(3))
    pt = np.full((B, n_pt), NP, np.int32)
    pt[0, :2] = [3, 5]          # live, the span within its pages
    pt[1, :1] = [7]             # the span runs past its last page
    pt[2] = [0, 1, 2, 4]        # the span runs past the table
    starts = np.array([2, 2, 14, n_pt * P], np.int32)    # row 3 parked

    def pools():
        g = torch.Generator().manual_seed(1)
        if quant:
            kv = [torch.randint(-127, 128, (NP + 1, P, H, D), generator=g)
                  .to(torch.int8) for _ in range(2)]
            sc = [torch.rand(NP + 1, P, generator=g) + 0.1
                  for _ in range(2)]
            return kv + sc
        return [torch.randn(NP + 1, P, H, D, generator=g) for _ in range(2)]

    def run(rows, spare):
        ps = pools()
        before = [p[NP].clone() for p in ps]
        keep = [p if spare else p[:NP] for p in ps]
        cache = (keep[0], keep[1], torch.from_numpy(starts[rows]),
                 torch.from_numpy(pt[rows])) + tuple(keep[2:])
        if spare:
            cache = cache + (SPARE_PAGE,)
        out, new = GPTSelfAttention._paged(q[rows], k[rows], v[rows], cache)
        assert (new[-1] is SPARE_PAGE) == spare and torch.equal(
            new[2], torch.from_numpy(starts[rows] + t))
        changed = any(not torch.equal(p[NP], b) for p, b in zip(ps, before))
        return out, [p[:NP] for p in ps], changed

    rows = [0, 1, 2, 3]
    out_s, pools_s, spare_written = run(rows, True)
    out_d, pools_d, _ = run(rows, False)
    torch.testing.assert_close(out_s[:3], out_d[:3], rtol=0, atol=0)
    for a, b in zip(pools_s, pools_d):
        assert torch.equal(a, b)
    assert spare_written
    # every position placeable: the spare page is not touched
    assert not run([0], True)[2]


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("W", [12, 16, 24])
def test_grouped_wide_read_matches_jax(W, quant):
    """A read wider than the kernel's 8 queries, as column groups of at
    most 8 (the card's route), against the JAX kernel in interpret mode
    at the whole width; the cost is the groups' sum."""
    q, kp, vp, pt, lengths, ks, vs = _paged_case(
        W, quant, [0, 5, 8, 13, 30, 64], n_pt=8, P=8, seed=W)
    want = np.asarray(jpa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pt),
        jnp.asarray(lengths),
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs)))
    t = [None if x is None else torch.from_numpy(x)
         for x in (q, kp, vp, pt, lengths, ks, vs)]
    got = pa.paged_by_groups(pa.paged_decode_attention_plain, *t).numpy()
    live = lengths < pt.shape[1] * kp.shape[1]
    np.testing.assert_allclose(got[live], want[live], rtol=1e-5, atol=1e-5)
    groups = pa.paged_groups(W)
    assert [w for _, w in groups] == [8] * (W // 8) + (
        [W % 8] if W % 8 else [])
    cost = pa.paged_cost(lengths, W, 2, 32, 8, 8, quant)
    parts = [pa.paged_cost(lengths + g, w, 2, 32, 8, 8, quant)
             for g, w in groups]
    assert cost == tuple(map(sum, zip(*parts)))
