"""The port's GPT cache forms and ``HybridParallelInferenceHelper`` against
the JAX package's, on gpt-tiny (f32, the same weights through
``load_jax_state``).

Covered: every cache form of JAX's ``GPTSelfAttention`` step by step —
``use_cache=True`` without caches, the growing-concat 2-tuple, the static
cache with a scalar (0-d tensor) length, the dense per-slot 3-tuple with
``[B]`` lengths (a parked row and a span running off the end included) and
its int8 5-tuple, and the paged 4-tuple through the gather read; the
spare-column form the serving engine uses against the filtered one; then
the helper (the JAX test file's specs: greedy against the no-cache loop,
EOS, seeded sampling, the model's mode restored, the numpy sampler) and
``GPTForPretraining.generate``.  Logits agree to 1e-5 (int8: 1e-3);
greedy tokens are equal bitwise.  The card twins carry the ``cuda``
marker.
"""
import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor as JaxTensor
from paddle_tpu.distributed.fleet.utils import \
    HybridParallelInferenceHelper as JaxHelper
from paddle_tpu.models import build_gpt as jax_build_gpt
from paddle_tpu.models import gpt_config as jax_gpt_config

from paddle_tpu_torch.distributed.fleet.utils import \
    HybridParallelInferenceHelper
from paddle_tpu_torch.distributed.fleet.utils import \
    hybrid_parallel_inference as hpi
from paddle_tpu_torch.kernels.paged_attention import SPARE_PAGE, gather_read
from paddle_tpu_torch.models import build_gpt, load_jax_state
from test_torch_cuda import cuda  # noqa: F401  (the card fixture)

torch.set_num_threads(1)

VOCAB, H, D, LAYERS = 1024, 4, 32, 2


@pytest.fixture(scope="module")
def models():
    cfg = jax_gpt_config("gpt-tiny", max_position_embeddings=128,
                         hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    paddle.seed(7)
    jm = jax_build_gpt(cfg)
    jm.eval()
    pm = build_gpt("gpt-tiny", device="cpu", max_position_embeddings=128,
                   hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    load_jax_state(pm, {k: np.asarray(v._value)
                        for k, v in jm.state_dict().items()})
    return jm, pm


def _jt(x):
    return JaxTensor(jnp.asarray(x), _internal=True)


def _j(x):
    return np.asarray(x._value if isinstance(x, JaxTensor) else x)


def _both(jm, pm, ids, jcaches, pcaches):
    """One cached forward on each side: (JAX logits, JAX caches, port
    logits, port caches)."""
    lj, cj = jm(paddle.to_tensor(ids), caches=jcaches, use_cache=True)
    with torch.no_grad():
        lp, cp = pm(torch.from_numpy(ids), caches=pcaches, use_cache=True)
    return _j(lj), cj, lp.numpy(), cp


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _ids(b, t, seed):
    return np.random.RandomState(seed).randint(0, VOCAB, (b, t)) \
        .astype(np.int64)


# -- the cache forms ---------------------------------------------------------

def test_use_cache_without_caches_and_growing_concat_match_jax(models):
    jm, pm = models
    wj, cj, wp, cp = _both(jm, pm, _ids(2, 6, 0), None, None)
    _close(wp, wj)
    assert all(len(c) == 2 for c in cp)
    for k, v in cp:
        assert k.shape == (2, 6, H, D)
    for step in range(3):
        nxt = wj[:, -1].argmax(-1)[:, None].astype(np.int64)
        np.testing.assert_array_equal(nxt[:, 0], wp[:, -1].argmax(-1))
        wj, cj, wp, cp = _both(jm, pm, nxt, cj, cp)
        _close(wp, wj)
        assert cp[0][0].shape[1] == 7 + step


@pytest.mark.parametrize("as_tensor", [True, False],
                         ids=["tensor_length", "int_length"])
def test_static_cache_scalar_length_matches_jax(models, as_tensor):
    """The helper's cache: a static prefill with the Python 0, then steps
    whose length is a 0-d tensor (or a Python int): logits each step and
    the buffers at the end agree."""
    jm, pm = models
    B, T, L = 2, 5, 12
    zeros = np.zeros((B, L, H, D), np.float32)
    jc = [(_jt(zeros), _jt(zeros), 0) for _ in range(LAYERS)]
    pc = [(torch.zeros(B, L, H, D), torch.zeros(B, L, H, D), 0)
          for _ in range(LAYERS)]
    wj, jc, wp, pc = _both(jm, pm, _ids(B, T, 1), jc, pc)
    _close(wp, wj)
    for step in range(4):
        nxt = wj[:, -1].argmax(-1)[:, None].astype(np.int64)
        np.testing.assert_array_equal(nxt[:, 0], wp[:, -1].argmax(-1))
        jc = [(k, v, jnp.asarray(ln, jnp.int32)) for k, v, ln in jc]
        pc = [(k, v, torch.tensor(int(ln), dtype=torch.int32) if as_tensor
               else int(ln)) for k, v, ln in pc]
        wj, jc, wp, pc = _both(jm, pm, nxt, jc, pc)
        _close(wp, wj)
    assert int(pc[0][2]) == int(jc[0][2]) == T + 4
    for (jk, jv, _), (pk, pv, _) in zip(jc, pc):
        _close(pk.numpy(), _j(jk))
        _close(pv.numpy(), _j(jv))


def _slot_inputs(L, quant, seed=3):
    """A per-slot pool state: random buffers (int8 with scales), row 0 at
    length 2, row 1 two short of the end (its span of 3 runs off it), row
    2 parked at ``L``."""
    rs = np.random.RandomState(seed)
    lens = np.array([2, L - 2, L], np.int32)
    if quant:
        bufs = [rs.randint(-127, 128, (3, L, H, D)).astype(np.int8)
                for _ in range(2)]
        scales = [(rs.rand(3, L).astype(np.float32) + 0.5) * 0.01
                  for _ in range(2)]
        return lens, bufs + scales
    return lens, [rs.randn(3, L, H, D).astype(np.float32) * 0.3
                  for _ in range(2)]


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_dense_per_slot_cache_matches_jax(models, quant):
    """The serving engine's dense per-slot 3-tuple (and its int8 5-tuple)
    with a span of 3 (a verify step): the writes past a row's end drop in
    both, and the logits and pools agree (f32 1e-5; int8: greedy tokens
    equal, logits within 1e-3)."""
    jm, pm = models
    L = 16
    lens, arrs = _slot_inputs(L, quant)
    ids = _ids(3, 3, 4)

    def tup(conv, ln, xs):
        out = (conv(xs[0]), conv(xs[1]), ln)
        return out + ((conv(xs[2]), conv(xs[3])) if quant else ())

    jc = [tup(_jt, jnp.asarray(lens), arrs) for _ in range(LAYERS)]
    pc = [tup(lambda a: torch.from_numpy(a.copy()), torch.from_numpy(lens),
              arrs) for _ in range(LAYERS)]
    wj, jc, wp, pc = _both(jm, pm, ids, jc, pc)
    tol = 1e-3 if quant else 1e-5
    _close(wp, wj, tol)
    np.testing.assert_array_equal(wp.argmax(-1), wj.argmax(-1))
    for jt, pt in zip(jc, pc):
        np.testing.assert_array_equal(pt[2].numpy(), _j(jt[2]))
        for j, p in zip(jt[:2] + jt[3:], pt[:2] + pt[3:]):
            if p.dtype == torch.int8:
                # the new rows' int8 values may round one step apart
                assert np.abs(p.numpy().astype(np.int32)
                              - _j(j).astype(np.int32)).max() <= 1
            else:
                _close(p.numpy(), _j(j))


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_spare_column_equals_the_dropping_write(models, quant):
    """The engine's form: buffers with one spare column and the tuple
    ending in SPARE_PAGE.  The readable columns and the logits equal the
    dropping form's exactly; the off-the-end writes land on the spare."""
    _, pm = models
    L = 16
    lens, arrs = _slot_inputs(L, quant)
    ids = torch.from_numpy(_ids(3, 3, 5))

    def caches(spare):
        out = []
        for _ in range(LAYERS):
            xs = [torch.from_numpy(np.concatenate(
                [a, np.zeros_like(a[:, :1])], axis=1) if spare else a.copy())
                for a in arrs]
            t = (xs[0], xs[1], torch.from_numpy(lens))
            t = t + ((xs[2], xs[3]) if quant else ())
            out.append(t + ((SPARE_PAGE,) if spare else ()))
        return out

    with torch.no_grad():
        want, wc = pm(ids, caches=caches(False))
        got, gc = pm(ids, caches=caches(True))
    assert torch.equal(got, want)
    for w, g in zip(wc, gc):
        assert g[-1] is SPARE_PAGE
        for a, b in zip(w[:2] + w[3:5], g[:2] + g[3:5]):
            assert torch.equal(b[:, :L], a)
        # row 1's position L and the parked row's span hit the spare
        assert g[0][1, L].abs().sum() > 0 and g[0][2, L].abs().sum() > 0


def test_paged_gather_read_matches_jax_xla_read(models):
    """The paged 4-tuple read by gathering the row's pages
    (``decode_kernel="xla"``) against the JAX model's XLA read."""
    jm, pm = models
    rs = np.random.RandomState(6)
    NP, P, n_pt = 10, 4, 4
    pools = [rs.randn(NP, P, H, D).astype(np.float32) * 0.3
             for _ in range(2)]
    tables = np.array([[3, 1, 7, NP], [0, 2, NP, NP], [NP] * 4], np.int32)
    lens = np.array([9, 6, n_pt * P], np.int32)
    ids = _ids(3, 2, 7)
    jc = [(_jt(pools[0]), _jt(pools[1]), jnp.asarray(lens),
           jnp.asarray(tables)) for _ in range(LAYERS)]
    pc = [(torch.from_numpy(pools[0].copy()), torch.from_numpy(
        pools[1].copy()), torch.from_numpy(lens), torch.from_numpy(tables))
        for _ in range(LAYERS)]
    with gather_read():
        wj, _, wp, _ = _both(jm, pm, ids, jc, pc)
    _close(wp[:2], wj[:2])


# -- the helper --------------------------------------------------------------

def _greedy_no_cache(model, ids, n_new):
    ids = np.asarray(ids, np.int64)
    for _ in range(n_new):
        with torch.no_grad():
            logits = model(torch.from_numpy(ids))
        nxt = logits[:, -1].argmax(-1).numpy()
        ids = np.concatenate([ids, nxt[:, None]], axis=1)
    return ids


def test_cached_generate_matches_full_forward_and_jax(models):
    jm, pm = models
    prompt = np.array([[5, 17, 3], [2, 9, 11]], np.int64)
    got = HybridParallelInferenceHelper(pm, max_length=6).generate(
        prompt, max_new_tokens=6)
    np.testing.assert_array_equal(got, _greedy_no_cache(pm, prompt, 6))
    np.testing.assert_array_equal(
        got, JaxHelper(jm, max_length=6).generate(prompt, max_new_tokens=6))
    rand = _ids(3, 9, 8)
    np.testing.assert_array_equal(
        HybridParallelInferenceHelper(pm).generate(rand, max_new_tokens=7),
        JaxHelper(jm).generate(rand, max_new_tokens=7))


def test_eos_stops_generation(models):
    jm, pm = models
    helper = HybridParallelInferenceHelper(pm)
    prompt = np.array([[1, 2]], np.int64)
    ref = helper.generate(prompt, max_new_tokens=4)
    eos = int(ref[0, 2])              # first generated token as eos
    out = helper.generate(prompt, max_new_tokens=4, eos_token_id=eos)
    assert out.shape[1] <= ref.shape[1]
    assert (out[0, 2:] == eos).all()
    np.testing.assert_array_equal(
        out, JaxHelper(jm).generate(prompt, max_new_tokens=4,
                                    eos_token_id=eos))
    # a batch where one row stops early: the rest keep going, the stopped
    # row is padded with eos, as in JAX
    two = np.array([[1, 2], [7, 8]], np.int64)
    np.testing.assert_array_equal(
        helper.generate(two, max_new_tokens=5, eos_token_id=eos),
        JaxHelper(jm).generate(two, max_new_tokens=5, eos_token_id=eos))


def test_sampling_respects_top_k(models):
    _, pm = models
    helper = HybridParallelInferenceHelper(pm)
    prompt = np.array([[4, 8, 15]], np.int64)
    a = helper.generate(prompt, max_new_tokens=5, temperature=1.0,
                        top_k=4, seed=1)
    b = helper.generate(prompt, max_new_tokens=5, temperature=1.0,
                        top_k=4, seed=1)
    np.testing.assert_array_equal(a, b)   # seeded: deterministic
    assert a.shape == (1, 8)
    with torch.no_grad():
        logits = pm(torch.from_numpy(a[:, :-1]))[0].numpy()
    for j in range(5):
        assert a[0, 3 + j] in np.argsort(logits[2 + j])[-4:]


def test_model_mode_restored(models):
    _, pm = models
    pm.train()
    try:
        HybridParallelInferenceHelper(pm).generate(
            np.array([[1]], np.int64), max_new_tokens=1)
        assert pm.training
    finally:
        pm.eval()


def test_sample_helper_matches_jax():
    """The numpy sampler: greedy argmax at temperature 0, top-k masking,
    and JAX's draws on the same logits and ``RandomState``."""
    logits = np.array([[0.1, 3.0, 0.2, 2.9], [5.0, 0.0, 0.0, 0.0]],
                      np.float32)
    rng = np.random.RandomState(0)
    greedy = HybridParallelInferenceHelper._sample(logits, 0.0, 0, rng)
    np.testing.assert_array_equal(greedy, [1, 0])
    for _ in range(20):
        s = HybridParallelInferenceHelper._sample(logits, 1.0, 2, rng)
        assert s[0] in (1, 3)
    s = HybridParallelInferenceHelper._sample(logits, 1.0, 1, rng)
    np.testing.assert_array_equal(s, [1, 0])
    wide = np.random.RandomState(1).randn(6, 50).astype(np.float32)
    for temp, k in ((0.7, 0), (1.3, 5), (1.0, 1)):
        mine, theirs = np.random.RandomState(9), np.random.RandomState(9)
        for _ in range(10):
            np.testing.assert_array_equal(
                HybridParallelInferenceHelper._sample(
                    torch.from_numpy(wide), temp, k, mine),
                JaxHelper._sample(jnp.asarray(wide), temp, k, theirs))


def test_one_build_per_key(models):
    """The retrace twin books one build (a graph capture on the card) per
    (batch, prompt, total length, dtype) key, whatever the calls."""
    _, pm = models
    helper = HybridParallelInferenceHelper(pm)
    ids = _ids(2, 4, 9)
    for _ in range(3):
        helper.generate(ids, max_new_tokens=3)
    helper.generate(ids, max_new_tokens=3, temperature=0.8, top_k=5)
    assert len(helper._make._signatures) == 1
    helper.generate(ids, max_new_tokens=4)
    helper.generate(ids[:1], max_new_tokens=3)
    assert len(helper._make._signatures) == 3
    assert hpi.STEP_NAME == "hybrid_parallel_inference.step"


def test_pretraining_generate_matches_jax(models):
    """``GPTForPretraining.generate`` over the engine: greedy ids equal the
    JAX model's, with and without an eos (rows padded with it)."""
    jm, pm = models
    ids = _ids(3, 6, 10)
    np.testing.assert_array_equal(
        pm.generate(ids, max_new_tokens=5),
        jm.generate(ids, max_new_tokens=5))
    eos = int(pm.generate(ids[:1], max_new_tokens=2)[0, -1])
    np.testing.assert_array_equal(
        pm.generate(ids, max_new_tokens=6, eos_token_id=eos, max_slots=2),
        jm.generate(ids, max_new_tokens=6, eos_token_id=eos, max_slots=2))


# -- the card ----------------------------------------------------------------

@pytest.mark.cuda
def test_helper_on_card_matches_cpu(cuda, models):
    """On the card: greedy ids equal the CPU helper's, one capture per key
    over repeated calls, and the greedy loop (prefill and replays) makes
    no host sync."""
    _, pm = models
    card = build_gpt("gpt-tiny", device=cuda, max_position_embeddings=128,
                     hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    card.load_state_dict(pm.state_dict())
    ids = _ids(3, 7, 11)
    want = HybridParallelInferenceHelper(pm).generate(ids, max_new_tokens=9)
    helper = HybridParallelInferenceHelper(card)
    np.testing.assert_array_equal(helper.generate(ids, max_new_tokens=9),
                                  want)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = helper.generate(ids, max_new_tokens=9)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    np.testing.assert_array_equal(got, want)
    assert len(helper._make._signatures) == 1
    sampled = helper.generate(ids, max_new_tokens=4, temperature=0.9,
                              top_k=8, seed=2)
    np.testing.assert_array_equal(
        sampled, helper.generate(ids, max_new_tokens=4, temperature=0.9,
                                 top_k=8, seed=2))
