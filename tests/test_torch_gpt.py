"""The port's GPT against the JAX package's, on gpt-tiny.

Weights move from the JAX model to the port as numpy arrays
(``models/convert.py``); inputs are numpy arrays from a seeded
``RandomState``.  Logits agree within atol 1e-4 (f32 on both sides,
summed in another order): the no-cache forward, the static prefill, and
four paged decode steps through the same 4-tuple (f32) and 6-tuple
(int8) caches, including a parked row whose writes must drop.
"""
import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

import paddle_tpu as paddle
from paddle_tpu.models import build_gpt as jax_build_gpt
from paddle_tpu.models import gpt_config as jax_gpt_config
from paddle_tpu.serving.kv_quant import quantize_rows as jax_quantize_rows

from paddle_tpu_torch.models import build_gpt, load_jax_state, to_jax_state

ATOL = 1e-4

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
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    pm = build_gpt("gpt-tiny", device="cpu", max_position_embeddings=128)
    load_jax_state(pm, state)
    return jm, pm, state


def _jax_logits(jm, ids, caches=None):
    if caches is None:
        return np.asarray(jm(paddle.to_tensor(ids))._value), None
    lg, new = jm(paddle.to_tensor(ids), caches=caches, use_cache=True)
    return np.asarray(lg._value), new


def test_converter_round_trip(models):
    _, pm, state = models
    back = to_jax_state(pm)
    assert set(back) == set(state)
    for k, v in state.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_converter_permutes_role_major_and_rejects_bad_states(models):
    _, pm, state = models
    nh, hd = 4, 32
    role = dict(state)
    for i in range(2):
        pre = f"gpt.layers.{i}.self_attn."
        w, b = state[pre + "qkv_proj.weight"], state[pre + "qkv_proj.bias"]
        role[pre + "qkv_proj.weight"] = w.reshape(128, nh, 3, hd).transpose(
            0, 2, 1, 3).reshape(128, 3 * nh * hd)
        role[pre + "qkv_proj.bias"] = b.reshape(nh, 3, hd).transpose(
            1, 0, 2).reshape(-1)
        role[pre + "qkv_layout"] = np.asarray(1, np.int32)
    other = build_gpt("gpt-tiny", device="cpu", max_position_embeddings=128,
                      seed=1)
    load_jax_state(other, role)
    for k, v in to_jax_state(other).items():
        np.testing.assert_array_equal(v, state[k], err_msg=k)
    with pytest.raises(KeyError, match="missing"):
        load_jax_state(other, {k: v for k, v in state.items()
                               if "fc0" not in k})
    bad = dict(state)
    bad["gpt.final_norm.weight"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="final_norm"):
        load_jax_state(other, bad)


def test_no_cache_logits_match_jax(models):
    jm, pm, _ = models
    ids = np.random.RandomState(0).randint(0, 1024, (2, 19)).astype(np.int64)
    want, _ = _jax_logits(jm, ids)
    with torch.no_grad():
        got = pm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _pools_from_prefill(k_rows, v_rows, tables, P, NP, quant):
    """numpy pools holding each row's prefill K/V at its table pages."""
    H, D = k_rows[0].shape[1:]
    shape = (NP, P, H, D)
    kp = np.zeros(shape, np.int8 if quant else np.float32)
    vp = np.zeros_like(kp)
    ks = np.zeros((NP, P), np.float32)
    vs = np.zeros((NP, P), np.float32)
    for r, (kr, vr) in enumerate(zip(k_rows, v_rows)):
        if quant:
            kq, ksc = (np.asarray(a) for a in jax_quantize_rows(
                jnp.asarray(kr)))
            vq, vsc = (np.asarray(a) for a in jax_quantize_rows(
                jnp.asarray(vr)))
        for p in range(kr.shape[0]):
            pid, off = tables[r, p // P], p % P
            if quant:
                kp[pid, off], vp[pid, off] = kq[p], vq[p]
                ks[pid, off], vs[pid, off] = ksc[p], vsc[p]
            else:
                kp[pid, off], vp[pid, off] = kr[p], vr[p]
    return kp, vp, ks, vs


@pytest.mark.parametrize("quant", [False, True], ids=["paged4", "paged6"])
def test_prefill_then_paged_decode_matches_jax(models, quant):
    jm, pm, _ = models
    rs = np.random.RandomState(3)
    P, n_pt, L = 8, 4, 2
    lens = [5, 8, 13]
    B = len(lens) + 1                                 # + one parked row
    NP = B * n_pt + 2
    tables = np.full((B, n_pt), NP, np.int32)
    perm = rs.permutation(NP)
    for r in range(len(lens)):
        tables[r] = perm[r * n_pt:(r + 1) * n_pt]
    # static prefill of each live row on both sides
    k_rows = [[] for _ in range(L)]
    v_rows = [[] for _ in range(L)]
    for n in lens:
        ids = rs.randint(0, 1024, (1, n)).astype(np.int64)
        zeros = np.zeros((1, n, 4, 32), np.float32)
        want, jc = _jax_logits(jm, ids, [(jnp.asarray(zeros),
                                          jnp.asarray(zeros), 0)] * L)
        with torch.no_grad():
            got, pc = pm(torch.from_numpy(ids), caches=[
                (torch.zeros(1, n, 4, 32), torch.zeros(1, n, 4, 32), 0)
                for _ in range(L)])
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
        assert [c[2] for c in pc] == [n] * L
        for i in range(L):
            k_rows[i].append(np.asarray(jc[i][0]._value)[0])
            v_rows[i].append(np.asarray(jc[i][1]._value)[0])
    pools = [_pools_from_prefill(k_rows[i], v_rows[i], tables, P, NP, quant)
             for i in range(L)]
    lengths = np.array(lens + [n_pt * P], np.int32)

    def caches(mod, arrs, lengths):
        kp, vp, ks, vs = (mod(a) for a in arrs)
        c = (kp, vp, mod(lengths), mod(tables))
        return c + (ks, vs) if quant else c

    jcaches = [caches(jnp.asarray, p, lengths) for p in pools]
    pcaches = [caches(lambda a: torch.from_numpy(np.array(a)), p, lengths)
               for p in pools]
    for step in range(4):
        ids = rs.randint(0, 1024, (B, 1)).astype(np.int64)
        want, jnew = _jax_logits(jm, ids, jcaches)
        with torch.no_grad():
            got, pnew = pm(torch.from_numpy(ids), caches=pcaches)
        np.testing.assert_allclose(got.numpy()[:-1], want[:-1], atol=ATOL,
                                   rtol=0, err_msg=f"step {step}")
        jcaches = [tuple(x._value if hasattr(x, "_value") else x for x in c)
                   for c in jnew]
        pcaches = pnew
        np.testing.assert_array_equal(pnew[0][2].numpy(),
                                      np.asarray(jnew[0][2]))
    for jc, pc in zip(jcaches, pcaches):
        for j, (a, b) in enumerate(zip(jc, pc)):
            a, b = np.asarray(a), b.numpy()
            if a.dtype == np.int8:          # a rounding boundary may flip
                assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
            else:
                np.testing.assert_allclose(b, a, atol=ATOL, rtol=1e-5,
                                           err_msg=f"cache item {j}")
