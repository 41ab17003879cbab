"""The port's text-recognition slice against the JAX package, on the CPU:
``nn.MultiHeadAttention``, ``nn.LSTM``, ``F.ctc_loss`` / ``nn.CTCLoss``,
PP-OCRv3's ``SVTRRec``, ``CRNN``, ``CTCHeadLoss`` and
``ctc_greedy_decode`` (f32; the JAX side at
``jax_default_matmul_precision`` "highest", as ``tests/conftest.py``
sets it).  Weights go from the JAX layer or model to the port's through
``load_jax_state``.

* ``MultiHeadAttention``: self- and cross-attention with other ``kdim``
  / ``vdim``, a boolean and an additive mask, ``need_weights``, the
  ``Cache`` and ``StaticCache`` paths: outputs, weights and caches at
  1e-5 relative (1e-6 absolute), and the input gradients.
* ``LSTM``: one and two layers, forward and bidirectional, batch-first
  and time-major, with and without initial states: outputs and final
  states at 1e-5, and the input gradients.
* ``ctc_loss``: batch-first, time-major and T == N inputs, short input
  and label lengths, an empty label, an alignment that does not fit, the
  three reductions: values at 1e-5 and gradients on the logits at 1e-5
  (where the alignment fits; the JAX gradient of its -1e30 floor is not
  copied, see ``nn/functional/loss.py``).
* ``SVTRRec`` at the JAX test's size (``dims=(16, 32, 48)``,
  ``depths=(1, 2, 1)``, 4 heads, 2 x 3 x 32 x 64) and ``CRNN`` at its
  (11 classes, hidden 32, ``channels=(8, 16, 32)``, 2 x 1 x 32 x 64):
  logits at 1e-5 of their scale; three Adam steps through the port's
  ``make_train_step`` against the JAX eager tape, losses and every
  parameter and running statistic at 1e-4; ``ctc_greedy_decode`` equal.
* ``ppocrv3_rec(6625)`` at the JAX defaults: the JAX model's names and
  shapes (3.48M parameters, global blocks at head sizes 16 and 32).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.vision.models import CTCHeadLoss as JaxCTCHeadLoss
from paddle_tpu.vision.models import crnn as jax_crnn
from paddle_tpu.vision.models import ctc_greedy_decode as jax_decode
from paddle_tpu.vision.models import ppocrv3_rec as jax_ppocrv3_rec

import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.distributed import make_train_step
from paddle_tpu_torch.models import load_jax_state, to_jax_state
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.vision.models import (CTCHeadLoss,
                                            crnn, ctc_greedy_decode,
                                            ppocrv3_rec)
from paddle_tpu_torch.vision.models.ppocr import GlobalMixBlock
from _torch_cpu_place import cpu_place  # noqa: F401,E402

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def _fast_jax_compiles():
    """The JAX side runs op by op, and compiling each op dominates this
    file's time: XLA's optimisation passes are skipped while it runs (the
    same ops, the same f32 arithmetic), and restored after."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def _np(t):
    return np.asarray(t._value) if hasattr(t, "_value") else \
        t.detach().cpu().numpy()


def _state(jm):
    return {k: np.asarray(v._value) for k, v in jm.state_dict().items()}


def _jt(a, grad=False):
    t = paddle.to_tensor(np.asarray(a))
    if grad:
        t.stop_gradient = False
    return t


def _close(got, want, err_msg=""):
    """A model's output at 1e-5 of its scale (f32 sums in another
    order)."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()),
                               err_msg=err_msg)


# -- MultiHeadAttention -------------------------------------------------------

MHA = ["self", "cross-kdim", "bool-mask", "add-mask", "weights", "cache",
       "static-cache"]


@pytest.mark.parametrize("case", MHA)
def test_multi_head_attention_matches_jax(case):
    E, H, B, Tq, Tk = 32, 4, 2, 6, 9
    rs = np.random.RandomState(MHA.index(case))
    kw = dict(kdim=20, vdim=24) if case == "cross-kdim" else {}
    paddle.seed(MHA.index(case))
    jm = jnn.MultiHeadAttention(E, H, need_weights=case == "weights", **kw)
    pm = pnn.MultiHeadAttention(E, H, need_weights=case == "weights", **kw)
    load_jax_state(pm, _state(jm))
    q = rs.randn(B, Tq, E).astype(np.float32)
    k = rs.randn(B, Tk, kw.get("kdim", E)).astype(np.float32)
    v = rs.randn(B, Tk, kw.get("vdim", E)).astype(np.float32)
    mask = None
    if case == "bool-mask":
        mask = rs.rand(B, 1, Tq, Tk) > 0.3
    elif case == "add-mask":
        mask = (rs.randn(B, H, Tq, Tk) * 2).astype(np.float32)
    jargs = [_jt(q, True), _jt(k, True), _jt(v, True)]
    pargs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    if case in ("self", "weights", "cache", "static-cache"):
        jargs[1] = jargs[2] = jargs[0]
        pargs[1] = pargs[2] = pargs[0]
    jkw = {} if mask is None else dict(attn_mask=_jt(mask))
    pkw = {} if mask is None else dict(attn_mask=torch.from_numpy(mask))
    if case == "cache":
        jkw["cache"] = jm.gen_cache(jargs[0])
        pkw["cache"] = pm.gen_cache(pargs[0])
    if case == "static-cache":
        jkw["cache"] = jm.gen_cache(_jt(k), _jt(k),
                                    type=jnn.MultiHeadAttention.StaticCache)
        pkw["cache"] = pm.gen_cache(torch.from_numpy(k), torch.from_numpy(k),
                                    type=pnn.MultiHeadAttention.StaticCache)
    jout = jm(*jargs, **jkw)
    pout = pm(*pargs, **pkw)
    jouts = jout if isinstance(jout, tuple) else (jout,)
    pouts = pout if isinstance(pout, tuple) else (pout,)
    assert len(jouts) == len(pouts)
    for g, w in zip(pouts, jouts):
        if isinstance(w, tuple):        # a cache: its k and v
            for gg, ww in zip(g, w):
                np.testing.assert_allclose(_np(gg), _np(ww), **TOL)
        else:
            np.testing.assert_allclose(_np(g), _np(w), **TOL)
    (jouts[0] ** 2).sum().backward()
    (pouts[0] ** 2).sum().backward()
    for g, w in zip(pargs, jargs):
        np.testing.assert_allclose(_np(g.grad), _np(w.grad), rtol=1e-5,
                                   atol=1e-5)


# -- LSTM ---------------------------------------------------------------------

LSTMS = [dict(layers=1, direction="forward", time_major=False),
         dict(layers=1, direction="bidirect", time_major=False),
         dict(layers=2, direction="bidirect", time_major=True),
         dict(layers=2, direction="forward", time_major=False, init=True)]


@pytest.mark.parametrize("case", LSTMS, ids=[str(c) for c in LSTMS])
def test_lstm_matches_jax(case):
    C, Hd, B, T = 6, 5, 3, 7
    rs = np.random.RandomState(case["layers"] + len(case))
    kw = dict(num_layers=case["layers"], direction=case["direction"],
              time_major=case["time_major"])
    paddle.seed(4)
    jm = jnn.LSTM(C, Hd, **kw)
    pm = pnn.LSTM(C, Hd, **kw)
    load_jax_state(pm, _state(jm))
    assert sorted(pm.state_dict()) == sorted(_state(jm))
    shape = (T, B, C) if case["time_major"] else (B, T, C)
    x = rs.randn(*shape).astype(np.float32)
    jx, px = _jt(x, True), torch.from_numpy(x).requires_grad_()
    if case.get("init"):
        n = case["layers"] * (2 if case["direction"] == "bidirect" else 1)
        h0, c0 = (rs.randn(n, B, Hd).astype(np.float32) for _ in range(2))
        jout, (jh, jc) = jm(jx, (_jt(h0), _jt(c0)))
        pout, (ph, pc) = pm(px, (torch.from_numpy(h0), torch.from_numpy(c0)))
    else:
        jout, (jh, jc) = jm(jx)
        pout, (ph, pc) = pm(px)
    for g, w in ((pout, jout), (ph, jh), (pc, jc)):
        np.testing.assert_allclose(_np(g), _np(w), **TOL)
    (jout ** 2).sum().backward()
    (pout ** 2).sum().backward()
    np.testing.assert_allclose(_np(px.grad), _np(jx.grad), **TOL)


# -- CTC ----------------------------------------------------------------------

# (T, N, C, L, layout, input_lengths, label_lengths)
CTC = [(12, 3, 6, 4, "batch", None, None),
       (12, 3, 6, 4, "time", None, None),
       (4, 4, 5, 2, "batch", None, None),            # T == N: batch-first
       (10, 3, 6, 4, "time", [10, 7, 9], [4, 2, 0]),  # an empty label
       (6, 2, 5, 4, "batch", [6, 2], [3, 4])]         # row 1 cannot fit


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("case", CTC, ids=[f"{c[4]}-T{c[0]}N{c[1]}"
                                           + ("-lengths" if c[5] else "")
                                           for c in CTC])
def test_ctc_loss_matches_jax(case, reduction):
    T, N, C, L, layout, in_len, lab_len = case
    rs = np.random.RandomState(T * N + L)
    shape = (N, T, C) if layout == "batch" else (T, N, C)
    z = (rs.randn(*shape) * 2).astype(np.float32)
    labels = rs.randint(1, C, (N, L)).astype(np.int64)
    labels[0, 1] = labels[0, 0]                       # a repeated label
    in_len = np.array(in_len or [T] * N, np.int64)
    lab_len = np.array(lab_len or [L] * N, np.int64)
    jz = _jt(z, True)
    want = JF.ctc_loss(jz, _jt(labels), _jt(in_len), _jt(lab_len), blank=0,
                       reduction=reduction)
    pz = torch.from_numpy(z).requires_grad_()
    got = F.ctc_loss(pz, torch.from_numpy(labels), torch.from_numpy(in_len),
                     torch.from_numpy(lab_len), blank=0, reduction=reduction)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    layer = pnn.CTCLoss(blank=0, reduction=reduction)(
        pz, torch.from_numpy(labels), torch.from_numpy(in_len),
        torch.from_numpy(lab_len))
    np.testing.assert_array_equal(_np(layer), _np(got))
    if case[5] is not None and case[6][1] == 4:       # an infeasible row
        return
    want.sum().backward()
    got.sum().backward()
    np.testing.assert_allclose(_np(pz.grad), _np(jz.grad), rtol=1e-5,
                               atol=1e-6)


# -- SVTR and CRNN -----------------------------------------------------------

def _svtr_pair(seed):
    paddle.seed(seed)
    kw = dict(dims=(16, 32, 48), depths=(1, 2, 1), num_heads=4)
    jm = jax_ppocrv3_rec(12, **kw)
    pm = ppocrv3_rec(12, **kw, device="cpu")
    load_jax_state(pm, _state(jm))
    x = np.random.RandomState(0).randn(2, 3, 32, 64).astype(np.float32)
    labels = np.random.RandomState(1).randint(1, 12, (2, 5)).astype(np.int64)
    return jm, pm, x, labels


def _crnn_pair(seed):
    paddle.seed(seed)
    kw = dict(in_channels=1, hidden_size=32, channels=(8, 16, 32))
    jm = jax_crnn(11, **kw)
    pm = crnn(11, **kw, device="cpu")
    load_jax_state(pm, _state(jm))
    x = np.random.RandomState(4).randn(2, 1, 32, 64).astype(np.float32)
    labels = np.random.RandomState(5).randint(1, 11, (2, 5)).astype(np.int64)
    return jm, pm, x, labels


PAIRS = {"svtr": _svtr_pair, "crnn": _crnn_pair}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_logits_and_decode_match_jax(name):
    jm, pm, x, _ = PAIRS[name](3)
    for mode in ("train", "eval"):
        getattr(jm, mode)()
        getattr(pm, mode)()
        want = _np(jm(_jt(x)))
        got = pm(torch.from_numpy(x))
        assert tuple(got.shape) == want.shape == (2, 16, want.shape[-1])
        _close(_np(got), want, err_msg=mode)
    assert ctc_greedy_decode(got) == jax_decode(_jt(want))


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_adam_steps_match_jax(name):
    """Three f32 Adam steps (lr 2e-3, the JAX tests') through the port's
    ``make_train_step`` against the JAX eager tape."""
    jm, pm, x, labels = PAIRS[name](6)
    jopt = paddle.optimizer.Adam(learning_rate=2e-3,
                                 parameters=jm.parameters())
    jcrit = JaxCTCHeadLoss()
    want = []
    for _ in range(3):
        loss = jcrit(jm(_jt(x)), _jt(labels))
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        want.append(float(loss.numpy()))
    noise = _noise_gradients(pm, x, labels)
    assert noise == NOISE[name]
    step = make_train_step(pm, Adam(2e-3, parameters=pm),
                           loss_fn=CTCHeadLoss())
    got = [float(step(x, labels)) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]
    after = _state(jm)
    for k, v in to_jax_state(pm).items():
        if k not in noise | _NOISE_MEANS.get(name, set()):
            np.testing.assert_allclose(v, after[k], rtol=1e-4, atol=1e-4,
                                       err_msg=k)


# The parameters whose gradient is 0 in exact arithmetic: a conv bias that
# a batch norm follows, and the key projection's bias (softmax ignores a
# per-query constant).  Their gradients are f32 noise, which Adam turns
# into steps of up to lr in either direction on each side.
NOISE = {"crnn": {"convs.0.bias", "convs.4.bias", "convs.8.bias"},
         "svtr": {"blocks.3.attn.k_proj.bias"}}
# the running means of the batch norms after those biases average the
# conv's output, bias included
_NOISE_MEANS = {"crnn": {"convs.1._mean", "convs.5._mean", "convs.9._mean"}}


def _noise_gradients(pm, x, labels):
    """The tensors whose first gradient lies below 1e-5 of the model's
    largest gradient element (on a copy, so the running statistics stay
    as they are)."""
    import copy

    m = copy.deepcopy(pm).train()
    CTCHeadLoss()(m(torch.from_numpy(x)), torch.from_numpy(labels)).backward()
    grads = {k: p.grad.abs().max().item() for k, p in m.named_parameters()}
    top = max(grads.values())
    return {k for k, g in grads.items() if g <= 1e-5 * top}


def test_ppocrv3_rec_config_matches_jax():
    """``ppocrv3_rec(6625)`` (PP-OCRv3's Chinese head): the JAX model's
    names and shapes, 3477057 parameters, and its global blocks at head
    sizes 16 (stage 2) and 32 (stage 3)."""
    want = {k: tuple(v.shape) for k, v in
            jax_ppocrv3_rec(6625).state_dict().items()}
    pm = ppocrv3_rec(6625, device="cpu")
    assert {k: v.shape for k, v in to_jax_state(pm).items()} == want
    assert sum(p.numel() for p in pm.parameters()) == 3477057
    heads = sorted({b.attn.head_dim for b in pm.blocks
                    if isinstance(b, GlobalMixBlock)})
    assert heads == [16, 32]
