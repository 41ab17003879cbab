"""The GPT training recipe's surface on the port against the JAX package,
on the CPU (gpt-tiny, f32; the JAX side at ``jax_default_matmul_precision``
"highest", as ``tests/conftest.py`` sets it).

* Schedulers: each of ``optimizer/lr.py``'s schedules over 30 steps, the
  same Python arithmetic on both sides, so the values agree exactly; the
  state dict after 10 steps equals JAX's, and a fresh scheduler restored
  from it continues as the unbroken one (``MultiplicativeDecay``: the
  port's restores its running rate, which JAX's state drops).
* Clips: ``ClipGradByValue``, ``ClipGradByNorm``, ``ClipGradByGlobalNorm``
  and ``clip_grad_norm_`` on the same f32 gradients (rtol 1e-6: one
  norm, summed in another order).
* ``fused_linear_nll_loss``: losses and both gradients against the JAX
  function and the port's unfused ``fused_nll_loss`` over the full
  logits, with ignored rows and V not a multiple of the chunk (rtol 1e-5,
  atol 1e-6: f32 sums in chunks against one pass, JAX's own test's
  tolerance).
* ``use_recompute`` / ``scan_layers``: one step's loss and every gradient
  equal to the plain forward's (rtol 1e-6: the same ops replayed), in f32
  and with ``compute_dtype=bfloat16`` over f32 masters.
* ``fuse_head_loss``: the eager tied-embedding gradient (the reference's
  ``tests/test_gpt.py:445``) against the unfused head's and JAX's, and the
  step under the bf16 cast.
* The recipe: 3 steps of ``make_train_step`` with ``LinearWarmup(
  CosineAnnealingDecay)``, ``ClipGradByGlobalNorm(1.0)`` at a norm that
  clips, AdamW ``lr_ratio`` (JAX: the parameters' ``optimize_attr``
  learning rate), recompute, scan-layers and the fused head against the
  JAX step; the tolerances of ``test_torch_train.py``'s step test.
* Resume: the JAX step's ``state_dict()`` after 2 steps loads into the
  port's step (``load_jax_train_state``) and both take one more step;
  the port's state goes back out (``to_jax_train_state``) equal to JAX's
  and continues a fresh JAX step; port save -> load -> continue equals an
  unbroken run bit for bit; a role-major qkv state permutes its slots.
"""
import io

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
import paddle_tpu.nn.clip as jclip
import paddle_tpu.nn.functional as JF
import paddle_tpu.optimizer.lr as jlr
from paddle_tpu.models import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.models import build_gpt as jax_build_gpt
from paddle_tpu.models import gpt_config as jax_gpt_config
from paddle_tpu.nn.layer_base import Parameter as JaxParameter

import paddle_tpu_torch.nn.clip as pclip
import paddle_tpu_torch.nn.functional as F
import paddle_tpu_torch.optimizer.lr as plr
from paddle_tpu_torch.distributed import make_train_step
from paddle_tpu_torch.models import (FusedHeadOutput, GPTPretrainingCriterion,
                                     build_gpt, load_jax_state,
                                     load_jax_train_state, to_jax_state,
                                     to_jax_train_state)
from paddle_tpu_torch.optimizer import AdamW

torch.set_num_threads(1)

TINY = dict(max_position_embeddings=128, hidden_dropout_prob=0.0,
            attention_dropout_prob=0.0)

# -- schedulers ---------------------------------------------------------------


def _metric(i):
    """A loss that falls, then plateaus (ReduceOnPlateau's input)."""
    return [1.0, 0.8, 0.7, 0.69, 0.7, 0.71, 0.69, 0.5][i % 8] - 0.001 * i


SCHEDULES = {
    "Noam": lambda L: L.NoamDecay(d_model=64, warmup_steps=5,
                                  learning_rate=2.0),
    "Piecewise": lambda L: L.PiecewiseDecay([3, 8, 20], [0.1, 0.05, 0.01,
                                                          0.001]),
    "NaturalExp": lambda L: L.NaturalExpDecay(0.5, gamma=0.1),
    "InverseTime": lambda L: L.InverseTimeDecay(0.5, gamma=0.3),
    "Polynomial": lambda L: L.PolynomialDecay(0.1, decay_steps=12,
                                              end_lr=0.001, power=2.0),
    "Polynomial-cycle": lambda L: L.PolynomialDecay(0.1, decay_steps=7,
                                                    cycle=True),
    "LinearWarmup": lambda L: L.LinearWarmup(0.1, 5, 0.0, 0.1),
    "LinearWarmup-cosine": lambda L: L.LinearWarmup(
        L.CosineAnnealingDecay(0.1, T_max=12), 5, 0.01, 0.1),
    "Exponential": lambda L: L.ExponentialDecay(0.1, gamma=0.9),
    "MultiStep": lambda L: L.MultiStepDecay(0.1, [4, 9, 15], gamma=0.5),
    "Step": lambda L: L.StepDecay(0.1, step_size=4, gamma=0.7),
    "Lambda": lambda L: L.LambdaDecay(0.1, lambda e: 1.0 / (1 + e)),
    "Multiplicative": lambda L: L.MultiplicativeDecay(0.1, lambda e: 0.95),
    "CosineAnnealing": lambda L: L.CosineAnnealingDecay(0.1, T_max=10,
                                                        eta_min=0.001),
    "WarmRestarts": lambda L: L.CosineAnnealingWarmRestarts(
        0.1, T_0=4, T_mult=2, eta_min=0.001),
    "OneCycle": lambda L: L.OneCycleLR(0.1, total_steps=25),
    "OneCycle-linear": lambda L: L.OneCycleLR(0.1, total_steps=25,
                                              anneal_strategy="linear"),
    "Cyclic": lambda L: L.CyclicLR(0.01, 0.1, step_size_up=3,
                                   step_size_down=5),
    "Cyclic-triangular2": lambda L: L.CyclicLR(0.01, 0.1, 4,
                                               mode="triangular2"),
    "Cyclic-exp_range": lambda L: L.CyclicLR(0.01, 0.1, 4, mode="exp_range",
                                             exp_gamma=0.9),
    "Cyclic-scale_fn": lambda L: L.CyclicLR(0.01, 0.1, 4,
                                            scale_fn=lambda x: 0.5 ** x),
    "ReduceOnPlateau": lambda L: L.ReduceOnPlateau(0.1, factor=0.5,
                                                   patience=1, cooldown=1),
}


def _advance(sched, i):
    if isinstance(sched, (jlr.ReduceOnPlateau, plr.ReduceOnPlateau)):
        sched.step(_metric(i))
    else:
        sched.step()


def _run(sched, steps, start=0):
    out = []
    for i in range(start, start + steps):
        out.append(sched())
        _advance(sched, i)
    return out


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_scheduler_values_and_state_round_trip(name):
    make = SCHEDULES[name]
    j, p = make(jlr), make(plr)
    assert _run(p, 30) == _run(j, 30)
    j, p = make(jlr), make(plr)
    _run(j, 10)
    _run(p, 10)
    sd = p.state_dict()
    assert sd == j.state_dict()
    restored = make(plr)
    restored.set_state_dict(dict(sd))
    assert _run(restored, 20, 10) == _run(p, 20, 10)
    if name != "Multiplicative":
        jrest = make(jlr)
        jrest.set_state_dict(dict(sd))
        assert _run(jrest, 20, 10) == _run(j, 20, 10)


def test_scheduler_base_and_optimizer_read():
    for L in (jlr, plr):
        with pytest.raises(NotImplementedError):
            L.LRScheduler(0.1)
    sched = plr.StepDecay(0.1, step_size=1, gamma=0.5)
    q = torch.zeros(2, requires_grad=True)
    opt = AdamW(learning_rate=sched, parameters=[q])
    assert opt.get_lr() == 0.1
    sched.step()
    assert opt.get_lr() == 0.05
    with pytest.raises(RuntimeError, match="LRScheduler"):
        opt.set_lr(0.3)
    assert opt.state_dict()["LR_Scheduler"]["last_epoch"] == 1

# -- clips --------------------------------------------------------------------


def _grads(seed=0, scale=1.0):
    rs = np.random.RandomState(seed)
    shapes = {"w": (4, 3), "b": (3,), "e": (5, 2)}
    return {n: (rs.randn(*s) * scale).astype(np.float32)
            for n, s in shapes.items()}


CLIPS = {
    "value": lambda C: C.ClipGradByValue(0.5, -0.3),
    "norm": lambda C: C.ClipGradByNorm(1.0),
    "global-norm": lambda C: C.ClipGradByGlobalNorm(2.0),
    "global-norm-unclipped": lambda C: C.ClipGradByGlobalNorm(100.0),
}


@pytest.mark.parametrize("kind", list(CLIPS))
def test_clip_matches_jax(kind):
    grads = _grads(1, 1.5)
    jpairs = [(JaxParameter(jnp.zeros(g.shape), name=n),
               paddle.to_tensor(g)) for n, g in grads.items()]
    want = [np.asarray(g._value) for _, g in CLIPS[kind](jclip)(jpairs)]
    tgrads = [torch.from_numpy(g.copy()) for g in grads.values()]
    pairs = [(torch.zeros(g.shape), g) for g in tgrads] + [
        (torch.zeros(1), None)]
    got = CLIPS[kind](pclip)(pairs)
    assert got[-1][1] is None
    for (_, g), w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-7)
    for t, src in zip(tgrads, grads.values()):
        np.testing.assert_array_equal(t.numpy(), src)   # copies scaled


@pytest.mark.parametrize("norm_type", [2.0, 1.0, float("inf")],
                         ids=["l2", "l1", "inf"])
def test_clip_grad_norm_matches_jax(norm_type):
    grads = _grads(2, 3.0)
    jparams = []
    for n, g in grads.items():
        p = JaxParameter(jnp.zeros(g.shape), name=n)
        p.grad = jnp.asarray(g)
        jparams.append(p)
    want_total = jclip.clip_grad_norm_(jparams, 1.5, norm_type)
    tparams = []
    for g in grads.values():
        p = torch.zeros(g.shape, requires_grad=True)
        p.grad = torch.from_numpy(g.copy())
        tparams.append(p)
    total = pclip.clip_grad_norm_(tparams, 1.5, norm_type)
    np.testing.assert_allclose(float(total), float(want_total._value),
                               rtol=1e-6)
    for t, j in zip(tparams, jparams):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j.grad._value),
                                   rtol=1e-6, atol=1e-7)
    with pytest.raises(RuntimeError, match="not finite"):
        tparams[0].grad[0, 0] = float("nan")
        pclip.clip_grad_norm_(tparams, 1.5, error_if_nonfinite=True)

# -- the fused head loss ------------------------------------------------------


@pytest.mark.parametrize("N,H,V,chunk", [(37, 16, 1000, 256),
                                         (20, 8, 100, 8192)],
                         ids=["chunked", "one-chunk"])
def test_fused_linear_nll_loss_matches_jax_and_unfused(N, H, V, chunk):
    rs = np.random.RandomState(N)
    h = rs.randn(N, H).astype(np.float32)
    w = (rs.randn(V, H) * 0.3).astype(np.float32)
    lab = rs.randint(0, V, (N,)).astype(np.int64)
    lab[::7] = -100
    gw = rs.rand(N).astype(np.float32)

    def jloss(hv, wv):
        nll = JF.fused_linear_nll_loss(paddle.to_tensor(hv),
                                       paddle.to_tensor(wv),
                                       paddle.to_tensor(lab),
                                       chunk_size=chunk)._value
        return jnp.sum(nll * gw), nll

    (_, want), (jdh, jdw) = jax.value_and_grad(jloss, argnums=(0, 1),
                                               has_aux=True)(
        jnp.asarray(h), jnp.asarray(w))
    ht, wt = (torch.from_numpy(x).requires_grad_() for x in (h, w))
    nll = F.fused_linear_nll_loss(ht, wt, torch.from_numpy(lab),
                                  chunk_size=chunk)
    (nll * torch.from_numpy(gw)).sum().backward()
    assert float(nll[0].detach()) == 0.0
    np.testing.assert_allclose(nll.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(jdh), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jdw), rtol=1e-5,
                               atol=1e-6)
    hu, wu = (torch.from_numpy(x).requires_grad_() for x in (h, w))
    ref = F.fused_nll_loss(hu @ wu.t(), torch.from_numpy(lab))
    (ref * torch.from_numpy(gw)).sum().backward()
    np.testing.assert_allclose(nll.detach().numpy(), ref.detach().numpy(),
                               rtol=1e-5, atol=1e-6)
    for a, b in ((ht, hu), (wt, wu)):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                   rtol=1e-5, atol=1e-6)
    # [H, V] weights, a batch axis
    wt2 = torch.from_numpy(np.ascontiguousarray(w.T))
    nll2 = F.fused_linear_nll_loss(torch.from_numpy(h).reshape(1, N, H), wt2,
                                   torch.from_numpy(lab).reshape(1, N),
                                   transpose_weight=False, chunk_size=chunk)
    assert nll2.shape == (1, N)
    np.testing.assert_allclose(nll2.reshape(-1).numpy(),
                               nll.detach().numpy(), rtol=1e-6, atol=1e-7)

# -- recompute, scan-layers, the fused head in the model ----------------------


def _tiny(seed=0, **kw):
    return build_gpt("gpt-tiny", device="cpu", seed=seed, **TINY, **kw)


def _ids(seed=0, batch=2, t=64):
    return np.random.RandomState(seed).randint(0, 1024, (batch, t + 1))


def _one_step(model, compute_dtype=None):
    step = make_train_step(model, AdamW(1e-3, parameters=model),
                           loss_fn=GPTPretrainingCriterion(),
                           compute_dtype=compute_dtype)
    ids = _ids(3)
    loss = float(step(ids[:, :-1], ids[:, 1:]))
    return loss, {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("dtype", [None, torch.bfloat16],
                         ids=["f32", "bf16-over-f32"])
@pytest.mark.parametrize("opts", [dict(use_recompute=True),
                                  dict(use_recompute=True, scan_layers=True),
                                  dict(scan_layers=True)],
                         ids=["recompute", "recompute-scan", "scan"])
def test_recompute_and_scan_equal_the_plain_forward(opts, dtype):
    want_loss, want = _one_step(_tiny(), dtype)
    loss, grads = _one_step(_tiny(**opts), dtype)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-6)
    for n, g in grads.items():
        assert g.dtype == torch.float32, n
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=n)


def test_recompute_replays_each_layer():
    """Under recompute the backward runs each layer's forward again: the
    flash forward is called twice per layer (the card's launch counts
    show the same, ``chip_smoke.py``'s 1.3B phase)."""
    from paddle_tpu_torch.nn.functional import attention as att

    calls = []
    inner = att.flash_attention_qkv_fused

    def counted(*a, **k):
        calls.append(1)
        return inner(*a, **k)

    att.flash_attention_qkv_fused = counted
    try:
        for opts, want in ((dict(), 2), (dict(use_recompute=True), 4)):
            calls.clear()
            _one_step(_tiny(**opts))
            assert len(calls) == want, opts
    finally:
        att.flash_attention_qkv_fused = inner


def _eager_tied_grad(fused, state=None):
    m = _tiny(fuse_head_loss=fused)
    if state is not None:
        load_jax_state(m, state)
    m.train()
    ids = _ids(1, t=16)
    out = m(torch.from_numpy(ids[:, :-1]))
    assert isinstance(out, FusedHeadOutput) == fused
    loss = GPTPretrainingCriterion()(out, torch.from_numpy(ids[:, 1:]))
    loss.backward()
    return float(loss.detach()), m.gpt.embeddings.word_embeddings.weight.grad


@pytest.fixture(scope="module")
def jax_tiny():
    cfg = jax_gpt_config("gpt-tiny", **TINY)
    paddle.seed(11)
    jm = jax_build_gpt(cfg)
    return {k: np.asarray(v._value) for k, v in jm.state_dict().items()}


def test_fuse_head_loss_eager_tied_grad(jax_tiny):
    loss_f, gf = _eager_tied_grad(True, jax_tiny)
    loss_u, gu = _eager_tied_grad(False, jax_tiny)
    assert gf is not None, "the fused eager path dropped the head gradient"
    np.testing.assert_allclose(loss_f, loss_u, rtol=1e-6)
    np.testing.assert_allclose(gf.numpy(), gu.numpy(), rtol=2e-5, atol=1e-6)
    # the JAX model's eager fused head, from the same weights
    cfg = jax_gpt_config("gpt-tiny", fuse_head_loss=True, **TINY)
    jm = jax_build_gpt(cfg)
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in jax_tiny.items()})
    jm.train()
    ids = _ids(1, t=16)
    jl = JaxCriterion()(jm(paddle.to_tensor(ids[:, :-1])),
                        paddle.to_tensor(ids[:, 1:]))
    jl.backward()
    np.testing.assert_allclose(loss_f, float(jl), rtol=1e-5)
    np.testing.assert_allclose(
        gf.numpy(), np.asarray(jm.gpt.embeddings.word_embeddings.weight
                               .grad._value), rtol=1e-4, atol=1e-6)


def test_fuse_head_loss_step_under_the_cast():
    """Inside the step the criterion gets the cast weight: the tied
    table's gradient is the same as the unfused head's (bf16 tolerance:
    the fused head rounds its chunks' dlogits to bf16, the unfused loss
    rounds the whole dlogits)."""
    loss_u, gu = _one_step(_tiny(), torch.bfloat16)
    loss_f, gf = _one_step(_tiny(fuse_head_loss=True), torch.bfloat16)
    np.testing.assert_allclose(loss_f, loss_u, rtol=2e-3)
    name = "gpt.embeddings.word_embeddings.weight"
    assert float(gf[name].abs().max()) > 0
    np.testing.assert_allclose(gf[name].numpy(), gu[name].numpy(),
                               rtol=2e-2, atol=2e-4)

# -- the recipe's step against JAX --------------------------------------------


RECIPE = dict(use_recompute=True, scan_layers=True, fuse_head_loss=True)


def _ratio(name):
    return 0.5 if ".layers.1." in name else 1.0


def _jax_step(state, opts, clip=None, sched=None):
    cfg = jax_gpt_config("gpt-tiny", **TINY, **opts)
    jm = jax_build_gpt(cfg)
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    for name, t in jm.state_dict().items():
        if not t.stop_gradient:
            t.optimize_attr = {"learning_rate": _ratio(name)}
    opt = paddle.optimizer.AdamW(
        learning_rate=sched if sched is not None else 1e-3,
        parameters=jm.parameters(), weight_decay=0.01, grad_clip=clip)
    return jm, jdist.make_train_step(jm, opt, loss_fn=JaxCriterion())


def _port_step(state, opts, clip=None, sched=None, seed=0):
    pm = _tiny(seed=seed, **opts)
    load_jax_state(pm, state)
    opt = AdamW(learning_rate=sched if sched is not None else 1e-3,
                parameters=pm, weight_decay=0.01, grad_clip=clip,
                lr_ratio=_ratio)
    return pm, make_train_step(pm, opt, loss_fn=GPTPretrainingCriterion())


def _warm_cosine(L):
    return L.LinearWarmup(L.CosineAnnealingDecay(1e-3, T_max=8), 2, 1e-4,
                          1e-3)


def _assert_params_close(pm, jstate, n_heads=4):
    """Within a tenth of an Adam step, all but 1e-3 of each tensor's
    elements to 2e-6 (``test_torch_train.py``'s rule: the key bias steps
    on rounding noise alone)."""
    ours = to_jax_state(pm)
    for k, want in jstate.items():
        v = ours[k]
        np.testing.assert_allclose(v, want, rtol=0, atol=1e-4, err_msg=k)
        close = np.abs(v - want) <= 2e-6
        if k.endswith("qkv_proj.bias"):
            close = close.reshape(n_heads, 3, -1)[:, ::2]
        assert np.mean(~close) <= 1e-3, k


def test_recipe_step_matches_jax(jax_tiny):
    ids = _ids(0, t=128)
    jsched, psched = _warm_cosine(jlr), _warm_cosine(plr)
    jm, jstep = _jax_step(jax_tiny, RECIPE, jclip.ClipGradByGlobalNorm(1.0),
                          jsched)
    pm, pstep = _port_step(jax_tiny, RECIPE,
                           pclip.ClipGradByGlobalNorm(1.0), psched)
    want, got, norms = [], [], []
    for _ in range(3):
        want.append(float(jstep(ids[:, :-1], ids[:, 1:])))
        got.append(float(pstep(ids[:, :-1], ids[:, 1:])))
        # the step clipped the gradients in place: their norm is 1
        norms.append(float(pclip.global_norm(
            [p.grad for p in pm.parameters()])))
        jsched.step()
        psched.step()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(norms, 1.0, rtol=1e-5)
    jstep.sync_to_model()
    _assert_params_close(pm, {k: np.asarray(v._value)
                              for k, v in jm.state_dict().items()})
    assert pstep.compile_count == 1

# -- the train state ----------------------------------------------------------


def _head_to_role(arr, nh, is_bias):
    if is_bias:
        return arr.reshape(nh, 3, -1).transpose(1, 0, 2).reshape(-1)
    h = arr.shape[0]
    return arr.reshape(h, nh, 3, -1).transpose(0, 2, 1, 3).reshape(h, -1)


def test_resume_from_the_jax_step_and_back(jax_tiny):
    ids = _ids(5, t=128)
    x, y = ids[:, :-1], ids[:, 1:]
    opts = dict(use_recompute=True)
    clip = 1.0
    _, jstep = _jax_step(jax_tiny, opts, jclip.ClipGradByGlobalNorm(clip))
    for _ in range(2):
        jstep(x, y)
    jsd = jstep.state_dict()
    assert jsd["meta"]["format"] == "train_state_v2"
    # a fresh port step from other weights takes the JAX state whole
    pm, pstep = _port_step(to_jax_state(_tiny(seed=9)), opts,
                           pclip.ClipGradByGlobalNorm(clip))
    load_jax_train_state(pstep, jsd)
    back = to_jax_train_state(pstep, rng_key=jsd["rng_key"])
    for sec in ("params", "buffers"):
        for k, v in jsd[sec].items():
            np.testing.assert_array_equal(back[sec][k], v, err_msg=k)
    for k, d in jsd["slots"].items():
        for s, v in d.items():
            np.testing.assert_array_equal(back["slots"][k][s], v,
                                          err_msg=f"{k}/{s}")
    assert int(back["step"]) == 2 and int(back["opt_step_count"]) == 2
    # one more step on each side
    want = float(jstep(x, y))
    got = float(pstep(x, y))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    after = jstep.state_dict()
    _assert_params_close(pm, after["params"])
    # the port's state continues a fresh JAX step as the unbroken one did
    _, jstep2 = _jax_step(jax_tiny, opts, jclip.ClipGradByGlobalNorm(clip))
    jstep2.load_state_dict(back)
    np.testing.assert_allclose(float(jstep2(x, y)), want, rtol=1e-6)
    # a role-major qkv state (marker 1): params and slots permute alike
    role = {sec: dict(jsd[sec]) for sec in ("params", "buffers")}
    role["slots"] = {k: dict(d) for k, d in jsd["slots"].items()}
    for k in jsd["params"]:
        if "qkv_proj" in k:
            bias = k.endswith("bias")
            role["params"][k] = _head_to_role(jsd["params"][k], 4, bias)
            for s in role["slots"][k]:
                role["slots"][k][s] = _head_to_role(jsd["slots"][k][s], 4,
                                                    bias)
    for k in role["buffers"]:
        if k.endswith("qkv_layout"):
            role["buffers"][k] = np.asarray(1, np.int32)
    role.update(step=jsd["step"], opt_step_count=jsd["opt_step_count"])
    _, pstep2 = _port_step(jax_tiny, opts)
    load_jax_train_state(pstep2, role)
    back2 = to_jax_train_state(pstep2)
    for k, d in jsd["slots"].items():
        np.testing.assert_array_equal(back2["params"][k], jsd["params"][k])
        for s, v in d.items():
            np.testing.assert_array_equal(back2["slots"][k][s], v)


def test_port_save_load_continue_equals_unbroken(jax_tiny):
    ids = _ids(6, t=64)
    x, y = ids[:, :-1], ids[:, 1:]

    def make(seed=0):
        sched = _warm_cosine(plr)
        pm, st = _port_step(jax_tiny, RECIPE, pclip.ClipGradByGlobalNorm(1.0),
                            sched, seed)
        return pm, st, sched

    pm, st, sched = make()
    unbroken = []
    for _ in range(3):
        unbroken.append(float(st(x, y)))
        sched.step()
    pm2, st2, sched2 = make()
    for _ in range(2):
        st2(x, y)
        sched2.step()
    buf = io.BytesIO()
    torch.save({"train": st2.state_dict(), "sched": sched2.state_dict()},
               buf)
    buf.seek(0)
    saved = torch.load(buf)
    pm3, st3, sched3 = make(seed=4)
    st3.load_state_dict(saved["train"])
    sched3.set_state_dict(saved["sched"])
    assert float(st3(x, y)) == unbroken[2]
    for (n, a), b in zip(pm.state_dict().items(), pm3.state_dict().values()):
        assert torch.equal(a, b), n
    sd = st3.state_dict()
    assert int(sd["step"]) == 3 and int(sd["opt_step_count"]) == 3
    st3.sync_to_model()                 # the module is the state: a no-op
    # a bad state leaves the step as it was
    bad = st3.state_dict()
    bad["params"]["gpt.final_norm.weight"] = torch.zeros(3)
    del bad["slots"]["gpt.final_norm.bias"]["moment2"]
    with pytest.raises(ValueError, match="final_norm.weight"):
        st3.load_state_dict(bad)
    bad["params"]["gpt.final_norm.weight"] = sd["params"][
        "gpt.final_norm.weight"]
    with pytest.raises(KeyError, match="moment2"):
        st3.load_state_dict(bad)
    live = dict(pm3.named_parameters())
    for n, v in sd["params"].items():
        assert torch.equal(live[n].detach(), v), n


def test_bf16_train_state_crosses_through_f32():
    """numpy has no bf16: a bf16 step's state leaves as exact f32 arrays,
    and bf16 arrays (``ml_dtypes``, as a bf16 JAX state holds them) enter
    through f32; a fresh bf16 step loaded either way equals the source."""
    ids = _ids(7, t=32)

    def bf16_step(seed):
        pm = _tiny(seed=seed, dtype=torch.bfloat16)
        return make_train_step(pm, AdamW(1e-3, parameters=pm),
                               loss_fn=GPTPretrainingCriterion(),
                               compute_dtype=torch.bfloat16)

    src = bf16_step(0)
    src(ids[:, :-1], ids[:, 1:])
    out = to_jax_train_state(src)
    w = "gpt.layers.0.mlp.fc0.weight"
    assert out["params"][w].dtype == np.float32
    assert out["slots"][w]["moment1"].shape == out["params"][w].shape
    as_bf16 = {sec: {k: np.asarray(jnp.asarray(v, jnp.bfloat16))
                     for k, v in out[sec].items()}
               for sec in ("params",)}
    as_bf16["slots"] = {k: {s: np.asarray(jnp.asarray(v, jnp.bfloat16))
                            for s, v in d.items()}
                        for k, d in out["slots"].items()}
    for via in (out, {**out, **as_bf16}):
        dst = bf16_step(5)
        load_jax_train_state(dst, via)
        got, want = dst.state_dict(), src.state_dict()
        for n, v in want["params"].items():
            assert torch.equal(got["params"][n], v), n
            for s, t in want["slots"][n].items():
                assert torch.equal(got["slots"][n][s], t), f"{n}/{s}"
