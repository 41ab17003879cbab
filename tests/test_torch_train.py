"""The port's training half against the JAX package's, on the CPU.

* The flash kernels' math: the port's plain fused forward and backward
  (``flash_attention_qkv_fused`` under autograd, through ``_FlashFused``)
  and separate-operand backward (``flash_attention_bthd`` through
  ``_Flash``) against JAX's ``flash_attention_qkv_fused`` /
  ``flash_attention_bhtd`` under ``jax.vjp``, run in Pallas interpret mode:
  at T=128 (the TPU's single-tile kernels 5, 6 and 2) and T=1100 with a
  ragged edge (its FA2 split, kernels 3 and 4).  rtol/atol 2e-5: both
  sides compute in f32, in another order.
* The loss: ``fused_nll_loss`` with ignored labels, its gradient,
  ``cross_entropy`` and ``GPTPretrainingCriterion`` with ``loss_mask``.
* The optimizer: AdamW with ``apply_decay_param_fun`` on a toy parameter
  set, three steps (rtol 1e-6: the same f32 element-wise arithmetic).
* The step: three AdamW steps of gpt-tiny at T=128, dropout 0, from the
  same weights, through ``paddle_tpu.distributed.make_train_step`` and the
  port's ``make_train_step(device="cpu")``.  On the CPU the JAX model
  takes its plain attention (``_sdpa_ref``); the kernel math is held by
  the tests above.  Losses agree to 1e-5 relative.  Adam's first steps
  move each weight by about lr = 1e-3 whatever the gradient's size, so
  where a gradient element is near 0 its sign and size sit in the f32
  noise of the two summation orders.  After step 3 every element agrees
  to 1e-4 (a tenth of a step; the largest seen was 4.2e-5, in an MLP
  weight), and all but 1e-3 of each parameter's elements to 2e-6 — except
  the key bias, whose gradient is 0 in exact arithmetic (softmax ignores a
  per-row constant), so both sides step it on rounding noise alone.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
import paddle_tpu.nn.functional as JF
from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu.models import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.models import build_gpt as jax_build_gpt
from paddle_tpu.models import gpt_config as jax_gpt_config
from paddle_tpu.nn.layer_base import Parameter as JaxParameter

import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch.distributed import make_train_step
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.models import (GPTPretrainingCriterion, build_gpt,
                                     gpt_config, gpt_num_params,
                                     gpt_train_flops_per_token,
                                     load_jax_state, to_jax_state)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import Adam, AdamW, Momentum
from paddle_tpu_torch.optimizer.lr import StepDecay
from test_torch_cuda import _bwd_case

TOL = dict(rtol=2e-5, atol=2e-5)

# gpt-tiny shapes gain nothing from intra-op threads; one thread keeps
# these tests from crowding the timing-sensitive tests of other workers
torch.set_num_threads(1)


def _to_bh(x):
    """[B, T, H, D] numpy -> [B*H, T, D] jax."""
    B, T, H, D = x.shape
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(B * H, T, D))


def _from_bh(x, B, H):
    BH, T, D = x.shape
    return np.asarray(x).reshape(B, H, T, D).transpose(0, 2, 1, 3)


# (B, T, H, D): T=128 is one TPU tile (kernels 5, 6, 2); T=1100 pads to
# two 1024-row tiles, so JAX runs its FA2 split (kernels 3, 4)
KERNEL_SHAPES = [(2, 128, 4, 32), (1, 1100, 2, 32)]


@pytest.mark.parametrize("B,T,H,D", KERNEL_SHAPES, ids=["T128", "T1100"])
def test_fused_forward_and_backward_match_jax(B, T, H, D):
    qkv, do = _bwd_case(B, T, T, H, D, fused=True, seed=T)
    jfa.use_interpret_mode(True)
    # JAX's fused operand is [B*H, 3, T, D]
    qkv_j = jnp.asarray(qkv.transpose(0, 2, 3, 1, 4).reshape(B * H, 3, T, D))
    do_j = _to_bh(do.reshape(B, T, H, D))
    out_j, vjp = jax.vjp(lambda x: jfa.flash_attention_qkv_fused(x), qkv_j)
    (dqkv_j,) = vjp(do_j)
    qkv_t = torch.from_numpy(qkv).requires_grad_()
    before = (fa.flash_attention_qkv_fused.launches,
              fa.flash_attention_qkv_fused_bwd.launches_dkv)
    out = F.fused_qkv_attention(qkv_t, is_causal=True)
    out.backward(torch.from_numpy(do))
    assert (fa.flash_attention_qkv_fused.launches,
            fa.flash_attention_qkv_fused_bwd.launches_dkv) == before
    assert out.shape == (B, T, H * D)
    np.testing.assert_allclose(
        out.detach().numpy().reshape(B, T, H, D),
        _from_bh(out_j, B, H), **TOL)
    want = np.asarray(dqkv_j).reshape(B, H, 3, T, D).transpose(0, 3, 1, 2, 4)
    np.testing.assert_allclose(qkv_t.grad.numpy(), want, **TOL)


@pytest.mark.parametrize("B,T,H,D", KERNEL_SHAPES, ids=["T128", "T1100"])
def test_separate_backward_matches_jax(B, T, H, D):
    (q, k, v), do = _bwd_case(B, T, T, H, D, fused=False, seed=T + 1)
    jfa.use_interpret_mode(True)
    _, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention_bhtd(a, b, c),
                     _to_bh(q), _to_bh(k), _to_bh(v))
    want = vjp(_to_bh(do))
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    fa.flash_attention_bthd(*ts, causal=True).backward(torch.from_numpy(do))
    for name, t, w in zip("qkv", ts, want):
        np.testing.assert_allclose(t.grad.numpy(), _from_bh(w, B, H), **TOL,
                                   err_msg=f"d{name}")


def test_plain_backward_matches_autograd_for_tq_below_tk():
    """Tq < Tk (the causal diagonal shifted by Tk - Tq): the written-out
    backward against torch autograd through the plain forward."""
    (q, k, v), do = _bwd_case(2, 24, 40, 3, 16, fused=False, seed=4)
    for causal in (True, False):
        ts = [torch.from_numpy(x).double().requires_grad_()
              for x in (q, k, v)]
        out = fa.flash_attention_plain(*ts, causal=causal)
        out.backward(torch.from_numpy(do).double())
        o, lse = fa.flash_attention_plain(*(torch.from_numpy(x)
                                            for x in (q, k, v)),
                                          causal=causal, return_lse=True)
        got = fa.flash_attention_bwd(*(torch.from_numpy(x)
                                       for x in (q, k, v)), o, lse,
                                     torch.from_numpy(do), causal=causal)
        for g, t in zip(got, ts):
            np.testing.assert_allclose(g.numpy(), t.grad.numpy(), **TOL)


def test_flash_bwd_cost_counts_five_products():
    flops, nbytes = fa.flash_bwd_cost(1, 4, 4, 1, 8, causal=True)
    assert flops == 10.0 * (1 + 2 + 3 + 4) * 8
    assert nbytes == 4.0 * 8 * (3 * 4 + 2 * 4 + 4 + 2 * 4) + 4.0 * 4
    dq, _ = fa.flash_bwd_cost(1, 4, 4, 1, 8, part="dq")
    dkv, _ = fa.flash_bwd_cost(1, 4, 4, 1, 8, part="dkv")
    assert dq + dkv == flops + 4.0 * 10 * 8       # both recompute QK^T, dP
    assert fa.flash_cost(1, 4, 4, 1, 8, itemsize=2)[1] == \
        2.0 * (2 * 4 * 8 + 2 * 4 * 8) + 4.0 * 4


def test_fused_wrapper_rejects_bad_layouts():
    with pytest.raises(ValueError, match="fused qkv"):
        fa.flash_attention_qkv_fused(torch.zeros(1, 4, 2, 2, 8))
    with pytest.raises(ValueError, match="no fused flash attention"):
        fa.flash_attention_qkv_fused(torch.zeros(1, 4, 2, 3, 8,
                                                 device="meta"))


def test_attention_dropout_is_distributional():
    """Dropout > 0 in training takes the plain math with a torch
    generator: same seed, same draw; the kept mass is rescaled."""
    qkv = torch.randn(2, 16, 2, 3, 8, generator=torch.Generator()
                      .manual_seed(0))
    one, two = (F.fused_qkv_attention(
        qkv, dropout_p=0.5, training=True,
        generator=torch.Generator().manual_seed(5)) for _ in range(2))
    torch.testing.assert_close(one, two)
    assert not torch.allclose(one, F.fused_qkv_attention(qkv))
    torch.testing.assert_close(
        F.fused_qkv_attention(qkv, dropout_p=0.5, training=False),
        F.fused_qkv_attention(qkv))


# -- the loss ------------------------------------------------------------------

def _logits_and_labels(seed=0):
    rs = np.random.RandomState(seed)
    logits = rs.randn(2, 7, 11).astype(np.float32) * 3
    labels = rs.randint(0, 11, (2, 7)).astype(np.int64)
    labels[0, 2] = labels[1, 5] = -100
    return logits, labels


def test_fused_nll_loss_and_grad_match_jax():
    logits, labels = _logits_and_labels()
    w = np.random.RandomState(1).rand(2, 7).astype(np.float32)

    def jloss(lg):
        return jnp.sum(JF.fused_nll_loss(paddle.to_tensor(lg),
                                         paddle.to_tensor(labels))._value
                       * w)

    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    per = F.fused_nll_loss(lt, torch.from_numpy(labels))
    assert per.dtype == torch.float32 and float(per[0, 2].detach()) == 0
    total = (per * torch.from_numpy(w)).sum()
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(want_g),
                               rtol=1e-5, atol=1e-6)


def test_cross_entropy_matches_jax_and_refuses_the_rest():
    logits, labels = _logits_and_labels(2)
    want = JF.cross_entropy(paddle.to_tensor(logits),
                            paddle.to_tensor(labels))
    got = F.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(want._value), rtol=1e-6)
    # the other options are ported: each against the JAX function
    soft = np.random.RandomState(3).rand(*logits.shape).astype(np.float32)
    soft /= soft.sum(-1, keepdims=True)
    for lab, kw in ((soft, dict(soft_label=True)),
                    (labels, dict(reduction="sum")),
                    (labels, dict(label_smoothing=0.1))):
        want = JF.cross_entropy(paddle.to_tensor(logits),
                                paddle.to_tensor(lab), **kw)
        got = F.cross_entropy(torch.from_numpy(logits),
                              torch.from_numpy(lab), **kw)
        np.testing.assert_allclose(float(got), float(want._value),
                                   rtol=1e-6)


@pytest.mark.parametrize("masked", [False, True], ids=["mean", "loss_mask"])
def test_criterion_matches_jax(masked):
    logits, labels = _logits_and_labels(3)
    mask = (np.random.RandomState(4).rand(2, 7) > 0.3).astype(np.float32)
    jm = paddle.to_tensor(mask) if masked else None
    want = JaxCriterion()(paddle.to_tensor(logits), paddle.to_tensor(labels),
                          jm)
    got = GPTPretrainingCriterion()(
        torch.from_numpy(logits), torch.from_numpy(labels),
        torch.from_numpy(mask) if masked else None)
    np.testing.assert_allclose(float(got), float(want._value), rtol=1e-6)


def test_criterion_refuses_model_parallelism():
    class Topo:
        mp_degree = 2

    with pytest.raises(NotImplementedError, match="item 11"):
        GPTPretrainingCriterion(topo=Topo())


# -- the optimizer -------------------------------------------------------------

def test_adamw_with_decay_filter_matches_jax():
    rs = np.random.RandomState(0)
    shapes = {"fc.weight": (4, 3), "fc.bias": (3,), "norm.weight": (3,)}
    init = {n: rs.randn(*s).astype(np.float32) for n, s in shapes.items()}
    grads = [{n: rs.randn(*s).astype(np.float32) for n, s in shapes.items()}
             for _ in range(3)]

    def keep(name):
        return not name.endswith("bias")

    jparams = [JaxParameter(jnp.asarray(v), name=n) for n, v in init.items()]
    jopt = paddle.optimizer.AdamW(learning_rate=1e-2, parameters=jparams,
                                  weight_decay=0.1,
                                  apply_decay_param_fun=keep)
    tparams = [(n, torch.from_numpy(v.copy()).requires_grad_())
               for n, v in init.items()]
    topt = AdamW(learning_rate=1e-2, parameters=tparams, weight_decay=0.1,
                 apply_decay_param_fun=keep)
    for g in grads:
        for p in jparams:
            p.grad = jnp.asarray(g[p.name])
        jopt.step()
        for n, p in tparams:
            p.grad = torch.from_numpy(g[n])
        topt.step()
    for p, (n, t) in zip(jparams, tparams):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(p._value),
                                   rtol=1e-6, atol=1e-7, err_msg=n)
    sd = topt.state_dict()
    assert sd["step_count"] == 3 and "fc.bias_moment2" in sd


def test_adam_folds_l2_and_refuses_unported_options():
    p = torch.ones(3, requires_grad=True)
    opt = Adam(learning_rate=0.1, parameters=[p], weight_decay=0.5)
    p.grad = torch.zeros(3)
    opt.step()                  # g = 0 + 0.5 * p: the step moves p down
    assert bool((p < 1).all())
    # a scheduler is read at each step; what is neither a number nor a
    # scheduler is refused
    sched = StepDecay(learning_rate=0.1, step_size=1, gamma=0.5)
    q = torch.ones(3, requires_grad=True)
    opt = AdamW(learning_rate=sched, parameters=[q], weight_decay=0.0)
    q.grad = torch.ones(3)
    opt.step()                  # Adam's first step moves by lr exactly
    sched.step()
    opt.step()
    np.testing.assert_allclose(q.detach().numpy(), 1 - 0.1 - 0.05,
                               rtol=1e-6)
    with pytest.raises(TypeError, match="scheduler"):
        AdamW(learning_rate=lambda: 0.1, parameters=[q])
    # the clip scales copies: the parameter's .grad stays as it was
    r = torch.zeros(4, requires_grad=True)
    opt = Momentum(learning_rate=1.0, momentum=0.0, parameters=[r],
                   grad_clip=ClipGradByGlobalNorm(1.0))
    r.grad = torch.full((4,), 2.0)                  # global norm 4
    opt.step()
    np.testing.assert_allclose(r.detach().numpy(), -0.5, rtol=1e-6)
    np.testing.assert_allclose(r.grad.numpy(), 2.0)
    # MoE and fuse_qkv=False are ported (tests/test_torch_moe.py): both
    # configurations build
    for kw in (dict(moe_num_experts=4), dict(fuse_qkv=False)):
        cfg = gpt_config("gpt-tiny", **kw)
        assert all(getattr(cfg, k) == v for k, v in kw.items())
        build_gpt(cfg, device="cpu")


# -- the step ------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    cfg = jax_gpt_config("gpt-tiny", max_position_embeddings=128,
                         hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    paddle.seed(11)
    jm = jax_build_gpt(cfg)
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    return cfg, jm, state


def test_train_step_matches_jax(tiny):
    cfg, jm, state = tiny
    ids = np.random.RandomState(0).randint(0, 1024, (2, 129)).astype(
        np.int64)
    jopt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                  parameters=jm.parameters())
    jstep = jdist.make_train_step(jm, jopt, loss_fn=JaxCriterion())
    want = [float(jstep(ids[:, :-1], ids[:, 1:])) for _ in range(3)]
    jstep.sync_to_model()

    pm = build_gpt("gpt-tiny", device="cpu", max_position_embeddings=128,
                   hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    load_jax_state(pm, state)
    step = make_train_step(pm, AdamW(learning_rate=1e-3, parameters=pm),
                           loss_fn=GPTPretrainingCriterion())
    got = [step(ids[:, :-1], ids[:, 1:]) for _ in range(3)]
    assert all(g.dtype == torch.float32 and g.dim() == 0 for g in got)
    np.testing.assert_allclose([float(g) for g in got], want, rtol=1e-5)
    after = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    for k, v in to_jax_state(pm).items():
        np.testing.assert_allclose(v, after[k], rtol=0, atol=1e-4,
                                   err_msg=k)
        close = np.abs(v - after[k]) <= 2e-6
        if k.endswith("qkv_proj.bias"):       # head-major [nh, 3, hd]
            close = close.reshape(cfg.num_attention_heads, 3, -1)[:, ::2]
        assert np.mean(~close) <= 1e-3, k
    assert step.compile_count == 1
    step(ids[:, :65], ids[:, 1:66])
    assert step.compile_count == 2
    step(ids[:, :65], ids[:, 1:66])
    assert step.compile_count == 2


def test_bf16_step_casts_inside_and_keeps_f32_masters():
    pm = build_gpt("gpt-tiny", device="cpu", hidden_dropout_prob=0.0,
                   attention_dropout_prob=0.0)
    w0 = pm.gpt.layers[0].mlp.fc0.weight.detach().clone()
    step = make_train_step(pm, AdamW(learning_rate=1e-3, parameters=pm),
                           loss_fn=GPTPretrainingCriterion(),
                           compute_dtype="bfloat16")
    ids = np.random.RandomState(1).randint(0, 1024, (2, 33))
    losses = [float(step(ids[:, :-1], ids[:, 1:])) for _ in range(3)]
    assert losses[-1] < losses[0]
    w = pm.gpt.layers[0].mlp.fc0.weight
    assert w.dtype == torch.float32 and w.grad.dtype == torch.float32
    assert not torch.equal(w.detach(), w0)


def test_step_refuses_unported_options(tiny):
    pm = build_gpt("gpt-tiny", device="cpu")
    opt = AdamW(parameters=pm)
    for kw, what in [(dict(mesh=object()), "mesh"),
                     (dict(accumulate_steps=2), "accumulation")]:
        with pytest.raises(NotImplementedError, match=what):
            make_train_step(pm, opt, **kw)


def test_flops_accounting_matches_jax():
    from paddle_tpu.models.gpt import gpt_num_params as jax_num_params
    from paddle_tpu.models.gpt import \
        gpt_train_flops_per_token as jax_flops

    for name in ("gpt-tiny", "gpt2-small-en"):
        jc, pc = jax_gpt_config(name), gpt_config(name)
        assert gpt_num_params(pc) == jax_num_params(jc)
        assert gpt_train_flops_per_token(pc, 1024) == jax_flops(jc, 1024)
