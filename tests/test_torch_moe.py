"""The port's mixture of experts and activations against the JAX package,
on the CPU (f32; the JAX side at ``jax_default_matmul_precision``
"highest", as ``tests/conftest.py`` sets it).  Weights go from the JAX
layers to the port's through ``load_jax_state``.

* Gates in eval (naive, GShard, Switch): values, indices and balance
  loss, to 1e-6 (one softmax of the same f32 logits).
* ``MoELayer`` with the naive top-2 gate at ``capacity_factor=0.5``, so
  choices are dropped: the port's (expert, slot) of every choice equals
  the reference's dense one-hot build, written out below in numpy from
  JAX's indices (the JAX layer's own combine tensor agrees), exactly;
  output and gradients (input, gate, experts) to 1e-5 (f32 sums over the
  same terms in another order).
* Switch's ``p_top1`` scale; the routing utilities; ``global_scatter`` /
  ``global_gather``; the MoE clip (rtol 1e-6: one f32 norm).
* What has no JAX bits to match (the port draws from a
  ``torch.Generator``): GShard's second-expert keep rate against
  ``mean(min(1, 2 p2))`` within 4 sigma on 8192 tokens, and Switch's
  jitter inside ``[1 - eps, 1 + eps)``.
* gpt-tiny with MoE layers: eval logits with the GShard gate (1e-4),
  three ``make_train_step`` steps with ``GPTMoEPretrainingCriterion`` and
  the naive gate against the JAX step (losses 1e-5 relative, parameters
  1e-4 and all but 1e-3 of each tensor's elements 2e-6:
  ``test_torch_train.py``'s step tolerances; an element whose first
  gradient is f32 noise, 1e-6 of the tensor's largest, is exempt from the
  1e-4: Adam's first step moves it by up to 1e-4 on the noise alone, as
  ``test_torch_train.py`` describes); recompute and
  scan-layers over MoE layers equal the plain forward (rtol 1e-6), the
  criterion owns no parameter; weights and train state cross JAX -> port
  -> JAX exactly.
* Every activation of ``nn.functional`` against JAX's on inputs in [-30,
  30] (rtol 1e-6, atol 1e-6: the same formula in f32, a few roundings of
  O(1) values; where a result cancels, in gelu's tail or tanhshrink near
  0, its relative error is large and the absolute one is not), and a gpt-tiny with ``activation="silu"``;
  ``fuse_qkv=False`` computes what ``True`` computes.
"""
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.incubate.distributed.models import moe as jmoe
from paddle_tpu.models import GPTMoEPretrainingCriterion as JaxMoECriterion
from paddle_tpu.models import build_gpt as jax_build_gpt
from paddle_tpu.nn.layer_base import Parameter as JaxParameter

import paddle_tpu_torch.nn as pnn
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch.distributed import make_train_step
from paddle_tpu_torch.incubate.distributed.models import moe as pmoe
from paddle_tpu_torch.models import (GPTMoEMLP, GPTMoEPretrainingCriterion,
                                     build_gpt, load_jax_state,
                                     load_jax_train_state, to_jax_state,
                                     to_jax_train_state)
from paddle_tpu_torch.models.convert import _linear_weights
from paddle_tpu_torch.optimizer import AdamW
from _torch_cpu_place import cpu_place  # noqa: F401,E402

torch.set_num_threads(1)

TINY = dict(max_position_embeddings=128, hidden_dropout_prob=0.0,
            attention_dropout_prob=0.0)


def _state(jlayer):
    return {k: np.asarray(v._value) for k, v in jlayer.state_dict().items()}


def _port_of(jlayer, player):
    load_jax_state(player, _state(jlayer))
    return player


def _grads_jax_layout(module):
    """{name: grad} of the port's parameters in the JAX layout."""
    linear = _linear_weights(module)
    return {n: (p.grad.numpy().T if n in linear else p.grad.numpy())
            for n, p in module.named_parameters()}


class _JaxIdentity(jnn.Layer):
    def forward(self, x):
        return x


# -- gates ---------------------------------------------------------------------

GATES = {"naive": (jmoe.NaiveGate, pmoe.NaiveGate, dict(topk=2)),
         "gshard": (jmoe.GShardGate, pmoe.GShardGate, {}),
         "switch": (jmoe.SwitchGate, pmoe.SwitchGate, {})}


@pytest.mark.parametrize("kind", sorted(GATES))
def test_gate_in_eval_matches_jax(kind):
    jcls, pcls, kw = GATES[kind]
    paddle.seed(0)
    jg = jcls(16, 4, 1, **kw)
    jg.eval()
    pg = _port_of(jg, pcls(16, 4, 1, **kw)).eval()
    x = np.random.RandomState(1).randn(64, 16).astype(np.float32)
    jval, jidx = jg(paddle.to_tensor(x))
    pval, pidx = pg(torch.from_numpy(x))
    np.testing.assert_allclose(pval.detach().numpy(), jval.numpy(),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(pidx.numpy(), jidx.numpy())
    jloss, ploss = jg.get_loss(), pg.get_loss()
    if kind == "naive":
        assert jloss is None and ploss is None
    else:
        np.testing.assert_allclose(float(ploss.detach()),
                                   float(jloss.numpy()),
                                   rtol=1e-6)
        assert pg.get_loss() is None          # cleared by the read


def test_gates_refuse_other_k():
    with pytest.raises(ValueError, match="topk should be 2"):
        pmoe.GShardGate(8, 4, 1, topk=1)
    with pytest.raises(ValueError, match="topk should be 1"):
        pmoe.SwitchGate(8, 4, 1, topk=2)


def test_gshard_random_routing_keep_rate():
    """In training the second expert survives with probability min(1, 2
    p2): over 8192 tokens from a fixed generator, the kept share lies
    within 4 sigma of mean(min(1, 2 p2)); the first choices and the
    balance loss (computed before the routing) are eval's."""
    torch.manual_seed(0)
    gate = pmoe.GShardGate(32, 8, 1, generator=torch.Generator().manual_seed(3))
    x = torch.randn(8192, 32)
    with torch.no_grad():
        val, idx_eval = gate.eval()(x)
        loss_eval = gate.get_loss()
        val_t, idx = gate.train()(x)
        loss_train = gate.get_loss()
    assert torch.equal(idx[:, 0], idx_eval[:, 0])
    assert torch.equal(val_t, val)
    assert float(loss_train) == float(loss_eval)
    assert set(idx[:, 1].tolist()) - set(range(8)) == {-1}
    kept = idx[:, 1] >= 0
    assert torch.equal(idx[kept, 1], idx_eval[kept, 1])
    p = (2.0 * val[:, 1]).clamp(max=1.0).double()
    sigma = float((p * (1 - p)).sum().sqrt()) / len(p)
    gap = abs(float(kept.double().mean()) - float(p.mean()))
    assert gap <= 4 * sigma, (gap, sigma)


def test_switch_jitter_stays_in_bounds():
    """Training multiplies the logits by U[1 - eps, 1 + eps) from the
    gate's generator: the same draw, replayed, lies inside the bounds and
    gives the gate's values and indices."""
    torch.manual_seed(1)
    gate = pmoe.SwitchGate(16, 4, 1, switch_eps=0.1,
                           generator=torch.Generator().manual_seed(4))
    x = torch.randn(4096, 16)
    state = gate.generator.get_state()
    with torch.no_grad():
        val, idx = gate.train()(x)
        score = gate.gate(x)
    gate.generator.set_state(state)
    noise = torch.empty_like(score).uniform_(0.9, 1.1,
                                             generator=gate.generator)
    assert float(noise.min()) >= 0.9 and float(noise.max()) < 1.1
    assert float((noise - 1).abs().max()) > 0.09       # spans the range
    probs = torch.softmax(score * noise, -1)
    torch.testing.assert_close(val, probs.max(-1, keepdim=True).values)
    assert torch.equal(idx, probs.argmax(-1, keepdim=True))


# -- the layer -----------------------------------------------------------------

def _jax_expert(d, h):
    return jnn.Sequential(jnn.Linear(d, h), jnn.ReLU(), jnn.Linear(h, d))


def _port_expert(d, h):
    return pnn.Sequential(pnn.Linear(d, h), pnn.ReLU(), pnn.Linear(h, d))


def _reference_slots(idx, n_expert, capacity):
    """The JAX layer's dense one-hot build (``moe_layer.py:97-105``) in
    numpy: each (choice j, token n) -> (expert, position), k-major; a
    position >= capacity is dropped."""
    n, k = idx.shape
    valid = idx >= 0
    oh = np.eye(n_expert, dtype=np.int64)[np.clip(idx, 0, n_expert - 1)]
    oh = (oh * valid[..., None]).transpose(1, 0, 2).reshape(k * n, n_expert)
    pos = ((np.cumsum(oh, axis=0) - 1) * oh).sum(-1)
    e = idx.T.reshape(-1)
    keep = (pos < capacity) & (oh.sum(-1) > 0)
    return e, pos, keep


def test_moe_layer_slots_output_and_grads_match_jax():
    d, n_exp = 16, 4
    paddle.seed(3)
    jl = jmoe.MoELayer(d, [_jax_expert(d, 32) for _ in range(n_exp)],
                       gate={"type": "naive", "top_k": 2},
                       capacity_factor=0.5)
    pl = _port_of(jl, pmoe.MoELayer(
        d, [_port_expert(d, 32) for _ in range(n_exp)],
        gate={"type": "naive", "top_k": 2}, capacity_factor=0.5))
    x = np.random.RandomState(2).randn(2, 12, d).astype(np.float32)
    dy = np.random.RandomState(5).randn(2, 12, d).astype(np.float32)
    n = 24
    cap = pl._capacity(n)
    assert cap == jl._capacity(n) == 6

    # the slot assignment
    xt = torch.from_numpy(x).requires_grad_()
    val, idx = pl.gate(xt.reshape(n, d))
    jval, jidx = jl.gate(paddle.to_tensor(x.reshape(n, d)))
    np.testing.assert_array_equal(idx.numpy(), jidx.numpy())
    slot, w = pl._route(val, idx, cap)
    e_ref, pos_ref, keep_ref = _reference_slots(np.asarray(jidx.numpy()),
                                                n_exp, cap)
    e, pos = (slot // (cap + 1)).numpy(), (slot % (cap + 1)).numpy()
    kept = pos < cap
    np.testing.assert_array_equal(kept, keep_ref)
    assert (~kept).sum() > 0, "the case must drop choices"
    np.testing.assert_array_equal(e[kept], e_ref[kept])
    np.testing.assert_array_equal(pos[kept], pos_ref[kept])
    assert (w.detach().numpy()[~kept] == 0).all()
    combine = np.asarray(jl._dispatch_combine(jval, jidx, n, cap).numpy())
    tok = np.tile(np.arange(n), 2)
    assert set(zip(*np.nonzero(combine))) == set(
        zip(tok[kept], e[kept], pos[kept]))

    # output and gradients
    jx = paddle.to_tensor(x, stop_gradient=False)
    jout = jl(jx)
    (jout * paddle.to_tensor(dy)).sum().backward()
    out = pl(xt)
    (out * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), jout.numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), jx.grad.numpy(), rtol=1e-5,
                               atol=1e-5)
    jgrads = {k: np.asarray(p.grad.numpy())
              for k, p in jl.named_parameters()}
    for name, g in _grads_jax_layout(pl).items():
        np.testing.assert_allclose(g, jgrads[name], rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    assert any(np.abs(g).max() > 0 for k, g in _grads_jax_layout(pl).items()
               if k.startswith("gate."))


def test_switch_top1_scales_by_router_prob():
    """Switch keeps ``p_top1`` as the scale (a k = 1 renormalisation
    would make it 1): identity experts give ``p_top1 * x``, as in JAX."""
    d = 8
    paddle.seed(9)
    jl = jmoe.MoELayer(d, [_JaxIdentity() for _ in range(4)],
                       gate={"type": "switch"}, capacity_factor=8.0)
    jl.eval()
    pl = _port_of(jl, pmoe.MoELayer(d, [torch.nn.Identity()
                                        for _ in range(4)],
                                    gate={"type": "switch"},
                                    capacity_factor=8.0)).eval()
    x = np.random.RandomState(8).randn(12, d).astype(np.float32)
    with torch.no_grad():
        out = pl(torch.from_numpy(x)).numpy()
        val, _ = pl.gate(torch.from_numpy(x))
    np.testing.assert_allclose(out, val.numpy() * x, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(out, jl(paddle.to_tensor(x)).numpy(),
                               rtol=1e-6, atol=1e-6)
    assert (np.abs(out - x) > 1e-3).any()


# -- routing utilities ---------------------------------------------------------

def _util_case(name, rs):
    E = 6
    if name == "number_count":
        ids = rs.randint(-1, E, (50,)).astype(np.int64)
        return (ids, E), (ids, E)
    if name == "limit_by_capacity":
        ec = rs.randint(0, 9, (2 * E,)).astype(np.int64)
        cap = rs.randint(0, 9, (E,)).astype(np.int64)
        return (ec, cap, 2), (ec, cap, 2)
    if name == "prune_gate_by_capacity":
        idx = rs.randint(-1, E, (60,)).astype(np.int64)
        counts = rs.randint(0, 8, (E,)).astype(np.int64)
        return (idx, counts, E, 1), (idx, counts, E, 1)
    idx = np.stack([rs.permutation(E)[:2] for _ in range(40)]).astype(
        np.int64)
    val = np.sort(rs.rand(40, 2).astype(np.float32), axis=1)[:, ::-1].copy()
    prob = rs.rand(40).astype(np.float32)
    return (idx, val, prob), (idx, val, prob)


@pytest.mark.parametrize("name", ["number_count", "limit_by_capacity",
                                  "prune_gate_by_capacity", "random_routing"])
def test_routing_utility_matches_jax(name):
    jargs, pargs = _util_case(name, np.random.RandomState(7))
    fn = f"_{name}"
    want = getattr(jmoe, fn)(*[paddle.to_tensor(a) if isinstance(
        a, np.ndarray) else a for a in jargs])
    got = getattr(pmoe, fn)(*[torch.from_numpy(a) if isinstance(
        a, np.ndarray) else a for a in pargs])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.numpy()))


def test_global_exchange_is_identity_on_one_rank():
    x = torch.randn(4, 5, 3)

    class Group:
        nranks = 4

    for fn in (pmoe.global_scatter, pmoe.global_gather):
        assert fn(x, None, None) is x
        with pytest.raises(NotImplementedError, match="entry 11"):
            fn(x, None, None, group=Group())
    with pytest.raises(NotImplementedError, match="entry 11"):
        pmoe.MoELayer(4, [torch.nn.Identity()], moe_group=Group())
    with pytest.raises(NotImplementedError, match="entry 11"):
        pmoe.ClipGradForMOEByGlobalNorm(1.0, moe_group=Group())


def test_moe_clip_matches_jax():
    rs = np.random.RandomState(0)
    shapes = [(8, 16), (16,), (16, 8), (8,)]
    grads = [rs.randn(*s).astype(np.float32) for s in shapes]
    expert = {0, 1}

    def is_expert(p):
        return p.name in expert

    jps = [JaxParameter(jnp.zeros(s, jnp.float32), name=i)
           for i, s in enumerate(shapes)]
    jps[3].need_clip = False
    jclip = jmoe.ClipGradForMOEByGlobalNorm(0.5,
                                            is_expert_param_func=is_expert)
    want = jclip([(p, paddle.to_tensor(g)) for p, g in zip(jps, grads)])
    pps = [torch.zeros(s, requires_grad=True) for s in shapes]
    pps[3].need_clip = False
    pclip = pmoe.ClipGradForMOEByGlobalNorm(
        0.5, is_expert_param_func=lambda p: False)
    got = pclip([(p, torch.from_numpy(g)) for p, g in zip(pps, grads)])
    for (_, g), (_, w), src in zip(got, want, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w.numpy()),
                                   rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got[3][1].numpy(), grads[3])
    assert not np.allclose(got[0][1].numpy(), grads[0])   # it clipped


# -- GPT-MoE -------------------------------------------------------------------

def _jax_moe_gpt(seed=0, **kw):
    paddle.seed(seed)
    return jax_build_gpt("gpt-tiny", moe_num_experts=4, **TINY, **kw)


def _port_moe_gpt(jm, **kw):
    pm = build_gpt("gpt-tiny", device="cpu", moe_num_experts=4, **TINY, **kw)
    load_jax_state(pm, _state(jm))
    return pm


def _ids(b=2, t=128, seed=0):
    return np.random.RandomState(seed).randint(0, 1024, (b, t + 1)).astype(
        np.int64)


def test_gpt_moe_logits_in_eval_match_jax():
    jm = _jax_moe_gpt()
    jm.eval()
    pm = _port_moe_gpt(jm).eval()
    assert [type(layer.mlp).__name__ for layer in pm.gpt.layers] == [
        "GPTMLP", "GPTMoEMLP"]
    ids = _ids(2, 64)[:, :-1]
    want = np.asarray(jm(paddle.to_tensor(ids)).numpy())
    with torch.no_grad():
        got = pm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(pm.gpt.moe_aux_loss()),
                               float(jm.gpt.moe_aux_loss().numpy()),
                               rtol=1e-5)


def test_gpt_moe_train_steps_match_jax():
    """Three AdamW steps with the naive top-2 gate (no random draw) and
    ``GPTMoEPretrainingCriterion``: the JAX step and the port's from the
    same weights."""
    jm = _jax_moe_gpt(seed=4, moe_gate="naive")
    pm = _port_moe_gpt(jm, moe_gate="naive")
    ids = _ids(2, 128, seed=1)
    jopt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                  parameters=jm.parameters())
    jstep = jdist.make_train_step(jm, jopt, loss_fn=JaxMoECriterion(jm))
    want = [float(jstep(ids[:, :-1], ids[:, 1:])) for _ in range(3)]
    step = make_train_step(pm, AdamW(learning_rate=1e-3, parameters=pm),
                           loss_fn=GPTMoEPretrainingCriterion(pm))
    got = [float(step(ids[:, :-1], ids[:, 1:]))]
    first = _grads_jax_layout(pm)
    got += [float(step(ids[:, :-1], ids[:, 1:])) for _ in range(2)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    after = jstep.state_dict()["params"]
    port = to_jax_state(pm)
    assert "gpt.layers.1.mlp.moe.experts.3.fc1.weight" in after
    for k, v in after.items():
        # Adam's first step moves an element by ~lr |g| / (|g| + 1e-8)
        # whatever |g|: where the first gradient is f32 noise (1e-6 of
        # the tensor's largest, ~1e-9 here) that alone is up to 1e-4,
        # in either direction on the two sides
        diff = np.abs(port[k] - np.asarray(v))
        g = np.abs(first[k])
        assert ((diff <= 1e-4) | (g <= 1e-6 * g.max())).all(), (k, diff.max())
        close = diff <= 2e-6
        if k.endswith("qkv_proj.bias"):       # head-major [nh, 3, hd]: the
            # key bias's gradient is 0 in exact arithmetic (softmax ignores
            # a per-row constant), so both sides step it on noise alone
            close = close.reshape(4, 3, -1)[:, ::2]
        assert np.mean(~close) <= 1e-3, k


def _one_step(pm, ids):
    pm.train()
    torch.manual_seed(5)                 # GShard's second-expert draws
    pm.zero_grad()
    crit = GPTMoEPretrainingCriterion(pm)
    loss = crit(pm(torch.from_numpy(ids[:, :-1])),
                torch.from_numpy(ids[:, 1:]))
    loss.backward()
    return float(loss.detach()), {n: p.grad.clone()
                         for n, p in pm.named_parameters()}


@pytest.mark.parametrize("opts", [dict(use_recompute=True),
                                  dict(scan_layers=True)],
                         ids=["recompute", "scan"])
def test_gpt_moe_recompute_and_scan_equal_the_plain_forward(opts):
    """A MoE layer runs outside recompute (its gate's loss is read after
    the forward) and scan-layers runs the per-layer loop: one step's loss
    and every gradient equal the plain forward's; the gates' weights get
    gradients through the balance loss."""
    jm = _jax_moe_gpt(seed=2)
    ids = _ids(2, 32, seed=3)
    want_loss, want = _one_step(_port_moe_gpt(jm), ids)
    loss, grads = _one_step(_port_moe_gpt(jm, **opts), ids)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-6)
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=n)
    assert float(grads["gpt.layers.1.mlp.moe.gate.gate.weight"].abs().max()
                 ) > 0


def test_gpt_moe_criterion_owns_no_parameters_and_adds_the_aux_loss():
    jm = _jax_moe_gpt(seed=6)
    pm = _port_moe_gpt(jm).train()
    crit = GPTMoEPretrainingCriterion(pm, aux_loss_weight=0.5)
    assert list(crit.parameters()) == [] and crit.state_dict() == {}
    ids = torch.from_numpy(_ids(2, 16, seed=4))
    logits = pm(ids[:, :-1])
    aux = pm.gpt.moe_aux_loss()
    lm = GPTMoEPretrainingCriterion(pm, aux_loss_weight=0.0)(logits,
                                                             ids[:, 1:])
    pm.gpt.layers[1].mlp.last_aux_loss = aux
    total = crit(logits, ids[:, 1:])
    torch.testing.assert_close(total, lm + 0.5 * aux)
    dense = build_gpt("gpt-tiny", device="cpu", **TINY)
    assert dense.gpt.moe_aux_loss() is None


def test_gpt_moe_config_guards():
    with pytest.raises(ValueError, match="moe_top_k"):
        build_gpt("gpt-tiny", device="cpu", moe_num_experts=4,
                  moe_gate="switch", moe_top_k=3)
    m = build_gpt("gpt-tiny", device="cpu", moe_num_experts=2,
                  moe_gate="naive", moe_top_k=1, moe_every_n_layers=1)
    assert all(isinstance(layer.mlp, GPTMoEMLP) for layer in m.gpt.layers)
    assert m.gpt.layers[0].mlp.moe.top_k == 1
    # no fused pre-LN route for a MoE layer
    from paddle_tpu_torch.kernels import ln_matmul
    ln_matmul.enable_ln_matmul(True)
    try:
        assert not m.gpt.layers[0]._fuse_ln_proj()
        assert build_gpt("gpt-tiny", device="cpu").gpt.layers[0] \
            ._fuse_ln_proj()
    finally:
        ln_matmul.enable_ln_matmul(False)


def test_engine_refuses_a_moe_model():
    from paddle_tpu_torch.serving import Engine

    m = build_gpt("gpt-tiny", device="cpu", moe_num_experts=2)
    with pytest.raises(NotImplementedError, match="MoE.*entry 4"):
        Engine(m, device="cpu", auto_start=False)


def test_gpt_moe_state_and_train_state_cross_exactly():
    """Weights JAX -> port -> JAX, and a JAX train state after 2 steps ->
    the port's step -> back, equal bit for bit (expert and gate
    parameters and their AdamW slots included)."""
    jm = _jax_moe_gpt(seed=7, moe_gate="naive")
    state = _state(jm)
    pm = _port_moe_gpt(jm, moe_gate="naive")
    back = to_jax_state(pm)
    assert set(back) == set(state)
    for k, v in state.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    ids = _ids(2, 32, seed=8)
    jopt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                  parameters=jm.parameters())
    jstep = jdist.make_train_step(jm, jopt, loss_fn=JaxMoECriterion(jm))
    for _ in range(2):
        jstep(ids[:, :-1], ids[:, 1:])
    jstate = jstep.state_dict()
    step = make_train_step(pm, AdamW(learning_rate=1e-3, parameters=pm),
                           loss_fn=GPTMoEPretrainingCriterion(pm))
    load_jax_train_state(step, {k: v for k, v in jstate.items()})
    out = to_jax_train_state(step, rng_key=jstate["rng_key"])
    name = "gpt.layers.1.mlp.moe.experts.2.fc0.weight"
    assert name in out["params"] and name in out["slots"]
    for sec in ("params", "slots"):
        assert set(out[sec]) == set(jstate[sec]), sec
    for k, v in jstate["params"].items():
        np.testing.assert_array_equal(out["params"][k], np.asarray(v))
    for k, d in jstate["slots"].items():
        for s, v in d.items():
            np.testing.assert_array_equal(out["slots"][k][s], np.asarray(v))
    assert int(out["step"]) == int(jstate["step"]) == 2


# -- activations, fuse_qkv -----------------------------------------------------

ACTS = sorted(F.ACTIVATIONS) + ["gelu-tanh"]


@pytest.mark.parametrize("name", ACTS)
def test_activation_matches_jax(name):
    rs = np.random.RandomState(0)
    x = np.concatenate([rs.randn(400) * 3, np.linspace(-30, 30, 121),
                        [0.0, 0.5, -0.5, 3.0, -3.0, 6.0, 20.0, 21.0]]
                       ).astype(np.float32)
    kw = {}
    if name == "gelu-tanh":
        name, kw = "gelu", dict(approximate=True)
    want = np.asarray(getattr(JF, name)(paddle.to_tensor(x), **kw).numpy())
    got = getattr(F, name)(torch.from_numpy(x), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_gpt_with_another_activation_matches_jax():
    paddle.seed(1)
    jm = jax_build_gpt("gpt-tiny", activation="silu", **TINY)
    jm.eval()
    pm = build_gpt("gpt-tiny", device="cpu", activation="silu", **TINY)
    load_jax_state(pm, _state(jm))
    ids = _ids(1, 32)[:, :-1]
    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, np.asarray(
        jm(paddle.to_tensor(ids)).numpy()), rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="activation"):
        build_gpt("gpt-tiny", device="cpu", activation="layer_norm")


def test_fuse_qkv_false_computes_what_true_computes():
    paddle.seed(2)
    jm = jax_build_gpt("gpt-tiny", fuse_qkv=False, **TINY)
    jm.eval()
    state = _state(jm)
    ids = torch.from_numpy(_ids(2, 32)[:, :-1])
    outs = []
    for fuse in (True, False):
        pm = build_gpt("gpt-tiny", device="cpu", fuse_qkv=fuse, **TINY)
        load_jax_state(pm, state)
        with torch.no_grad():
            outs.append(pm.eval()(ids).numpy())
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_allclose(outs[1], np.asarray(
        jm(paddle.to_tensor(ids.numpy())).numpy()), rtol=1e-4, atol=1e-4)
    assert math.isfinite(float(outs[1].sum()))
