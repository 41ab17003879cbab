"""The port's fused-LayerNorm path against the JAX package's, on the CPU.

The JAX side runs its Pallas kernels in interpret mode
(``flash_attention.use_interpret_mode(True)``, which ``layer_norm.py`` and
``ln_matmul.py`` read); the port side runs the plain versions its wrappers
take for CPU tensors.  Inputs come from numpy seeds.

* Kernel 9 (``_ln_fwd_impl``) and kernel 10 (``_ln_bwd_impl``) against
  ``layer_norm_fwd_plain`` / ``layer_norm_bwd_plain`` at 185 x 128 (the
  TPU's row padding runs) and 64 x 256: rtol/atol 2e-5, both sides in f32
  in another order.
* ``layer_norm_fused`` under autograd in modes "full" and "bwd" against
  ``jax.grad`` of JAX's ``layer_norm_fused``: the three gradients, rtol/
  atol 2e-5 for the forward and dx, 1e-4 for dw and db (column sums of
  185 rows, each term up to ~250 with the ``arange`` cotangent).
* Kernel 8 (``ln_matmul``) forward and four gradients at 300 x 128 @ 128
  x 384 (300 rows cross the TPU's 256-row block, so its pad path runs):
  rtol/atol 2e-5 forward, 1e-4 for the gradients (the weight's gradient
  sums 300 rows).
* The routing predicates over one table of cases, and
  ``F.fused_ln_linear`` on and off.
* The slice as a whole: three AdamW steps of gpt-tiny, T=32, dropout 0,
  from the same weights, with both toggles on (LN mode "full"), and with
  LN mode "bwd" alone.  Losses agree to 1e-5 relative; parameters follow
  ``tests/test_torch_train.py``'s per-element rule.  A spy on the port's
  plain versions shows the fused route: 2 x layers ``ln_matmul`` calls
  and 2 x layers + 1 LayerNorm forwards and backwards a step (each
  ``ln_matmul`` backward runs one of each, the final norm the last), or
  2 x layers + 1 LayerNorm backwards and no kernel forward in mode "bwd".
* ``LayerNorm``'s state-dict names: a JAX gpt-tiny state loads and
  round-trips exactly.
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
from paddle_tpu.kernels import layer_norm as jln
from paddle_tpu.kernels import ln_matmul as jlnmm
from paddle_tpu.models import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.models import build_gpt as jax_build_gpt
from paddle_tpu.models import gpt_config as jax_gpt_config

import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch.distributed import make_train_step
from paddle_tpu_torch.kernels import layer_norm as ln
from paddle_tpu_torch.kernels import ln_matmul as lnmm
from paddle_tpu_torch.models import (GPTPretrainingCriterion, build_gpt,
                                     load_jax_state, to_jax_state)
from paddle_tpu_torch.nn import LayerNorm
from paddle_tpu_torch.optimizer import AdamW
from _torch_cpu_place import cpu_place  # noqa: F401,E402

TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
EPS = 1e-5

# gpt-tiny shapes gain nothing from intra-op threads; one thread keeps
# these tests from crowding the timing-sensitive tests of other workers
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _toggles():
    """The port's toggles are process-wide: off before and after each
    test (``tests/conftest.py`` resets the JAX package's)."""
    ln.enable_fused_layernorm(False)
    lnmm.enable_ln_matmul(False)
    jfa.use_interpret_mode(True)
    yield
    ln.enable_fused_layernorm(False)
    lnmm.enable_ln_matmul(False)
    jln.enable_fused_layernorm(False)
    jlnmm.enable_ln_matmul(False)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ln_case(n, c, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, c).astype(np.float32),
            rs.randn(c).astype(np.float32),
            rs.randn(c).astype(np.float32),
            rs.randn(n, c).astype(np.float32))


class _Spy:
    """Counts calls of the port's plain versions (the CPU route of each
    kernel wrapper)."""

    NAMES = ((lnmm, "ln_matmul_plain", "ln_matmul"),
             (ln, "layer_norm_fwd_plain", "ln_fwd"),
             (ln, "layer_norm_bwd_plain", "ln_bwd"))

    def __init__(self, monkeypatch):
        self.n = {key: 0 for _, _, key in self.NAMES}
        for mod, attr, key in self.NAMES:
            monkeypatch.setattr(mod, attr, self._wrap(key, getattr(mod, attr)))

    def _wrap(self, key, fn):
        def call(*a):
            self.n[key] += 1
            return fn(*a)
        return call


@pytest.mark.parametrize("n,c", [(185, 128), (64, 256)],
                         ids=["185x128", "64x256"])
def test_ln_forward_plain_matches_jax_kernel(n, c):
    x, w, b, _ = _ln_case(n, c, seed=n)
    want = jln._ln_fwd_impl(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                            EPS)
    got = ln.layer_norm_fwd_plain(_t(x), _t(w), _t(b), EPS)
    for name, g, v in zip(("y", "mu", "rs"), got, want):
        assert g.shape == v.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(v), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("n,c", [(185, 128), (64, 256)],
                         ids=["185x128", "64x256"])
def test_ln_backward_plain_matches_jax_kernel(n, c):
    x, w, b, dy = _ln_case(n, c, seed=n + 1)
    _, mu, rs = jln._ln_fwd_impl(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b), EPS)
    want = jln._ln_bwd_impl(jnp.asarray(x), jnp.asarray(w), mu, rs,
                            jnp.asarray(dy), EPS)
    got = ln.layer_norm_bwd_plain(_t(x), _t(w), _t(np.asarray(mu)),
                                  _t(np.asarray(rs)), _t(dy))
    for name, g, v, tol in zip(("dx", "dw", "db"), got, want,
                               (TOL, GRAD_TOL, GRAD_TOL)):
        assert g.shape == v.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(v), **tol,
                                   err_msg=name)


@pytest.mark.parametrize("c,dtype", [(1280, "float32"), (2560, "bfloat16")],
                         ids=["1280-f32", "2560-bf16"])
def test_ln_wide_rows_plain_match_jax_kernels(c, dtype):
    """Rows wider than a lane's registers hold on the card (C > 1024 in
    f32, > 2048 in bf16; GPT-2-large's h = 1280): the plain forward and
    backward against kernels 9 and 10 in interpret mode on the same
    operands.  f32: TOL, GRAD_TOL; bf16 y and dx within one bf16 rounding
    (1e-2), the f32 statistics at TOL, dw and db at GRAD_TOL."""
    x, w, b, dy = _ln_case(70, c, seed=c)
    jt, tt = jnp.dtype(dtype), getattr(torch, dtype)
    xj, wj, bj, dyj = (jnp.asarray(a).astype(jt) for a in (x, w, b, dy))
    y_j, mu_j, rs_j = jln._ln_fwd_impl(xj, wj, bj, EPS)
    want = (y_j, mu_j, rs_j,
            *jln._ln_bwd_impl(xj, wj, mu_j, rs_j, dyj, EPS))
    xt, wt, bt, dyt = (_t(a).to(tt) for a in (x, w, b, dy))
    y, mu, rs = ln.layer_norm_fwd_plain(xt, wt, bt, EPS)
    got = (y, mu, rs, *ln.layer_norm_bwd_plain(xt, wt, mu, rs, dyt))
    rows = TOL if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    for name, g, v, tol in zip(("y", "mu", "rs", "dx", "dw", "db"), got,
                               want, (rows, TOL, TOL, rows, GRAD_TOL,
                                      GRAD_TOL)):
        assert g.dtype == (tt if name in ("y", "dx") else torch.float32)
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(v).astype(np.float32), **tol,
                                   err_msg=name)


@pytest.mark.parametrize("mode", ["full", "bwd"])
def test_layer_norm_fused_grads_match_jax(mode, monkeypatch):
    rs = np.random.RandomState(0)
    x = rs.randn(37, 5, 256).astype(np.float32)   # 185 rows: the pad path
    w, b = rs.randn(256).astype(np.float32), rs.randn(256).astype(np.float32)
    coef = np.arange(256.0, dtype=np.float32)
    jln.enable_fused_layernorm(mode)
    jx, jw, jb = jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)
    y_j = jln.layer_norm_fused(jx, jw, jb, EPS)
    grads_j = jax.grad(
        lambda *a: (jln.layer_norm_fused(*a, EPS) * coef).sum(),
        argnums=(0, 1, 2))(jx, jw, jb)
    ln.enable_fused_layernorm(mode)
    ts = [_t(a).requires_grad_() for a in (x, w, b)]
    spy = _Spy(monkeypatch)
    y = ln.layer_norm_fused(*ts, EPS)
    (y * _t(coef)).sum().backward()
    assert spy.n == dict(ln_matmul=0, ln_fwd=int(mode == "full"), ln_bwd=1)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), **TOL)
    for name, t, g, tol in zip(("dx", "dw", "db"), ts, grads_j,
                               (TOL, GRAD_TOL, GRAD_TOL)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **tol,
                                   err_msg=name)


def test_ln_matmul_and_grads_match_jax():
    rs = np.random.RandomState(0)
    x = rs.randn(300, 128).astype(np.float32)
    g, b = rs.randn(128).astype(np.float32), rs.randn(128).astype(np.float32)
    w_km = rs.randn(128, 384).astype(np.float32)   # JAX layout [K, M]
    coef = np.arange(384.0, dtype=np.float32) / 384.0
    jlnmm.enable_ln_matmul(True)
    ops_j = [jnp.asarray(a) for a in (x, g, b, w_km)]
    y_j = jlnmm.ln_matmul(*ops_j)
    grads_j = jax.grad(lambda *a: (jlnmm.ln_matmul(*a) * coef).sum(),
                       argnums=(0, 1, 2, 3))(*ops_j)
    ts = [_t(a).requires_grad_() for a in (x, g, b, w_km.T)]  # w [M, K]
    y = lnmm.ln_matmul(*ts, eps=EPS)
    (y * _t(coef)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), **TOL)
    for name, t, want in zip(("dx", "dgamma", "dbeta"), ts, grads_j):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   **GRAD_TOL, err_msg=name)
    np.testing.assert_allclose(ts[3].grad.numpy().T, np.asarray(grads_j[3]),
                               **GRAD_TOL, err_msg="dw")


def test_ln_matmul_bf16_grads_match_jax():
    """bf16 x and W with f32 g and b, at the 300 x 128 @ 128 x 384 case:
    dx, dgamma and dbeta against ``jax.grad`` of the JAX ``ln_matmul``,
    whose backward takes the normalised rows' gradient dxln as an f32
    product (``preferred_element_type``, ``ln_matmul.py:143-144``).  A
    dxln rounded to bf16 first moves dbeta by up to 18.5 of 8887 and
    dgamma by 1.67 of 682, 26-32x this tolerance; the f32 one stays within
    0.01x of it.  Tolerance: rtol 1e-4 with atol 1e-5 of the largest
    gradient for dgamma and dbeta (f32 sums of 300 rows in another order),
    one bf16 rounding (1e-2) for the bf16 dx."""
    rs = np.random.RandomState(0)
    x = rs.randn(300, 128).astype(np.float32)
    g, b = rs.randn(128).astype(np.float32), rs.randn(128).astype(np.float32)
    w_km = rs.randn(128, 384).astype(np.float32)   # JAX layout [K, M]
    coef = np.arange(384.0, dtype=np.float32) / 384.0
    jlnmm.enable_ln_matmul(True)
    xj, wj = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, w_km))
    gj, bj = jnp.asarray(g), jnp.asarray(b)
    grads_j = jax.grad(
        lambda *a: (jlnmm.ln_matmul(*a).astype(jnp.float32) * coef).sum(),
        argnums=(0, 1, 2))(xj, gj, bj, wj)
    xt = _t(x).bfloat16().requires_grad_()
    gt, bt = _t(g).requires_grad_(), _t(b).requires_grad_()
    wt = _t(w_km.T).bfloat16()
    (lnmm.ln_matmul(xt, gt, bt, wt, eps=EPS).float() * _t(coef)).sum() \
        .backward()
    assert xt.grad.dtype == torch.bfloat16 and gt.grad.dtype == torch.float32
    np.testing.assert_allclose(xt.grad.float().numpy(),
                               np.asarray(grads_j[0]).astype(np.float32),
                               rtol=1e-2, atol=1e-2, err_msg="dx")
    for name, t, want in zip(("dgamma", "dbeta"), (gt, bt), grads_j[1:]):
        want = np.asarray(want)
        np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)


def test_ln_matmul_plain_rounds_the_normalised_rows_first():
    """bf16: the normalised rows are rounded to bf16 before an f32
    product, and the result is rounded once (JAX ``ln_matmul.py:71-75``)."""
    rs = np.random.RandomState(3)
    x = _t(rs.randn(16, 128).astype(np.float32)).bfloat16()
    w = _t(rs.randn(256, 128).astype(np.float32)).bfloat16()
    g, b = torch.ones(128), torch.zeros(128)
    got = lnmm.ln_matmul_plain(x, g, b, w, EPS)
    xf = x.float()
    xln = ((xf - xf.mean(1, keepdim=True))
           * torch.rsqrt(xf.var(1, unbiased=False, keepdim=True) + EPS))
    want = (xln.bfloat16().float() @ w.float().t()).bfloat16()
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _pred_cases():
    """(name, x shape, axes, has weight, w shape [M, K] or None)."""
    return [("aligned", (4, 3, 256), (2,), True, (384, 256)),
            ("no-weight", (4, 3, 256), (2,), False, (384, 256)),
            ("unaligned-C", (4, 3, 200), (2,), True, (384, 200)),
            ("unaligned-M", (4, 3, 256), (2,), True, (300, 256)),
            ("non-last-axis", (4, 3, 256), (1,), True, (384, 256)),
            ("two-axes", (4, 3, 256), (1, 2), True, (384, 256))]


@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
def test_routing_predicates_match_jax(on):
    jln.enable_fused_layernorm(on)
    ln.enable_fused_layernorm(on)
    jlnmm.enable_ln_matmul(on)
    lnmm.enable_ln_matmul(on)
    for name, shape, axes, has_w, wshape in _pred_cases():
        c = shape[-1]
        xj, xt = jnp.zeros(shape), torch.zeros(shape)
        wj = jnp.ones(c) if has_w else None
        wt = torch.ones(c) if has_w else None
        assert (ln.layer_norm_fused_ok(xt, axes, wt, torch.zeros(c)) ==
                jln.layer_norm_fused_ok(xj, axes, wj, jnp.zeros(c))), name
        for free in (True, False):
            got = lnmm.ln_matmul_ok(xt, torch.zeros(wshape), mesh_free=free)
            want = jlnmm.ln_matmul_ok(xj, jnp.zeros(wshape[::-1]),
                                      mesh_free=free)
            assert got == want, (name, free)
    if on:
        assert ln.layer_norm_fused_ok(torch.zeros(4, 256), (1,),
                                      torch.ones(256), torch.zeros(256))


@pytest.mark.parametrize("on", [False, True], ids=["plain", "kernel"])
def test_fused_ln_linear_matches_jax(on, monkeypatch):
    rs = np.random.RandomState(5)
    x = rs.randn(2, 7, 128).astype(np.float32)
    g, b = rs.randn(128).astype(np.float32), rs.randn(128).astype(np.float32)
    w_km = rs.randn(128, 256).astype(np.float32)
    bias = rs.randn(256).astype(np.float32)
    jlnmm.enable_ln_matmul(on)
    lnmm.enable_ln_matmul(on)
    want = JF.fused_ln_linear(*(paddle.to_tensor(a)
                                for a in (x, g, b, w_km, bias)), eps=EPS)
    before = lnmm.ln_matmul.launches
    spy = _Spy(monkeypatch)
    got = F.fused_ln_linear(_t(x), _t(g), _t(b), _t(w_km), _t(bias),
                            eps=EPS)
    assert lnmm.ln_matmul.launches == before      # CPU: no kernel launch
    assert spy.n["ln_matmul"] == int(on)
    assert got.shape == (2, 7, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want._value), **TOL)


def test_toggles_validate_and_wrappers_refuse_other_devices():
    with pytest.raises(ValueError, match="unknown mode"):
        ln.enable_fused_layernorm("fast")
    for flag, mode in ((True, "full"), ("bwd", "bwd"), (0, "off")):
        ln.enable_fused_layernorm(flag)
        assert ln._MODE == mode
    meta = torch.zeros(8, 128, device="meta")
    with pytest.raises(ValueError, match="no fused LayerNorm"):
        ln.layer_norm_fwd(meta, meta[0], meta[0], EPS)
    with pytest.raises(ValueError, match="no ln_matmul"):
        lnmm.ln_matmul(meta, meta[0], meta[0], torch.zeros(128, 128,
                                                             device="meta"))


def test_cost_helpers_count_each_byte_once():
    assert ln.layernorm_cost(16384, 768, 2, "fwd") == (
        7.0 * 16384 * 768, 2 * 2.0 * 16384 * 768 + 2 * 2 * 768 + 8 * 16384)
    assert ln.layernorm_cost(8, 128, 4, "bwd") == (
        12.0 * 8 * 128, 4 * 3.0 * 8 * 128 + 8 * 8 + 4 * 128 + 8 * 128)
    with pytest.raises(ValueError):
        ln.layernorm_cost(8, 128, 4, "both")
    assert lnmm.ln_matmul_cost(16384, 768, 2304, 2) == (
        2.0 * 16384 * 768 * 2304,
        2 * (16384 * 768 + 2304 * 768 + 16384 * 2304) + 2 * 2 * 768)


def test_layer_norm_module_default_path_is_torch():
    """Toggle off: the port's LayerNorm is ``torch.nn.LayerNorm`` bit for
    bit, in f32 and bf16."""
    x = torch.randn(3, 5, 128, generator=torch.Generator().manual_seed(0))
    ours, ref = LayerNorm(128, epsilon=1e-5), torch.nn.LayerNorm(128,
                                                                 eps=1e-5)
    with torch.no_grad():
        for p, q in zip(torch.nn.Module.parameters(ours), ref.parameters()):
            p.copy_(torch.randn(p.shape, generator=torch.Generator()
                                .manual_seed(p.numel())))
            q.copy_(p)
    assert [n for n, _ in ours.named_parameters()] == ["weight", "bias"]
    assert ours._epsilon == 1e-5
    for dt in (torch.float32, torch.bfloat16):
        torch.testing.assert_close(ours.to(dt)(x.to(dt)), ref.to(dt)(x.to(dt)),
                                   rtol=0, atol=0)


# -- the model -----------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    cfg = jax_gpt_config("gpt-tiny", max_position_embeddings=128,
                         hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    paddle.seed(13)
    jm = jax_build_gpt(cfg)
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    return cfg, state


def test_layer_norm_state_names_round_trip(tiny):
    _, state = tiny
    pm = build_gpt("gpt-tiny", device="cpu", max_position_embeddings=128)
    norms = [n for n, m in pm.named_modules() if isinstance(m, LayerNorm)]
    assert norms == ["gpt.layers.0.norm1", "gpt.layers.0.norm2",
                     "gpt.layers.1.norm1", "gpt.layers.1.norm2",
                     "gpt.final_norm"]
    load_jax_state(pm, state)
    back = to_jax_state(pm)
    assert set(back) == set(state)
    for k, v in state.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    assert "gpt.final_norm.bias" in back and "gpt.layers.1.norm2.weight" in back


def _jax_steps(cfg, state, ids, ln_mode, fused_proj, monkeypatch,
               steps=3):
    """Three JAX steps; returns the losses, the state after them and how
    often each Pallas kernel was traced (the step traces once)."""
    jln.enable_fused_layernorm(ln_mode)
    jlnmm.enable_ln_matmul(fused_proj)
    traced = {"ln_matmul": 0, "ln_fwd": 0, "ln_bwd": 0}
    for mod, attr, key in ((jlnmm, "_ln_matmul_fwd_impl", "ln_matmul"),
                           (jln, "_ln_fwd_impl", "ln_fwd"),
                           (jln, "_ln_bwd_impl", "ln_bwd")):
        fn = getattr(mod, attr)
        monkeypatch.setattr(mod, attr, lambda *a, _k=key, _f=fn: (
            traced.__setitem__(_k, traced[_k] + 1), _f(*a))[1])
    jm = jax_build_gpt(cfg)
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    jopt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                  parameters=jm.parameters())
    jstep = jdist.make_train_step(jm, jopt, loss_fn=JaxCriterion())
    losses = [float(jstep(ids[:, :-1], ids[:, 1:])) for _ in range(steps)]
    jstep.sync_to_model()
    return (losses, {k: np.asarray(v._value)
                     for k, v in jm.state_dict().items()}, traced)


@pytest.mark.parametrize("ln_mode,fused_proj,per_step,port_step", [
    ("full", True, dict(ln_matmul=4, ln_fwd=1, ln_bwd=1),
     dict(ln_matmul=4, ln_fwd=5, ln_bwd=5)),
    ("bwd", False, dict(ln_matmul=0, ln_fwd=0, ln_bwd=5),
     dict(ln_matmul=0, ln_fwd=0, ln_bwd=5)),
], ids=["both-on", "ln-bwd-alone"])
def test_fused_ln_train_step_matches_jax(tiny, monkeypatch, ln_mode,
                                         fused_proj, per_step, port_step):
    cfg, state = tiny
    ids = np.random.RandomState(2).randint(0, 1024, (2, 33)).astype(np.int64)
    want, after, traced = _jax_steps(cfg, state, ids, ln_mode, fused_proj,
                                     monkeypatch)
    assert traced == per_step            # the JAX step took its kernels

    pm = build_gpt("gpt-tiny", device="cpu", max_position_embeddings=128,
                   hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    load_jax_state(pm, state)
    ln.enable_fused_layernorm(ln_mode)
    lnmm.enable_ln_matmul(fused_proj)
    spy = _Spy(monkeypatch)
    step = make_train_step(pm, AdamW(learning_rate=1e-3, parameters=pm),
                           loss_fn=GPTPretrainingCriterion())
    got = [float(step(ids[:, :-1], ids[:, 1:])) for _ in range(3)]
    assert spy.n == {k: 3 * v for k, v in port_step.items()}
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for k, v in to_jax_state(pm).items():
        np.testing.assert_allclose(v, after[k], rtol=0, atol=1e-4,
                                   err_msg=k)
        close = np.abs(v - after[k]) <= 2e-6
        if k.endswith("qkv_proj.bias"):       # head-major [nh, 3, hd]
            close = close.reshape(cfg.num_attention_heads, 3, -1)[:, ::2]
        assert np.mean(~close) <= 1e-3, k
