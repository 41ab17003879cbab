"""The port's ``amp`` against the JAX package's, on the CPU.

* ``auto_cast`` at the op boundary: the counterparts of
  ``tests/test_nn.py``'s ``test_amp_autocast`` (white-list ops in bf16,
  black-list ops in f32, nothing outside a scope) and
  ``test_amp_backward_mixed_chain`` (f32 leaves get f32 gradients), and of
  ``tests/test_autograd.py``'s ``test_create_graph_under_autocast_matches_
  fp32`` (first- and second-order gradients taken inside an O2 scope are
  bit-identical to the no-autocast ones).
* The hook acts on bare torch tensors too (a Layer's forward calls
  ``nn.functional`` on unwrapped values), reads one thread-local outside
  a scope, and follows custom lists.
* ``GradScaler``: ``tests/test_optimizer.py``'s ``test_grad_scaler`` and
  ``tests/test_nn.py``'s ``test_grad_scaler_no_double_unscale`` on both
  packages, the dynamic rules (growth after ``incr_every_n_steps`` finite
  steps, a skipped step and a halved scale on a non-finite gradient) and
  ``decorate``.
* The dtype sweep: every op registered in both packages, on the registry
  sweep's inputs, under ``auto_cast`` O1 and O2, gives outputs of the
  same dtypes (or raises in both: bf16 ``inverse``, ``pinv``,
  ``slogdet``, ``matrix_rank`` have no implementation in either).
* Phase 41's script at 2 layers, d_model 256: f32 Layers under
  ``auto_cast(level="O1", dtype="bfloat16")`` with a ``GradScaler``;
  every sublayer's output dtype equals the JAX package's (forward
  post-hooks), and the losses of three AdamW steps agree within 2e-2
  relative (bf16 products).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.amp.auto_cast import amp_state as jax_amp_state
from paddle_tpu.core.dtype import dtype_name as jax_dtype_name
from paddle_tpu.core.op import OP_REGISTRY as JAX_OPS
from paddle_tpu_torch.amp.auto_cast import amp_state as port_amp_state
from paddle_tpu_torch.core.dtype import dtype_name as port_dtype_name
from paddle_tpu_torch.core.op import OP_REGISTRY as PORT_OPS

import chip_smoke
from _torch_cpu_place import cpu_place  # noqa: F401
from _torch_op_specs import SPECS, inputs

PKGS = (jp, tp)


@pytest.fixture(autouse=True)
def amp_off():
    """Each package's thread-local amp state back to off after a test."""
    yield
    for st in (jax_amp_state(), port_amp_state()):
        st.enabled, st.level = False, "O1"
        st.custom_white, st.custom_black = set(), set()


def _names(dtypes):
    return [str(d).replace("torch.", "").replace("paddle.", "")
            for d in dtypes]


def test_autocast_white_and_black_lists():
    got = []
    for p in PKGS:
        a = p.to_tensor(np.eye(4, dtype=np.float32))
        b = p.to_tensor(np.ones((4, 4), np.float32))
        with p.amp.auto_cast(True):
            out = p.matmul(a, b)
            s = p.exp(out)
        out2 = p.matmul(a, b)
        got.append(_names([out.dtype, s.dtype, out2.dtype]))
    assert got[1] == got[0] == ["bfloat16", "float32", "float32"]


def test_backward_through_a_mixed_chain_gives_f32_grads():
    rs = np.random.RandomState(0)
    xv, wv = rs.randn(4, 4).astype(np.float32), rs.randn(4, 4).astype(
        np.float32)
    res = []
    for p in PKGS:
        F = p.nn.functional
        with p.amp.auto_cast(True):
            x = p.to_tensor(xv, stop_gradient=False)
            w = p.to_tensor(wv, stop_gradient=False)
            out = p.matmul(F.relu(x), w)
            loss = out.astype("float32").sum()
        loss.backward()
        res.append((_names([out.dtype, x.grad.dtype, w.grad.dtype]),
                    x.grad.numpy(), w.grad.numpy()))
    assert res[1][0] == res[0][0] == ["bfloat16", "float32", "float32"]
    for g, w in zip(res[1][1:], res[0][1:]):
        np.testing.assert_allclose(g, w, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("pkg", PKGS, ids=["jax", "port"])
def test_create_graph_under_o2_matches_fp32(pkg):
    a = np.random.RandomState(3).randn(4, 4).astype(np.float32)

    def run(inside_amp):
        x = pkg.to_tensor(a)
        x.stop_gradient = False
        y = (pkg.matmul(x, x) ** 2).sum()
        if inside_amp:
            with pkg.amp.auto_cast(level="O2"):
                (g,) = pkg.grad(y, x, create_graph=True)
                (gg,) = pkg.grad(g.sum(), x)
        else:
            (g,) = pkg.grad(y, x, create_graph=True)
            (gg,) = pkg.grad(g.sum(), x)
        return g.numpy(), gg.numpy()

    g0, gg0 = run(False)
    g1, gg1 = run(True)
    assert g1.dtype == np.float32 and gg1.dtype == np.float32
    np.testing.assert_array_equal(g0, g1)
    np.testing.assert_array_equal(gg0, gg1)


def test_hook_casts_bare_torch_and_follows_custom_lists():
    import paddle_tpu_torch.nn.functional as F

    x = torch.randn(3, 8)
    w = torch.randn(8, 5, requires_grad=True)
    assert F.linear(x, w).dtype == torch.float32
    with tp.amp.auto_cast():
        y = F.linear(x, w)                        # white list: bf16
        assert y.dtype == torch.bfloat16
        assert F.softmax(y).dtype == torch.float32     # black list
        assert F.gelu(y).dtype == torch.bfloat16       # neither: as given
        assert port_amp_state().enabled
    assert not port_amp_state().enabled
    y.float().sum().backward()
    assert w.grad.dtype == torch.float32
    with tp.amp.auto_cast(custom_black_list={"linear"}):
        assert F.linear(x.bfloat16(), w).dtype == torch.float32
    with tp.amp.auto_cast(custom_white_list={"gelu"}, dtype="float16"):
        assert F.gelu(x).dtype == torch.float16
    with tp.amp.auto_cast(enable=False):
        assert F.linear(x, w).dtype == torch.float32
    with tp.amp.amp_guard(level="O2"):
        assert F.gelu(x).dtype == torch.bfloat16
        assert F.layer_norm(x.bfloat16(), 8).dtype == torch.float32


def _scaled_step(p, scale, x=((1.0, 2.0), (3.0, -1.0)), **kw):
    """A Linear(2, 2) with fixed weights, Momentum(0.1, momentum=0) (the
    port has no SGD yet), a GradScaler, and one
    scaled backward of sum(net(x)) (an inf in x makes the gradients
    non-finite)."""
    net = p.nn.Linear(2, 2)
    net.set_state_dict({"weight": np.array([[0.5, -1.0], [2.0, 0.25]],
                                           np.float32),
                        "bias": np.zeros(2, np.float32)})
    o = p.optimizer.Momentum(0.1, momentum=0.0, parameters=net.parameters())
    scaler = p.amp.GradScaler(init_loss_scaling=scale, **kw)
    scaler.scale(net(p.to_tensor(np.array(x, np.float32))).sum()).backward()
    return net, o, scaler


@pytest.mark.parametrize("unscale_first", [False, True],
                         ids=["step", "unscale_then_step"])
@pytest.mark.parametrize("pkg", PKGS, ids=["jax", "port"])
def test_grad_scaler_unscales_once(pkg, unscale_first):
    net, o, scaler = _scaled_step(pkg, 4.0)
    g_scaled = net.weight.grad.numpy().copy()
    if unscale_first:
        scaler.unscale_(o)
        np.testing.assert_allclose(net.weight.grad.numpy(), g_scaled / 4.0,
                                   rtol=1e-6)
    scaler.step(o)        # unscales only where unscale_ did not
    np.testing.assert_allclose(net.weight.grad.numpy(), g_scaled / 4.0,
                               rtol=1e-6)
    assert float(scaler.get_loss_scaling()) == 4.0


def test_grad_scaler_rules_match_jax():
    res = []
    for p in PKGS:
        states = []
        # growth: every 2 finite steps the scale doubles
        net, o, scaler = _scaled_step(p, 8.0, incr_every_n_steps=2)
        for _ in range(5):
            scaler.step(o)
            states.append(scaler.state_dict())
            o.clear_grad()
            scaler.scale(net(p.to_tensor(np.ones((1, 2), np.float32)))
                         .sum()).backward()
        # a non-finite gradient: no update, the scale halves
        net, o, scaler = _scaled_step(p, 8.0, x=((np.inf, 1.0), (1.0, 1.0)))
        w0 = net.weight.numpy().copy()
        scaler.step(o)
        states.append(scaler.state_dict())
        np.testing.assert_array_equal(net.weight.numpy(), w0)
        # and a finite one updates
        net, o, scaler = _scaled_step(p, 8.0)
        scaler.step(o)
        assert not np.array_equal(net.weight.numpy(), w0)
        states.append(scaler.state_dict())
        res.append(states)
    assert res[1] == res[0]
    assert [s["scale"] for s in res[1][:5]] == [8.0, 16.0, 16.0, 32.0, 32.0]
    assert res[1][5]["scale"] == 4.0 and res[1][5]["decr_count"] == 0


def test_decorate_o2_casts_the_model():
    for p in PKGS:
        net = p.nn.Linear(3, 2)
        same = p.amp.decorate(net, level="O1")
        assert same is net and _names([net.weight.dtype]) == ["float32"]
        m, o = p.amp.decorate(net, optimizers="opt", level="O2")
        assert m is net and o == "opt"
        assert _names([net.weight.dtype]) == ["bfloat16"]


def _run_amp(pkg, name, level, dtype_name):
    raw = inputs(name)
    _, kwargs, _ = SPECS[name]
    op = (JAX_OPS if pkg is jp else PORT_OPS)[name]

    def tensor(v):
        if isinstance(v, np.ndarray):
            return pkg.to_tensor(v)
        if isinstance(v, (list, tuple)) and v and isinstance(v[0],
                                                             np.ndarray):
            return type(v)(pkg.to_tensor(e) for e in v)
        return v

    args = tuple(tensor(v) for v in raw)
    try:
        with pkg.amp.auto_cast(level=level):
            out = op(*args, **kwargs)
    except Exception:   # noqa: BLE001 - compared: both packages raise
        return "raises"
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    return [dtype_name(o.dtype) if hasattr(o, "dtype") else type(o).__name__
            for o in outs]


@pytest.mark.parametrize("name", sorted(set(PORT_OPS) & set(JAX_OPS)
                                        & set(SPECS)))
def test_every_op_gives_the_jax_dtype_under_auto_cast(name):
    for level in ("O1", "O2"):
        want = _run_amp(jp, name, level, jax_dtype_name)
        got = _run_amp(tp, name, level, port_dtype_name)
        assert got == want, (level, got, want)


def test_sweep_covers_every_port_op():
    assert set(PORT_OPS) <= set(SPECS), sorted(set(PORT_OPS) - set(SPECS))


def _encoder_run(p, state, steps=3):
    """Phase 41's script at 2 layers, d_model 256, dropout 0: the losses
    and each sublayer's output dtypes in the first forward."""
    model = chip_smoke._paddle_encoder(p, 2, 256, 4, 1024, vocab=512,
                                       max_len=16, dropout=0.0)
    if state is not None:
        assert model.set_state_dict(state) == ([], [])
    seen = {}

    def hook(name):
        def record(layer, inputs, output):
            outs = output if isinstance(output, (tuple, list)) else [output]
            seen.setdefault(name, [str(o.dtype).split(".")[-1]
                                   for o in outs if hasattr(o, "dtype")])
        return record

    for name, sub in model.named_sublayers():
        sub.register_forward_post_hook(hook(name))
    opt = p.optimizer.AdamW(learning_rate=1e-3,
                            parameters=model.parameters())
    scaler = p.amp.GradScaler(init_loss_scaling=2.0 ** 10)
    ids = np.random.RandomState(7).randint(0, 512, (2, 16))
    data = [p.to_tensor(a.astype(np.int64)) for a in (
        ids, np.tile(np.arange(16), (2, 1)), np.roll(ids, -1, axis=1))]
    losses = []
    for _ in range(steps):
        with p.amp.auto_cast(level="O1", dtype="bfloat16"):
            loss = model(*data)
        scaler.scale(loss).backward()
        scaler.step(opt)
        opt.clear_grad()
        losses.append(float(loss))
    params = {k: str(v.dtype).split(".")[-1]
              for k, v in model.state_dict().items()}
    return model, losses, seen, params, scaler.state_dict()


def test_phase41_script_matches_jax_under_auto_cast():
    jp.seed(0)
    jmodel, jl, jseen, jparams, jscaler = _encoder_run(jp, None)
    # the JAX model's starting weights: build it again from the same seed
    jp.seed(0)
    start = {k: v.numpy() for k, v in chip_smoke._paddle_encoder(
        jp, 2, 256, 4, 1024, vocab=512, max_len=16,
        dropout=0.0).state_dict().items()}
    _, tl, tseen, tparams, tscaler = _encoder_run(tp, start)
    assert tseen == jseen
    assert tseen["head"] == ["bfloat16"]
    assert tseen["encoder.layers.0.norm1"] == ["float32"]
    assert set(tparams.values()) == {"float32"} and tparams == jparams
    assert tscaler == jscaler
    np.testing.assert_allclose(tl, jl, rtol=2e-2)
    assert tl[-1] < tl[0]


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_gpt_tiny_forward_under_auto_cast_matches_jax(level):
    """The port's GPT runs its projections and head as the ops "linear"
    and "matmul" inside a scope, as the JAX GPT does: bf16 logits within
    2e-2 of the largest |logit| of the JAX package's (bf16 products)."""
    from paddle_tpu.models import build_gpt as jax_build_gpt
    from paddle_tpu.models import gpt_config as jax_gpt_config
    from paddle_tpu_torch.models import build_gpt, load_jax_state

    jp.seed(7)
    jm = jax_build_gpt(jax_gpt_config(
        "gpt-tiny", max_position_embeddings=128, hidden_dropout_prob=0.0,
        attention_dropout_prob=0.0))
    jm.eval()
    pm = build_gpt("gpt-tiny", device="cpu", max_position_embeddings=128)
    load_jax_state(pm, {k: np.asarray(v._value)
                        for k, v in jm.state_dict().items()})
    ids = np.random.RandomState(0).randint(0, 1024, (2, 19)).astype(np.int64)
    with jp.amp.auto_cast(level=level):
        want = jm(jp.to_tensor(ids))
    with torch.no_grad(), tp.amp.auto_cast(level=level):
        got = pm(torch.from_numpy(ids))
    assert jax_dtype_name(want.dtype) == port_dtype_name(got.dtype) \
        == "bfloat16"
    w = want.astype("float32").numpy()
    np.testing.assert_allclose(got.float().numpy(), w, rtol=0,
                               atol=2e-2 * np.abs(w).max())
