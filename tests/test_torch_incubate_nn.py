"""The port's fused transformer family (``incubate.nn`` and its
functional forms), the softmax-mask fusions and ``ResNetUnit`` against
the JAX package, on the CPU.

The same seeded numpy inputs and weights go through both packages, the
JAX side at ``jax_default_matmul_precision`` "highest"
(``tests/conftest.py``).  Layers carry the JAX layer's numpy state dict
(``set_state_dict``; ``FusedMoELayer`` through ``models.load_jax_state``,
which turns its torch ``Linear`` gate's weight).  Tolerances, all f32:

* outputs, caches and gradients of the fused functionals and layers:
  rtol 1e-5 with an absolute floor of 1e-5 of the largest value compared
  (the same sums, in another order);
* the softmax-mask fusions: rtol 1e-5, atol 1e-7 (one f32 softmax);
* ``resnet_unit``: outputs and running statistics, rtol 1e-5 with the
  same floor (a convolution's sums).

The attention core runs the port's flash wrapper's plain version here
(CPU tensors) and the JAX package's ``_sdpa_ref`` (queries shorter than
128); a decode step is one query over ``time_step + 1`` keys.  The spec
is ``tests/test_legacy_namespaces.py:161-240, 247-370`` and
``tests/test_moe.py:191-235``.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as jpaddle
import paddle_tpu.incubate.nn as jinn
from paddle_tpu.incubate import operators as jops
from paddle_tpu.incubate.nn import functional as JF

import paddle_tpu_torch as paddle
import paddle_tpu_torch.incubate.nn as pinn
from paddle_tpu_torch.incubate import operators as pops
from paddle_tpu_torch.incubate.nn import functional as PF
from paddle_tpu_torch.models import load_jax_state
from _torch_cpu_place import cpu_place  # noqa: F401,E402

torch.set_num_threads(1)


def _np(v):
    if isinstance(v, (jpaddle.Tensor, paddle.Tensor)):
        return v.numpy()
    if torch.is_tensor(v):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _close(got, want, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    floor = 1e-5 * max(float(np.abs(want).max()), 1.0) if want.size else 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=floor,
                               err_msg=what)


def _pair(arr, grad=False):
    """The same numpy array as a JAX and a port Tensor."""
    j, p = jpaddle.to_tensor(arr), paddle.to_tensor(arr)
    if grad:
        j.stop_gradient = False
        p.stop_gradient = False
    return j, p


B, S, E, NH = 2, 6, 32, 4
HD = E // NH


def _weights(seed, grad=False, layers=1):
    """Per-layer weights of one fused transformer layer, as (JAX, port)
    Tensor pairs in lists of ``layers``."""
    rs = np.random.RandomState(seed)

    def draw(*shape, scale=0.1, base=0.0):
        return [_pair((base + rs.standard_normal(shape) * scale).astype(
            np.float32), grad) for _ in range(layers)]

    return dict(
        ln_s=draw(E, base=1.0), ln_b=draw(E), qkv_w=draw(3, NH, HD, E),
        qkv_b=draw(3, NH, HD), lin_w=draw(E, E), lin_b=draw(E),
        ffn_ln_s=draw(E, base=1.0), ffn_ln_b=draw(E), f1_w=draw(E, 4 * E),
        f1_b=draw(4 * E), f2_w=draw(4 * E, E), f2_b=draw(E))


def _side(w, i):
    return {k: [pair[i] for pair in v] for k, v in w.items()}


def _mt_args(w):
    return [w[k] for k in ("ln_s", "ln_b", "qkv_w", "qkv_b", "lin_w",
                           "lin_b", "ffn_ln_s", "ffn_ln_b", "f1_w", "f1_b",
                           "f2_w", "f2_b")]


# -- the functional forms -----------------------------------------------------

@pytest.mark.parametrize("pre_ln, cache", [
    (True, "none"), (False, "empty"), (False, "past")])
def test_fused_multi_head_attention_matches_jax(pre_ln, cache):
    rs = np.random.RandomState(0)
    x = rs.standard_normal((B, S, E)).astype(np.float32)
    w = _weights(1, grad=True)
    past = {"none": None, "empty": 0, "past": 5}[cache]
    kv = None if past is None else rs.standard_normal(
        (2, B, NH, past, HD)).astype(np.float32)
    g = rs.standard_normal((B, S, E)).astype(np.float32)
    outs, grads = [], []
    for i, mod in enumerate((JF, PF)):
        xs = _pair(x, grad=True)[i]
        side = _side(w, i)
        kw = dict(pre_layer_norm=pre_ln, qkv_bias=side["qkv_b"][0],
                  linear_bias=side["lin_b"][0], dropout_rate=0.0,
                  attn_dropout_rate=0.0, training=True)
        if pre_ln:
            kw.update(pre_ln_scale=side["ln_s"][0],
                      pre_ln_bias=side["ln_b"][0])
        else:
            kw.update(ln_scale=side["ln_s"][0], ln_bias=side["ln_b"][0])
        if kv is not None:
            kw["cache_kv"] = _pair(kv)[i]
        out = mod.fused_multi_head_attention(
            xs, side["qkv_w"][0], side["lin_w"][0], **kw)
        if kv is not None:
            out, new_cache = out
            assert list(new_cache.shape) == [2, B, NH, past + S, HD]
            outs.append(new_cache)
        (out * _pair(g)[i]).sum().backward()
        outs.append(out)
        grads.append([xs.grad] + [side[k][0].grad for k in (
            "qkv_w", "qkv_b", "lin_w", "lin_b", "ln_s", "ln_b")])
    n = len(outs) // 2
    for a, b in zip(outs[n:], outs[:n]):
        _close(a, b, "out / cache")
    for a, b in zip(grads[1], grads[0]):
        assert a is not None and b is not None
        _close(a, b, "gradient")


def test_empty_cache_reproduces_the_uncached_output():
    rs = np.random.RandomState(2)
    x = paddle.to_tensor(rs.standard_normal((B, S, E)).astype(np.float32))
    side = _side(_weights(3), 1)
    kw = dict(pre_layer_norm=True, pre_ln_scale=side["ln_s"][0],
              pre_ln_bias=side["ln_b"][0], qkv_bias=side["qkv_b"][0],
              linear_bias=side["lin_b"][0], dropout_rate=0.0,
              attn_dropout_rate=0.0, training=False)
    out = PF.fused_multi_head_attention(x, side["qkv_w"][0], side["lin_w"][0],
                                        **kw)
    out2, newc = PF.fused_multi_head_attention(
        x, side["qkv_w"][0], side["lin_w"][0],
        cache_kv=paddle.to_tensor(np.zeros((2, B, NH, 0, HD), np.float32)),
        **kw)
    np.testing.assert_allclose(out2.numpy(), out.numpy(), rtol=1e-6)
    assert list(newc.shape) == [2, B, NH, S, HD]


@pytest.mark.parametrize("trans_qkvw", [True, False])
@pytest.mark.parametrize("pre_ln", [True, False])
def test_fused_multi_transformer_matches_jax(pre_ln, trans_qkvw):
    x = np.random.RandomState(4).standard_normal((B, S, E)).astype(
        np.float32)
    w = _weights(5, grad=True, layers=2)
    if not trans_qkvw:                     # [3, nh, hd, e] -> [e, 3, nh, hd]
        w["qkv_w"] = [_pair(np.ascontiguousarray(
            _np(j).transpose(3, 0, 1, 2)), True) for j, _ in w["qkv_w"]]
    outs, grads = [], []
    for i, mod in enumerate((JF, PF)):
        xs = _pair(x, grad=True)[i]
        side = _side(w, i)
        out = mod.fused_multi_transformer(
            xs, *_mt_args(side), pre_layer_norm=pre_ln, dropout_rate=0.0,
            trans_qkvw=trans_qkvw, training=True)
        out.sum().backward()
        outs.append(out)
        grads.append([xs.grad] + [side[k][j].grad for k in side
                                  for j in range(2)])
    _close(outs[1], outs[0], "out")
    for a, b in zip(grads[1], grads[0]):
        assert a is not None and b is not None
        _close(a, b, "gradient")


def test_fused_multi_transformer_serves_like_jax():
    """A 4-token prompt with a causal mask into fixed-size caches, then
    a decode step of one token with ``time_step``: every step's
    output and grown cache equal JAX's."""
    rs = np.random.RandomState(6)
    w = _weights(7, layers=2)
    prompt = rs.standard_normal((B, 4, E)).astype(np.float32)
    steps = rs.standard_normal((1, B, 1, E)).astype(np.float32)
    causal = np.where(np.tril(np.ones((4, 4), bool)), 0.0,
                      -1e4).astype(np.float32)
    max_len = 8
    results = []
    for i, mod in enumerate((JF, PF)):
        side = _side(w, i)
        caches = [np.zeros((2, B, NH, max_len, HD), np.float32)
                  for _ in range(2)]
        got = []
        out, new = mod.fused_multi_transformer(
            _pair(prompt)[i], *_mt_args(side),
            cache_kvs=[_pair(c)[i] for c in caches], time_step=0,
            attn_mask=_pair(causal)[i], dropout_rate=0.0, training=False)
        got.append(out)
        for c, n in zip(caches, new):
            c[:, :, :, :4] = _np(n)
        for t, xs in enumerate(steps, start=4):
            out, new = mod.fused_multi_transformer(
                _pair(xs)[i], *_mt_args(side),
                cache_kvs=[_pair(c)[i] for c in caches], time_step=t,
                dropout_rate=0.0, training=False)
            assert all(list(n.shape) == [2, B, NH, t + 1, HD] for n in new)
            got += [out] + list(new)
            for c, n in zip(caches, new):
                c[:, :, :, t] = _np(n)[:, :, :, t]
        results.append(got)
    assert len(results[0]) == len(results[1]) == 4
    for a, b in zip(results[1], results[0]):
        _close(a, b, "serving")


def test_time_step_reads_only_the_cache_prefix():
    rs = np.random.RandomState(8)
    side = _side(_weights(9), 1)
    x = paddle.to_tensor(rs.standard_normal((B, S, E)).astype(np.float32))
    garbage = rs.standard_normal((2, B, NH, 10, HD)).astype(np.float32)
    out4, _ = PF.fused_multi_transformer(
        x, *_mt_args(side), cache_kvs=[paddle.to_tensor(garbage)],
        time_step=0, dropout_rate=0.0, training=False)
    out5, _ = PF.fused_multi_transformer(
        x, *_mt_args(side),
        cache_kvs=[paddle.to_tensor(np.zeros((2, B, NH, 0, HD), np.float32))],
        dropout_rate=0.0, training=False)
    np.testing.assert_allclose(out4.numpy(), out5.numpy(), rtol=1e-6)


@pytest.mark.parametrize("pre_ln", [True, False])
def test_fused_feedforward_and_bias_dropout_residual_ln_match_jax(pre_ln):
    rs = np.random.RandomState(10)
    x = rs.standard_normal((B, S, E)).astype(np.float32)
    r = rs.standard_normal((B, S, E)).astype(np.float32)
    w = _weights(11, grad=True)
    outs, grads = [], []
    for i, mod in enumerate((JF, PF)):
        xs, rs_ = _pair(x, True)[i], _pair(r, True)[i]
        side = _side(w, i)
        ff = mod.fused_feedforward(
            xs, side["f1_w"][0], side["f1_b"][0], side["f2_w"][0],
            side["f2_b"][0], ln1_scale=side["ffn_ln_s"][0],
            ln1_bias=side["ffn_ln_b"][0], ln2_scale=side["ln_s"][0],
            ln2_bias=side["ln_b"][0], dropout1_rate=0.0, dropout2_rate=0.0,
            activation="gelu", pre_layer_norm=pre_ln, training=True)
        bd = mod.fused_bias_dropout_residual_layer_norm(
            ff, rs_, bias=side["lin_b"][0], ln_scale=side["ln_s"][0],
            ln_bias=side["ln_b"][0], dropout_rate=0.0, training=True)
        bd.sum().backward()
        outs.append([ff, bd])
        grads.append([xs.grad, rs_.grad] + [side[k][0].grad for k in (
            "f1_w", "f1_b", "f2_w", "f2_b", "lin_b", "ln_s")])
    for a, b in zip(outs[1] + grads[1], outs[0] + grads[0]):
        _close(a, b)


@pytest.mark.parametrize("tx, ty", [(False, False), (True, False),
                                    (False, True), (True, True)])
def test_fused_matmul_bias_and_linear_match_jax(tx, ty):
    rs = np.random.RandomState(12)
    x = rs.standard_normal((B, E, S) if tx else (B, S, E)).astype(np.float32)
    y = rs.standard_normal((8, E) if ty else (E, 8)).astype(np.float32)
    bias = rs.standard_normal(8).astype(np.float32)
    got = [mod.fused_matmul_bias(_pair(x)[i], _pair(y)[i], _pair(bias)[i],
                                 transpose_x=tx, transpose_y=ty)
           for i, mod in enumerate((JF, PF))]
    _close(got[1], got[0])
    if not tx:
        lin = [mod.fused_linear(_pair(x)[i], _pair(y)[i],
                                transpose_weight=ty)
               for i, mod in enumerate((JF, PF))]
        _close(lin[1], lin[0])
        assert list(lin[1].shape) == [B, S, 8]


def test_functionals_take_bare_torch_tensors():
    """The models call the functionals on torch tensors: torch in, torch
    out, gradients on the leaves."""
    rs = np.random.RandomState(13)
    side = _side(_weights(14), 1)
    args = [[t._value.clone().requires_grad_(True) for t in v]
            for v in _mt_args(side)]
    x = torch.from_numpy(rs.standard_normal((B, S, E)).astype(np.float32))
    out = PF.fused_multi_transformer(x, *args, dropout_rate=0.0)
    assert type(out) is torch.Tensor and out.shape == (B, S, E)
    out.sum().backward()
    assert all(a[0].grad is not None for a in args)


# -- the layers ---------------------------------------------------------------

def _layer_pair(name, *args, **kwargs):
    jpaddle.seed(2)
    jl = getattr(jinn, name)(*args, **kwargs)
    pl = getattr(pinn, name)(*args, **kwargs)
    state = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    if name == "FusedMoELayer":
        load_jax_state(pl, state)
    else:
        assert pl.set_state_dict(state) == ([], [])
    return jl, pl


LAYERS = [
    ("FusedMultiHeadAttention", (E, NH), dict(dropout_rate=0.0,
                                             attn_dropout_rate=0.0)),
    ("FusedMultiHeadAttention", (E, NH), dict(dropout_rate=0.0,
                                             attn_dropout_rate=0.0,
                                             normalize_before=True)),
    ("FusedFeedForward", (E, 4 * E), dict(dropout_rate=0.0)),
    ("FusedFeedForward", (E, 4 * E), dict(dropout_rate=0.0, activation="gelu",
                                       normalize_before=True)),
    ("FusedTransformerEncoderLayer", (E, NH, 4 * E), dict(dropout_rate=0.0)),
    ("FusedMultiTransformer", (E, NH, 4 * E), dict(num_layers=2)),
    ("FusedBiasDropoutResidualLayerNorm", (E,), dict(dropout_rate=0.0)),
    ("FusedMoELayer", (E, 64), dict(num_expert=4, top_k=2)),
]


@pytest.mark.parametrize("name, args, kwargs", LAYERS,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(LAYERS)])
def test_fused_layer_matches_jax(name, args, kwargs):
    jl, pl = _layer_pair(name, *args, **kwargs)
    jl.eval()
    pl.eval()
    rs = np.random.RandomState(15)
    x = rs.standard_normal((B, S, E)).astype(np.float32)
    g = rs.standard_normal((B, S, E)).astype(np.float32)
    n_in = 2 if name == "FusedBiasDropoutResidualLayerNorm" else 1
    outs = []
    for i, layer in enumerate((jl, pl)):
        out = layer(*[_pair(x)[i]] * n_in)
        outs.append(out)
    _close(outs[1], outs[0], "out")
    if name == "FusedMoELayer":
        # forward parity only (the JAX MoE backward alone takes seconds to
        # trace); gradients reach the port's norm, gate and experts
        (outs[1] * _pair(g)[1]).sum().backward()
        assert sum(p.grad is not None for p in pl.parameters()) >= 4
        return
    for i, out in enumerate(outs):
        (out * _pair(g)[i]).sum().backward()
    jgrads = {k: p.grad for k, p in jl.named_parameters()}
    checked = 0
    for k, p in pl.named_parameters():
        if jgrads.get(k) is None:
            assert p.grad is None or not np.abs(p.grad.numpy()).any(), k
            continue
        want = _np(jgrads[k])
        got = p.grad.numpy()
        if got.shape != want.shape:          # the MoE gate's torch Linear
            got = got.T
        _close(got, want, k)
        checked += 1
    assert checked == sum(g is not None for g in jgrads.values()) >= 3


def test_fused_attention_is_self_attention_only():
    attn = pinn.FusedMultiHeadAttention(E, NH, dropout_rate=0.0,
                                        attn_dropout_rate=0.0)
    x = paddle.to_tensor(np.zeros((B, S, E), np.float32))
    with pytest.raises(NotImplementedError):
        attn(x, key=x)
    with pytest.raises(NotImplementedError):
        attn(x, cache=object())


@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_fused_moe_gate_follows_top_k_as_in_jax(top_k):
    """``top_k`` picks the gate (Switch, GShard, naive top-k) as the JAX
    layer does; the outputs agree at ``top_k=2`` above."""
    jpaddle.seed(2)
    jg = jinn.FusedMoELayer(E, 64, num_expert=4, top_k=top_k).moe.gate
    pg = pinn.FusedMoELayer(E, 64, num_expert=4, top_k=top_k).moe.gate
    assert type(pg).__name__ == type(jg).__name__
    assert pg.top_k == jg.top_k == top_k


def test_fused_moe_refuses_weight_injection():
    w = paddle.to_tensor(np.zeros((E, 4), np.float32))
    with pytest.raises(NotImplementedError):
        pinn.FusedMoELayer(E, 64, num_expert=4, gate_weight=w)
    with pytest.raises(NotImplementedError):
        pinn.FusedMoELayer(E, 64, num_expert=4, mp_group=object())


# -- incubate.operators: the softmax-mask fusions and ResNetUnit --------------

def test_softmax_mask_fuse_matches_jax():
    rs = np.random.RandomState(16)
    x = rs.standard_normal((2, 3, 8, 8)).astype(np.float32)
    mask = np.where(rs.rand(2, 1, 8, 8) > 0.5, 0.0, -10000.0).astype(
        np.float32)
    got = [mod.softmax_mask_fuse(_pair(x)[i], _pair(mask)[i])
           for i, mod in enumerate((jops, pops))]
    np.testing.assert_allclose(got[1].numpy(), got[0].numpy(), rtol=1e-5,
                               atol=1e-7)
    up = [mod.softmax_mask_fuse_upper_triangle(_pair(x)[i])
          for i, mod in enumerate((jops, pops))]
    np.testing.assert_allclose(up[1].numpy(), up[0].numpy(), rtol=1e-5,
                               atol=1e-7)
    # future positions take finfo.min, not -inf: exactly 0 after exp
    assert not up[1].numpy()[..., 0, 1:].any()
    np.testing.assert_allclose(up[1].numpy().sum(-1), 1.0, rtol=1e-6)


@pytest.mark.parametrize("mode, data_format", [
    ("shortcut", "NHWC"), ("fuse_add", "NHWC"), ("test", "NCHW")])
def test_resnet_unit_matches_jax(mode, data_format):
    kw = dict(num_channels_x=8, num_filters=16, filter_size=3, stride=2,
              data_format=data_format, fuse_add=mode == "fuse_add",
              has_shortcut=mode == "shortcut", num_channels_z=8, stride_z=2,
              is_test=mode == "test")
    jpaddle.seed(0)
    ju = jops.ResNetUnit(**kw)
    pu = pops.ResNetUnit(**kw)
    rs = np.random.RandomState(17)
    state = {k: np.asarray(v.numpy()) for k, v in ju.state_dict().items()}
    if mode == "test":                       # running statistics in use
        for k in state:
            if k.startswith(("mean", "var")):
                state[k] = rs.uniform(0.5, 1.5, state[k].shape).astype(
                    np.float32)
    ju.set_state_dict(state)
    assert pu.set_state_dict(state) == ([], [])
    x = rs.standard_normal((2, 8, 8, 8)).astype(np.float32)
    # the shortcut's input, or (fuse_add) the output-shaped addend
    z = rs.standard_normal((2, 8, 8, 8) if mode != "fuse_add" else
                           (2, 16, 4, 4) if data_format == "NCHW" else
                           (2, 4, 4, 16)).astype(np.float32)
    outs = [unit(_pair(x)[i], _pair(z)[i])
            for i, unit in enumerate((ju, pu))]
    _close(outs[1], outs[0], "out")
    assert float(outs[1].numpy().min()) >= 0.0
    for k, v in ju.state_dict().items():
        if k.startswith(("mean", "var")):
            _close(pu.state_dict()[k], v, k)


# -- GPT's blocks through fused_multi_transformer (smoke phase 54's path) -----

def _gpt_fused_lists(model):
    """A port GPT's blocks as the fused op's twelve per-layer lists,
    written here apart from ``chip_smoke._fused_lists``: GPT's qkv rows are
    head-major ``[nh, 3, hd]``, the fused op's weight ``[3, nh, hd, e]``."""
    lists = [[] for _ in range(12)]
    for layer in model.gpt.layers:
        att, mlp = layer.self_attn, layer.mlp
        nh, hd = att.num_heads, att.head_dim
        w = att.qkv_proj.weight.detach().reshape(nh, 3, hd, nh * hd)
        b = att.qkv_proj.bias.detach().reshape(nh, 3, hd)
        vals = [layer.norm1.weight.value, layer.norm1.bias.value,
                torch.stack([w[:, r] for r in range(3)]),
                torch.stack([b[:, r] for r in range(3)]),
                att.out_proj.weight.t(), att.out_proj.bias,
                layer.norm2.weight.value, layer.norm2.bias.value,
                mlp.fc0.weight.t(), mlp.fc0.bias, mlp.fc1.weight.t(),
                mlp.fc1.bias]
        for dst, v in zip(lists, vals):
            dst.append(v.detach())
    return lists


def test_gpt_blocks_serve_through_fused_multi_transformer():
    """gpt-tiny's blocks carried into the fused lists: a causal prefill and
    five decode steps with ``time_step`` give the GPT's own greedy tokens
    and, through its final LayerNorm and tied head, its no-cache logits
    (rtol 1e-5, floor 1e-5 of the largest); the same lists as the smoke's
    phase 54 builds."""
    import chip_smoke
    from paddle_tpu_torch.models import build_gpt

    model = build_gpt("gpt-tiny", device="cpu", seed=3,
                      hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    lists = _gpt_fused_lists(model)
    for mine, smoke in zip(lists, chip_smoke._fused_lists(model)):
        assert all(torch.equal(a, b) for a, b in zip(mine, smoke))
    prompt = torch.from_numpy(np.random.RandomState(4).randint(
        0, model.config.vocab_size, (2, 8)))
    toks, hidden = chip_smoke._fused_decode(model, lists, prompt, 5, 13)
    assert toks.shape == (2, 6) and len(hidden) == 5
    chip_smoke._greedy_gate(model, prompt, toks)      # SystemExit if unequal
    with torch.no_grad():
        want = model(torch.cat([prompt, toks[:, :-1]], 1))[:, 8:]
        gpt = model.gpt
        got = model.lm_head(gpt.final_norm(torch.stack(hidden, 1)))
    _close(got, want, "logits")
