"""The port's ``nn`` long tail against the JAX package's, on the CPU: one
case for each test of ``tests/test_nn_extra.py``, run through both
packages on the same seeded inputs and weights (f32; values at 1e-5
relative, 1e-6 absolute, unless a case states otherwise), and
``dynamic_decode`` over a ``GRUCell`` whose token ids equal the JAX
package's and whose scores agree to 1e-5.
"""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch as tp
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from _torch_cpu_place import cpu_place  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-6)
PKGS = [(jp, jnn, JF), (tp, tnn, TF)]


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def _both(fn):
    """``fn(paddle, nn, F)`` on the JAX package, then on the port."""
    return [fn(*pkg) for pkg in PKGS]


def _np(v):
    if isinstance(v, (list, tuple)):
        return [_np(x) for x in v]
    return v.numpy() if hasattr(v, "numpy") else np.asarray(v)


def test_nn_namespace_parity_vs_jax():
    """The JAX counterpart reads the reference tree's export lists; here
    every name the JAX long-tail modules export is in the port."""
    import paddle_tpu.nn.functional.extra as jfx
    import paddle_tpu.nn.layer.extra as jlx
    for names, mod in ((jfx.__all__, TF), (jlx.__all__, tnn),
                       (["RNNCellBase", "SimpleRNNCell", "LSTMCell",
                         "GRUCell", "RNN", "BiRNN", "SimpleRNN", "LSTM",
                         "GRU"], tnn)):
        missing = sorted(n for n in names if not hasattr(mod, n))
        assert not missing, missing
    for n in ("utils", "spectral_norm", "channels_last", "abstract_init"):
        assert hasattr(tnn, n), n


def test_distance_and_margin_losses():
    rng = np.random.RandomState(0)
    a, b, c = (rng.standard_normal((4, 8)).astype(np.float32)
               for _ in range(3))
    lab = np.sign(rng.standard_normal((4, 8))).astype(np.float32)
    ml = rng.randint(0, 2, (4, 8)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, 8).astype(np.float32)

    def run(p, nn, F):
        t = [p.to_tensor(v) for v in (a, b, c, lab, ml, w)]
        return _np([F.pairwise_distance(t[0], t[1]),
                    F.pairwise_distance(t[0], t[1], p=1.0, keepdim=True),
                    F.soft_margin_loss(t[0], t[3]),
                    F.soft_margin_loss(t[0], t[3], reduction="none"),
                    F.multi_label_soft_margin_loss(t[0], t[4]),
                    F.multi_label_soft_margin_loss(t[0], t[4], t[5], "sum"),
                    F.triplet_margin_with_distance_loss(t[0], t[1], t[2],
                                                        swap=True),
                    nn.TripletMarginWithDistanceLoss(margin=3.0)(*t[:3]),
                    nn.PairwiseDistance()(t[0], t[1]),
                    nn.SoftMarginLoss()(t[0], t[3]),
                    nn.MultiLabelSoftMarginLoss(t[5])(t[0], t[4])])

    want, got = _both(run)
    for i, (g, w_) in enumerate(zip(got, want)):
        assert g.shape == w_.shape, i
        _close(g, w_)


def test_dice_npair_zeropad():
    rng = np.random.RandomState(0)
    probs = rng.dirichlet(np.ones(4), (2, 3)).astype(np.float32)
    lab = rng.randint(0, 4, (2, 3, 1)).astype(np.int64)
    anc, pos = (rng.standard_normal((6, 8)).astype(np.float32)
                for _ in range(2))
    labels = np.array([0, 0, 1, 1, 2, 2], np.int64)
    x = rng.standard_normal((1, 2, 3, 3)).astype(np.float32)

    def run(p, nn, F):
        xt = p.to_tensor(x)
        return _np([F.dice_loss(p.to_tensor(probs), p.to_tensor(lab)),
                    F.npair_loss(p.to_tensor(anc), p.to_tensor(pos),
                                 p.to_tensor(labels)),
                    F.zeropad2d(xt, [1, 0, 0, 2]),
                    F.zeropad2d(p.to_tensor(x.transpose(0, 2, 3, 1)),
                                [0, 2, 1, 1], data_format="NHWC")])

    want, got = _both(run)
    assert got[2].shape == (1, 2, 5, 4)
    for g, w in zip(got, want):
        _close(g, w)


def test_hsigmoid_loss_layer_and_grads():
    rng = np.random.RandomState(0)
    num_classes, feat = 6, 8
    x = rng.standard_normal((5, feat)).astype(np.float32)
    lab = rng.randint(0, num_classes, (5,)).astype(np.int64)
    jp.seed(0)
    jl = jnn.HSigmoidLoss(feat, num_classes)
    tl = tnn.HSigmoidLoss(feat, num_classes)
    # a non-zero bias, so its gradient path is exercised too
    state = {k: v.numpy() + (0.1 if k == "bias" else 0.0)
             for k, v in jl.state_dict().items()}
    jl.set_state_dict(state)
    assert tl.set_state_dict(state) == ([], [])
    out = []
    for p, layer in ((jp, jl), (tp, tl)):
        xt = p.to_tensor(x, stop_gradient=False)
        loss = layer(xt, p.to_tensor(lab))
        loss.sum().backward()
        out.append([loss.numpy(), xt.grad.numpy(), layer.weight.grad.numpy(),
                    layer.bias.grad.numpy()])
    assert out[1][0].shape == (5, 1) and np.all(out[1][0] > 0)
    for g, w in zip(out[1], out[0]):
        _close(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("margins", [(1.0, 0.0, 0.0, 1.0),
                                     (1.0, 0.5, 0.0, 64.0),
                                     (0.9, 0.4, 0.1, 8.0)])
def test_margin_cross_entropy(margins):
    m1, m2, m3, s = margins
    rng = np.random.RandomState(0)
    logits = np.clip(rng.standard_normal((4, 10)), -1, 1).astype(np.float32)
    lab = rng.randint(0, 10, (4,)).astype(np.int64)

    def run(p, nn, F):
        lt = p.to_tensor(logits, stop_gradient=False)
        loss, sm = F.margin_cross_entropy(
            lt, p.to_tensor(lab), margin1=m1, margin2=m2, margin3=m3,
            scale=s, return_softmax=True)
        loss.backward()
        return _np([loss, sm, lt.grad])

    want, got = _both(run)
    for g, w in zip(got, want):
        _close(g, w, rtol=1e-5, atol=1e-5)


def test_sparse_attention_full_and_banded_patterns():
    rng = np.random.RandomState(0)
    b, h, L, d = 1, 2, 4, 8
    q, k, v = (rng.standard_normal((b, h, L, d)).astype(np.float32)
               for _ in range(3))
    full = (np.tile(np.arange(0, L * L + 1, L), (b, h, 1)),
            np.tile(np.tile(np.arange(L), L), (b, h, 1)))
    band = (np.tile(np.arange(0, L + 1), (b, h, 1)),
            np.tile(np.arange(L), (b, h, 1)))

    def run(p, nn, F):
        t = [p.to_tensor(a) for a in (q, k, v)]
        return _np([F.sparse_attention(*t, p.to_tensor(o.astype(np.int64)),
                                       p.to_tensor(c.astype(np.int64)))
                    for o, c in (full, band)])

    want, got = _both(run)
    for g, w in zip(got, want):
        _close(g, w)
    _close(got[1], v, rtol=1e-5, atol=1e-6)


def test_max_unpool_1d_2d_3d_roundtrip():
    rng = np.random.RandomState(0)
    x1 = rng.standard_normal((2, 3, 8)).astype(np.float32)
    x2 = rng.standard_normal((2, 3, 6, 6)).astype(np.float32)
    x3 = rng.standard_normal((1, 2, 4, 4, 4)).astype(np.float32)

    def run(p, nn, F):
        p1, i1 = F.max_pool1d(p.to_tensor(x1), 2, stride=2, return_mask=True)
        p2, i2 = F.max_pool2d(p.to_tensor(x2), 2, stride=2, return_mask=True)
        p3, i3 = F.max_pool3d(p.to_tensor(x3), 2, stride=2, return_mask=True)
        return _np([F.max_unpool1d(p1, i1, 2, stride=2),
                    nn.MaxUnPool1D(2, stride=2)(p1, i1),
                    F.max_unpool2d(p2, i2, 2),
                    nn.MaxUnPool2D(2)(p2, i2),
                    F.max_unpool3d(p3, i3, 2, stride=2),
                    nn.MaxUnPool3D(2, stride=2)(p3, i3)])

    want, got = _both(run)
    assert got[0].shape == (2, 3, 8) and got[4].shape == (1, 2, 4, 4, 4)
    assert got[0].max() == pytest.approx(x1.max())
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w)


def _linear_pair(seed, i, o):
    jp.seed(seed)
    jl = jnn.Linear(i, o)
    tl = tnn.Linear(i, o)
    tl.set_state_dict({k: v.numpy() for k, v in jl.state_dict().items()})
    return jl, tl


@pytest.mark.parametrize("dim", [0, -1, None])
def test_weight_norm(dim):
    x = np.random.RandomState(1).standard_normal((2, 6)).astype(np.float32)
    res = []
    for (p, nn, F), lin in zip(PKGS, _linear_pair(0, 6, 4)):
        w0 = lin.weight.numpy().copy()
        b0 = lin.bias.numpy().copy()
        nn.utils.weight_norm(lin, "weight", dim=dim)
        names = sorted(dict(lin.named_parameters()))
        xt = p.to_tensor(x)
        y1 = lin(xt).numpy()
        (lin(xt) ** 2).sum().backward()
        grads = [lin.weight_g.grad.numpy(), lin.weight_v.grad.numpy()]
        g_shape = list(lin.weight_g.shape)
        nn.utils.remove_weight_norm(lin, "weight")
        res.append([names, y1, grads, g_shape, lin.weight.numpy(), w0, b0,
                    sorted(dict(lin.named_parameters()))])
    (jn, jy, jg, js, jw, _, _, jn2), (tn, ty, tg, ts, tw, tw0, tb0, tn2) = res
    assert tn == jn == ["bias", "weight_g", "weight_v"]
    assert ts == js and tn2 == jn2 == ["bias", "weight"]
    _close(ty, jy)
    _close(ty, x @ tw0 + tb0, rtol=1e-5, atol=1e-5)
    for g, w in zip(tg, jg):
        _close(g, w, rtol=1e-5, atol=1e-5)
    _close(tw, jw)
    _close(tw, tw0, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("iters", [1, 0, 3])
def test_spectral_norm(iters):
    x = np.random.RandomState(2).standard_normal((2, 6)).astype(np.float32)
    res = []
    for (p, nn, F), lin in zip(PKGS, _linear_pair(3, 6, 4)):
        nn.utils.spectral_norm(lin, "weight", n_power_iterations=iters)
        xt = p.to_tensor(x)
        y = lin(xt).numpy()
        (lin(xt) ** 2).sum().backward()
        res.append([y, lin.weight.numpy(), lin.weight_orig.grad.numpy(),
                    sorted(dict(lin.named_parameters()))])
    (jy, jw, jg, jn), (ty, tw, tg, tn) = res
    assert tn == jn == ["bias", "weight_orig"]
    for g, w in ((ty, jy), (tw, jw), (tg, jg)):
        _close(g, w, rtol=1e-5, atol=1e-5)
    if iters:
        assert np.linalg.svd(tw, compute_uv=False)[0] == pytest.approx(
            1.0, rel=0.2)


def test_clip_and_vector_utils():
    x = np.ones((2, 4), np.float32)
    res = []
    for (p, nn, F), lin in zip(PKGS, _linear_pair(0, 4, 3)):
        (lin(p.to_tensor(x)) ** 2).sum().backward()
        total = nn.utils.clip_grad_norm_(lin.parameters(), 0.1)
        clipped = [q.grad.numpy().copy() for q in lin.parameters()]
        nn.utils.clip_grad_value_(lin.parameters(), 0.01)
        valued = [q.grad.numpy() for q in lin.parameters()]
        vec = nn.utils.parameters_to_vector(lin.parameters())
        nn.utils.vector_to_parameters(vec * 0 + 1.0, lin.parameters())
        res.append([float(total), clipped, valued, vec.numpy(),
                    [q.numpy() for q in lin.parameters()]])
    (jt, jc, jv, jvec, jps), (tt, tc, tv, tvec, tps) = res
    assert tt == pytest.approx(jt, rel=1e-6)
    gn = np.sqrt(sum((g ** 2).sum() for g in tc))
    assert gn == pytest.approx(0.1, rel=1e-3)
    for a, b in zip(tc + tv + [tvec] + tps, jc + jv + [jvec] + jps):
        _close(a, b)
    assert tvec.shape == (4 * 3 + 3,) and all(np.all(q == 1) for q in tps)


def _greedy_cell(p, V):
    def cell(inp, states):
        tok = inp.numpy().reshape(-1)
        logits = -10.0 * np.ones((tok.shape[0], V), np.float32)
        logits[np.arange(tok.shape[0]), (tok + 1) % V] = 10.0
        return p.to_tensor(logits), states
    return cell


def test_beam_search_decoder_greedy_path():
    V = 5
    res = []
    for p, nn, F in PKGS:
        dec = nn.BeamSearchDecoder(_greedy_cell(p, V), start_token=0,
                                   end_token=3, beam_size=2)
        ids, scores, lengths = nn.dynamic_decode(
            dec, None, max_step_num=6, batch_size=2, return_length=True)
        res.append([ids.numpy(), scores.numpy(), lengths.numpy()])
    (ji, js, jl), (ti, ts, tl) = res
    assert ti[0, :, 0].tolist()[:3] == [1, 2, 3]
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tl, jl)
    _close(ts, js)


@pytest.mark.parametrize("time_major", [False, True])
def test_dynamic_decode_over_gru_cell_matches_jax(time_major):
    """A GRUCell decoder with an embedding and an output projection: the
    output weights are scaled so every step's top-k candidates are
    separated by far more than f32 rounding (the test checks the JAX
    run's margins), so argsort picks the same beams in both packages."""
    V, E, H, k, b = 12, 8, 16, 3, 2
    jp.seed(5)
    jparts = (jnn.Embedding(V, E), jnn.GRUCell(E, H), jnn.Linear(H, V))
    with_scale = []
    for jl in jparts:
        sd = {n: v.numpy() * (4.0 if jl is jparts[2] else 1.0)
              for n, v in jl.state_dict().items()}
        jl.set_state_dict(sd)
        with_scale.append(sd)
    tparts = (tnn.Embedding(V, E), tnn.GRUCell(E, H), tnn.Linear(H, V))
    for tl, sd in zip(tparts, with_scale):
        assert tl.set_state_dict(sd) == ([], [])
    margins = []

    def watch(step):
        def wrapped(tokens, states):
            logp, new = step(tokens, states)
            top = np.sort(logp, axis=-1)[:, ::-1]
            margins.append(float(np.min(top[:, :k + 1][:, :-1]
                                        - top[:, 1:k + 1])))
            return logp, new
        return wrapped

    res = []
    for (p, nn, F), (emb, cell, out) in zip(PKGS, (jparts, tparts)):
        dec = nn.BeamSearchDecoder(cell, start_token=1, end_token=0,
                                   beam_size=k, embedding_fn=emb,
                                   output_fn=out)
        if p is jp:
            dec.step = watch(dec.step)
        inits = p.to_tensor(np.zeros((b * k, H), np.float32))
        ids, scores, lengths = nn.dynamic_decode(
            dec, inits, max_step_num=7, batch_size=b,
            output_time_major=time_major, return_length=True)
        res.append([ids.numpy(), scores.numpy(), lengths.numpy()])
    assert min(margins) > 1e-3, margins
    (ji, js, jl), (ti, ts, tl) = res
    assert ti.shape == ji.shape and ti.shape[-1] == k
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tl, jl)
    _close(ts, js, rtol=1e-5, atol=1e-5)


def test_softmax2d_thresholded_relu_and_in_place_forms():
    rng = np.random.RandomState(0)
    x = rng.standard_normal((2, 3, 4, 4)).astype(np.float32)
    y0 = np.array([0.5, 2.0, -1.0], np.float32)

    def run(p, nn, F):
        xt = p.to_tensor(x)
        outs = [nn.Softmax2D()(xt), nn.ThresholdedReLU(1.0)(xt),
                F.thresholded_relu(xt, 0.5)]
        for fn, kw in ((F.tanh_, {}), (F.elu_, {"alpha": 0.7}),
                       (F.softmax_, {"axis": 0})):
            y = p.to_tensor(y0)
            same = fn(y, **kw)
            assert same is y
            outs.append(y)
        return _np(outs)

    want, got = _both(run)
    _close(got[0].sum(axis=1), np.ones((2, 4, 4)), rtol=1e-5, atol=1e-6)
    assert float(got[1][x <= 1.0].sum()) == 0.0
    for g, w in zip(got, want):
        _close(g, w)
