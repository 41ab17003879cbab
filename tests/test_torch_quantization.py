"""The port's quantization against the JAX package's, on the CPU.

* ``quant_dequant``: the same values on a grid of inputs and scales, and
  the same straight-through gradients (1 inside ``|x| <= scale``, 0
  outside, 0 for the scale).
* QAT: three Adam steps of a small MLP through the fake quant, the JAX
  weights carried into the port, losses and weights to 1e-5.
* PTQ: every ``algo``'s calibrated threshold on the same batches to 1e-6
  relative (the histogram counts are equal: ``_histogram``, the device
  binning, gives ``np.histogram``'s counts), ``cal_kl_threshold`` equal on
  the same histogram, channel-wise weights beating per-tensor ones,
  AdaRound's weights on the grid with less error than nearest rounding,
  and ResNet-18 at 64^2 within the JAX acceptance rule (99% top-1
  agreement with the f32 model) with every Conv2D and the Linear
  wrapped, although its blocks are plain ``torch.nn.Module``s.
"""
import copy

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import paddle_tpu as jpaddle
import paddle_tpu.nn as jnn
from paddle_tpu import quantization as jq

import paddle_tpu_torch as paddle
from _torch_cpu_place import cpu_place  # noqa: F401
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import quantization as pq
from paddle_tpu_torch.optimizer import Adam

torch.set_num_threads(1)


def test_quant_dequant_values_and_ste_match_jax():
    rs = np.random.RandomState(0)
    x = np.concatenate([np.linspace(-3, 3, 61), rs.randn(200) * 2]).astype(
        np.float32)
    for scale in (0.5, 1.0, 2.5):
        for bits in (4, 8):
            want = jq.quant_dequant(jpaddle.to_tensor(x),
                                    jpaddle.to_tensor(np.float32(scale)),
                                    bits=bits).numpy()
            got = pq.quant_dequant(torch.from_numpy(x),
                                   torch.tensor(scale), bits=bits)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-7)
    # the surface boundary: Tensors in, Tensors out
    out = pq.quant_dequant(paddle.to_tensor(x), paddle.to_tensor(1.0))
    assert isinstance(out, paddle.Tensor)
    # STE: gradients pass inside the range, die outside; none for the scale
    xs = np.array([0.5, 2.0, -3.0, -1.0, 1.0], np.float32)
    jx = jpaddle.to_tensor(xs)
    jx.stop_gradient = False
    jq.quant_dequant(jx, jpaddle.to_tensor(np.float32(1.0))).sum().backward()
    px = torch.from_numpy(xs).requires_grad_(True)
    ps = torch.tensor(1.0, requires_grad=True)
    pq.quant_dequant(px, ps).sum().backward()
    np.testing.assert_array_equal(px.grad.numpy(), jx.grad.numpy())
    np.testing.assert_array_equal(px.grad.numpy(), [1, 0, 0, 1, 1])
    assert float(ps.grad) == 0.0


def _mlp_pair(seed=0):
    jpaddle.seed(seed)
    jnet = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4))
    pnet = pnn.Sequential(pnn.Linear(8, 16), pnn.ReLU(), pnn.Linear(16, 4))
    pnet.set_state_dict({k: np.asarray(v.numpy())
                         for k, v in jnet.state_dict().items()})
    return jnet, pnet


def test_qat_three_steps_match_jax():
    jnet, pnet = _mlp_pair()
    jnet = jq.QAT(jq.QuantConfig()).quantize(jnet)
    pnet = pq.QAT(pq.QuantConfig()).quantize(pnet)
    assert isinstance(pnet[0], pq.QuantedLinear)
    assert isinstance(pnet[2], pq.QuantedLinear)
    jopt = jpaddle.optimizer.Adam(parameters=jnet.parameters(),
                                  learning_rate=5e-3)
    popt = Adam(parameters=pnet.parameters(), learning_rate=5e-3)
    rng = np.random.default_rng(0)
    X = rng.standard_normal((32, 8)).astype("float32")
    Y = X[:, :4]
    jmse, pmse = jnn.MSELoss(), pnn.MSELoss()
    for _ in range(3):
        jl = jmse(jnet(jpaddle.to_tensor(X)), jpaddle.to_tensor(Y))
        jl.backward()
        jopt.step()
        jopt.clear_grad()
        pl = pmse(pnet(torch.from_numpy(X)), torch.from_numpy(Y))
        pl.backward()
        # the weights' STE gradients are nonzero
        assert all(float(p.grad.abs().sum()) > 0
                   for p in pnet.parameters(recurse=True)
                   if p.requires_grad)
        popt.step()
        popt.clear_grad()
        np.testing.assert_allclose(float(pl.detach()), float(jl.numpy()),
                                   rtol=1e-5)
    jsd = {k: np.asarray(v.numpy()) for k, v in jnet.state_dict().items()}
    psd = {k: v.numpy() for k, v in pnet.state_dict().items()}
    assert set(jsd) == set(psd)
    for k in jsd:
        np.testing.assert_allclose(psd[k], jsd[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    # convert: observers frozen, weights on the per-tensor int8 grid
    pq.QAT().convert(pnet)
    assert pnet[0].activation_quanter.observing is False
    w = pnet[0].inner.weight.numpy()
    grid = w / np.abs(w).max() * 127
    np.testing.assert_allclose(grid, np.round(grid), atol=1e-4)


def _outlier_data():
    rng = np.random.RandomState(0)
    bulk = rng.standard_normal(300000).astype(np.float32)
    return bulk, np.concatenate([bulk, np.array([55.0, -70.0], np.float32)])


@pytest.mark.parametrize("algo", ["kl", "hist", "mse", "avg", "abs_max"])
def test_ptq_thresholds_match_jax(algo):
    _, x = _outlier_data()

    def scale(mod, wrap):
        obs = mod.HistObserver(algo=algo)
        for chunk in np.array_split(x, 10):
            obs(wrap(np.abs(chunk)))
        obs.finalize()
        return obs

    jobs = scale(jq, jpaddle.to_tensor)
    pobs = scale(pq, torch.from_numpy)
    np.testing.assert_array_equal(pobs._hist, jobs._hist)
    assert pobs._range == jobs._range
    want = float(np.asarray(jobs.scale._value))
    got = float(pobs._buffers["scale"])
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_histogram_counts_equal_numpys():
    rs = np.random.RandomState(1)
    hi = 3.7
    edges = np.linspace(0.0, hi, 2049, dtype=np.float32)
    # values on and around every edge, the range's ends and outside it
    av = np.concatenate([
        np.abs(rs.standard_normal(50000)).astype(np.float32),
        edges, np.nextafter(edges, np.float32(0)),
        np.nextafter(edges, np.float32(10)),
        np.float32([0.0, hi, 4.0, np.nan])])
    want, _ = np.histogram(av[np.isfinite(av)], bins=2048, range=(0.0, hi))
    got = pq._histogram(torch.from_numpy(av), 2048, hi)
    np.testing.assert_array_equal(got, want)


def test_cal_kl_threshold_matches_jax():
    bulk, _ = _outlier_data()
    for rng_hi in (4.0, 9.0):
        h, _ = np.histogram(np.abs(bulk), bins=2048, range=(0, rng_hi))
        t = pq.cal_kl_threshold(h, rng_hi / 2048, 8)
        assert t == jq.cal_kl_threshold(h, rng_hi / 2048, 8)
        assert 1.0 < t <= rng_hi


def test_channel_wise_weight_quant_beats_per_tensor():
    lin = pnn.Linear(8, 4)
    w = np.random.RandomState(0).standard_normal((8, 4)).astype(np.float32)
    w[:, 0] *= 100.0                       # one loud channel
    lin.weight.set_value(w)
    m1 = pq.QuantedLinear(copy.deepcopy(lin), None, w_per_channel=False)
    m2 = pq.QuantedLinear(copy.deepcopy(lin), None, w_per_channel=True)
    pq.QAT(pq.QuantConfig()).convert(m1, inplace=True)
    pq.QAT(pq.QuantConfig(weight_quantize_type="channel_wise_abs_max")) \
        .convert(m2, inplace=True)
    err1 = np.abs(m1.inner.weight.numpy() - w)[:, 1:].max()
    err2 = np.abs(m2.inner.weight.numpy() - w)[:, 1:].max()
    assert err2 < err1 / 10, (err1, err2)


def test_adaround_beats_nearest_rounding():
    rng = np.random.RandomState(0)
    net_fp = pnn.Sequential(pnn.Linear(16, 16))
    # mid-grid weights make nearest rounding maximally ambiguous
    w = rng.standard_normal((16, 16)).astype(np.float32)
    s = np.abs(w).max(axis=0, keepdims=True) / 127.0
    w_mid = (np.floor(w / s) + 0.5 + 0.1 * rng.uniform(-1, 1, w.shape)) * s
    net_fp[0].weight.set_value(w_mid.astype(np.float32))
    xs = [torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32))
          for _ in range(3)]
    with torch.no_grad():
        fp_out = [net_fp(x).numpy() for x in xs]

    def ptq_error(rounding):
        net = copy.deepcopy(net_fp)
        ptq = pq.PTQ(algo="abs_max", weight_rounding=rounding)
        q = ptq.quantize(net, inplace=True)
        with torch.no_grad():
            for x in xs:
                q(x)
        ptq.convert(q, inplace=True)
        with torch.no_grad():
            err = sum(float(np.mean((q(x).numpy() - f) ** 2))
                      for x, f in zip(xs, fp_out))
        wq = q[0].inner.weight.numpy()
        s_pre = np.abs(w_mid).max(axis=0, keepdims=True) / 127.0
        grid = wq / s_pre
        assert np.allclose(grid, np.round(grid), atol=2e-3), rounding
        return err

    e_nearest = ptq_error("nearest")
    e_ada = ptq_error("adaround")
    assert e_ada < e_nearest * 0.9, (e_nearest, e_ada)


def test_ptq_resnet18_within_1pct_top1():
    from paddle_tpu_torch.vision.models import resnet18

    paddle.seed(0)          # the port's initializers draw from its generators
    model = resnet18(num_classes=1000, device="cpu")
    model.eval()
    rng = np.random.RandomState(0)
    imgs = [torch.from_numpy(
        rng.standard_normal((4, 3, 64, 64)).astype(np.float32))
        for _ in range(3)]
    with torch.no_grad():
        fp32_top1 = np.concatenate([model(x).argmax(-1).numpy()
                                    for x in imgs])
    ptq = pq.PTQ(algo="kl")
    qmodel = ptq.quantize(model, inplace=True)
    kinds = [type(m).__name__ for m in qmodel.modules()]
    assert kinds.count("QuantedConv2D") == 20
    assert kinds.count("QuantedLinear") == 1
    with torch.no_grad():
        for x in imgs:                         # calibration pass
            qmodel(x)
        ptq.convert(qmodel, inplace=True)
        q_top1 = np.concatenate([qmodel(x).argmax(-1).numpy()
                                 for x in imgs])
    assert float((q_top1 == fp32_top1).mean()) >= 0.99
    # every converted conv weight lies on its output channel's int8 grid
    for m in qmodel.modules():
        if isinstance(m, pq.QuantedConv2D):
            w = m.inner._parameters["weight"].detach().numpy()
            s = np.abs(w).reshape(w.shape[0], -1).max(1)
            g = w / s[:, None, None, None] * 127
            np.testing.assert_allclose(g, np.round(g), atol=1e-3)


def test_quantize_inplace_false_and_templates():
    net = pnn.Sequential(pnn.Linear(4, 4), pnn.Linear(4, 4))
    tmpl = pq.FakeQuanterWithAbsMaxObserver(moving_rate=0.5)
    q = pq.QAT(pq.QuantConfig(activation=tmpl)).quantize(net, inplace=False)
    assert isinstance(q[0], pq.QuantedLinear)
    assert isinstance(net[0], pnn.Linear)      # original untouched
    q0, q1 = q[0].activation_quanter, q[1].activation_quanter
    assert q0 is not q1 and q0 is not tmpl and q0.moving_rate == 0.5
    # the EMA observer: first batch's abs-max, then the blend
    obs = pq.FakeQuanterWithAbsMaxObserver(moving_rate=0.5)
    obs(torch.tensor([1.0, -4.0]))
    obs(torch.tensor([2.0]))
    assert float(obs._buffers["scale"]) == 3.0
    assert float(obs.scale.numpy()) == 3.0
    # nn.quant re-exports the package under the reference path
    assert pnn.quant.QAT is pq.QAT and pnn.quant.PTQ is pq.PTQ
