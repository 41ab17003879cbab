"""The port's ``incubate.optimizer`` (``LookAhead``, ``ModelAverage``,
``DistributedFusedLamb``) against the JAX package's, on the CPU.

The same ``Linear`` weights (the JAX layer's numpy state dict) and the
same batches go through both packages' eager loops (``backward``,
``step``, ``clear_grad``).  Tolerances, f32: losses rtol 1e-5 and
weights rtol 1e-5 with an absolute floor of 1e-6 (the same updates;
matmul sums in another order).  ``LookAhead``'s slow weights start at
the initial fast weights and its ``state_dict`` carries
``@lookahead_step``; ``ModelAverage.apply()`` puts the window's average
in place and restores the live weights on exit; ``DistributedFusedLamb``
is ``Lamb`` with ``_sharding_stage == 1``.  The spec is
``tests/test_fft_linalg_incubate_opt.py:65-124``.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as jpaddle
import paddle_tpu.incubate.optimizer as jopt

import paddle_tpu_torch as paddle
import paddle_tpu_torch.incubate.optimizer as popt
from _torch_cpu_place import cpu_place  # noqa: F401,E402

torch.set_num_threads(1)

X = np.random.RandomState(0).standard_normal((8, 4)).astype(np.float32)
Y = np.random.RandomState(1).standard_normal((8, 4)).astype(np.float32)


def _nets(bias=False):
    jpaddle.seed(0)
    jnet = jpaddle.nn.Linear(4, 4, bias_attr=None if bias else False)
    pnet = paddle.nn.Linear(4, 4, bias_attr=None if bias else False)
    pnet.set_state_dict({k: v.numpy() for k, v in jnet.state_dict().items()})
    return jnet, pnet


def _train(pkg, net, opt, steps, after=None):
    x, y = pkg.to_tensor(X), pkg.to_tensor(Y)
    losses, weights = [], []
    for _ in range(steps):
        loss = ((net(x) - y) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        if after is not None:
            after()
        losses.append(float(loss.numpy()))
        weights.append(net.weight.numpy().copy())
    return losses, weights


def _same(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    for a, b in zip(got[1], want[1]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("inner", ["SGD", "Adam"])
def test_lookahead_matches_jax(inner):
    res = []
    for pkg, mod in ((jpaddle, jopt), (paddle, popt)):
        net = _nets()[0 if pkg is jpaddle else 1]
        opt = mod.LookAhead(getattr(pkg.optimizer, inner)(
            parameters=net.parameters(), learning_rate=0.3), alpha=0.5, k=3)
        res.append((_train(pkg, net, opt, 8), opt))
    _same(res[1][0], res[0][0])
    losses = res[1][0][0]
    # the third step's sync interpolates back toward the start
    assert losses[3] > losses[2]
    jsd, psd = res[0][1].state_dict(), res[1][1].state_dict()
    assert psd["@lookahead_step"] == jsd["@lookahead_step"] == 8
    assert res[1][1].get_lr() == pytest.approx(0.3)


def test_lookahead_state_dict_round_trip():
    _, net = _nets()
    opt = popt.LookAhead(paddle.optimizer.Adam(
        parameters=net.parameters(), learning_rate=0.1), k=2)
    _train(paddle, net, opt, 3)
    sd = dict(opt.state_dict())
    _, net2 = _nets()
    opt2 = popt.LookAhead(paddle.optimizer.Adam(
        parameters=net2.parameters(), learning_rate=0.1), k=2)
    opt2.set_state_dict(dict(sd))
    assert opt2._lookahead_step == 3
    assert opt2.inner_optimizer._step_count == 3
    with pytest.raises(TypeError):
        popt.LookAhead(object())


def test_model_average_matches_jax():
    res = []
    for pkg, mod in ((jpaddle, jopt), (paddle, popt)):
        net = _nets(bias=True)[0 if pkg is jpaddle else 1]
        opt = pkg.optimizer.SGD(parameters=net.parameters(),
                                learning_rate=0.2)
        ma = mod.ModelAverage(0.3, parameters=net.parameters(),
                              min_average_window=2, max_average_window=3)
        w0 = net.weight.numpy().copy()
        with ma.apply():                    # before any step: no change
            np.testing.assert_array_equal(net.weight.numpy(), w0)
        trained = _train(pkg, net, opt, 7, after=ma.step)
        live = net.weight.numpy().copy()
        with ma.apply():
            avg = [net.weight.numpy().copy(), net.bias.numpy().copy()]
        np.testing.assert_array_equal(net.weight.numpy(), live)  # restored
        with ma.apply(need_restore=False):
            pass
        kept = net.weight.numpy().copy()
        ma.restore()
        np.testing.assert_array_equal(net.weight.numpy(), live)
        res.append((trained, avg, kept, ma._count))
    _same(res[1][0], res[0][0])
    assert res[1][3] == res[0][3]
    for a, b in zip(res[1][1], res[0][1]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(res[1][2], res[1][1][0], rtol=1e-6)
    # the average is the mean of the last window's snapshots
    want = np.mean(res[1][0][1][-res[1][3]:], axis=0)
    np.testing.assert_allclose(res[1][1][0], want, rtol=1e-5)


def test_distributed_fused_lamb_matches_jax():
    res = []
    for pkg, mod in ((jpaddle, jopt), (paddle, popt)):
        net = _nets(bias=True)[0 if pkg is jpaddle else 1]
        opt = mod.DistributedFusedLamb(parameters=net.parameters(),
                                       learning_rate=0.05,
                                       lamb_weight_decay=0.01)
        assert opt._sharding_stage == 1
        res.append(_train(pkg, net, opt, 5))
    _same(res[1], res[0])
    assert res[1][0][-1] < res[1][0][0]
    assert isinstance(popt.DistributedFusedLamb(), paddle.optimizer.Lamb)
