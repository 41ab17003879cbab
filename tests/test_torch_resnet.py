"""The port's ResNet slice against the JAX package's, on the CPU.

Inputs come from numpy seeds; JAX weights are carried to the port by
``to_jax_state``-layout numpy dicts (``load_jax_state``).  Both sides
compute in f32 unless a case says bf16, in another summation order.

* ``conv2d`` over the padding forms (int, per-dim, flat and nested
  ``[lo, hi]`` pairs, "SAME", "VALID"), strides, dilation, groups, NHWC
  with a bias, and the ``pointwise_as_dot`` route on and off: rtol/atol
  1e-5.
* ``batch_norm`` in training (batch statistics and the running update,
  paddle's momentum 0.9 with the biased variance) and eval, in f32
  (rtol/atol 1e-5) and bf16 (output within one bf16 rounding, rtol 1e-2
  and atol 2e-2; the f32 statistics and running buffers rtol 1e-5).
* ``max_pool2d`` forward and gradient on inputs with many ties (both
  sides send a window's gradient to its first maximum in row-major
  order: exact), with -inf padding reached; ``adaptive_avg_pool2d`` over
  even and uneven bins: 1e-6.
* ``Momentum`` with and without L2 decay and Nesterov, three steps:
  rtol 1e-6 (the same f32 element-wise arithmetic).
* ResNet forward logits for resnet18, ``ResNet(depth=50)`` and depth 50
  with ``stem_s2d=True``, batch 4 at 64^2: in training mode (batch
  statistics) rtol/atol 1e-3, the running statistics after that forward
  1e-4; then in eval mode (running statistics) 2e-5.  Training mode is
  the looser because layer4's batch norms see 16 values a channel (4
  images of 2 x 2): normalising over so few divides the f32
  summation-order noise of the convolutions by a small spread (at 32^2,
  2 values a channel, resnet18's logits differ by 1.8e-3; in eval mode by
  4e-6).
* Three f32 Momentum steps (lr 0.1, L2 1e-4) of resnet18 at 64^2, batch
  4, through the port's ``make_train_step`` against the JAX package's
  eager tape: losses rtol 1e-5; every parameter and running statistic
  afterwards atol 5e-4 (the loss climbs from 2.6 to 12.9 at this lr on
  random weights, and the largest gap, 2.3e-4, is in layer4, whose batch
  norms see 16 values a channel).  JAX's compiled step agrees on the
  first loss only (see the test);
  ``run_steps`` over ``[3, B, ...]`` stacks gives the three single steps'
  losses and weights exactly.
* The state-dict round trip, and the refusal of a torch-style state that
  carries ``num_batches_tracked``.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.nn.functional import conv as jconv
from paddle_tpu.nn.layer_base import Parameter as JaxParameter
from paddle_tpu.vision import models as jmodels

import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.distributed import make_train_step
from paddle_tpu_torch.models import load_jax_state, to_jax_state
from paddle_tpu_torch.nn.functional import conv as pconv
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.vision import models as pmodels

TOL = dict(rtol=1e-5, atol=1e-5)

torch.set_num_threads(2)


def _rand(seed, *shape):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


# -- functionals ---------------------------------------------------------------

CONV_CASES = {
    "3x3-pad1": ((2, 4, 9, 9), (6, 4, 3, 3), dict(stride=1, padding=1)),
    "7x7-s2-pad3": ((2, 3, 16, 16), (8, 3, 7, 7), dict(stride=2, padding=3)),
    "same-s2": ((1, 4, 11, 10), (5, 4, 3, 3), dict(stride=2, padding="SAME")),
    "valid-dil2": ((1, 4, 12, 12), (5, 4, 3, 3),
                   dict(padding="VALID", dilation=2)),
    "per-dim": ((1, 4, 8, 8), (5, 4, 3, 5), dict(padding=[1, 2])),
    "flat-pairs": ((1, 4, 8, 8), (5, 4, 3, 3), dict(padding=[1, 2, 0, 1])),
    "nested-pairs": ((1, 4, 8, 8), (5, 4, 3, 3),
                     dict(padding=[[2, 0], [1, 1]], stride=(1, 2))),
    "groups": ((2, 6, 7, 7), (9, 2, 3, 3), dict(padding=1, groups=3)),
    "nhwc-bias": ((2, 7, 7, 4), (6, 4, 3, 3),
                  dict(padding=1, data_format="NHWC", bias=True)),
    "1x1-s2": ((2, 8, 9, 9), (16, 8, 1, 1), dict(stride=2)),
    "1x1-nhwc": ((2, 5, 5, 8), (16, 8, 1, 1), dict(data_format="NHWC")),
}


@pytest.mark.parametrize("dot", [False, True], ids=["conv", "as-dot"])
@pytest.mark.parametrize("case", list(CONV_CASES))
def test_conv2d_matches_jax(case, dot):
    xs, ws, kw = CONV_CASES[case]
    kw = dict(kw)
    x, w = _rand(1, *xs), _rand(2, *ws)
    bias = _rand(3, ws[0]) if kw.pop("bias", False) else None
    jconv.pointwise_as_dot(dot)
    pconv.pointwise_as_dot(dot)
    try:
        want = JF.conv2d(paddle.to_tensor(x), paddle.to_tensor(w),
                         None if bias is None else paddle.to_tensor(bias),
                         **kw).numpy()
        got = F.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                       None if bias is None else torch.from_numpy(bias),
                       **kw)
    finally:
        jconv.pointwise_as_dot(False)
        pconv.pointwise_as_dot(False)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_conv2d_refuses_other_layouts():
    x = torch.zeros(1, 2, 4, 4)
    with pytest.raises(ValueError, match="data_format"):
        F.conv2d(x, torch.zeros(2, 2, 1, 1), data_format="NCL")
    with pytest.raises(ValueError, match="padding"):
        F.conv2d(x, torch.zeros(2, 2, 1, 1), padding=[1, 2, 3])
    # the nested form with the batch and channel pairs is read as flat
    # pairs of pairs for 2-D convs (4 entries), by both packages: refused
    nested = [[0, 0], [0, 0], [1, 1], [1, 1]]
    with pytest.raises(ValueError, match="pairs"):
        JF.conv2d(paddle.to_tensor(x.numpy()),
                  paddle.to_tensor(np.zeros((2, 2, 1, 1), np.float32)),
                  padding=nested)
    with pytest.raises(ValueError, match="pairs"):
        F.conv2d(x, torch.zeros(2, 2, 1, 1), padding=nested)


def _bn_args(seed, C, dtype):
    x = _rand(seed, 4, C, 5, 6) * 3 + 1
    w, b = 1 + 0.1 * _rand(seed + 1, C), 0.1 * _rand(seed + 2, C)
    rm, rv = 0.1 * _rand(seed + 3, C), 1 + np.abs(_rand(seed + 4, C))
    return x, w, b, rm, rv


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_matches_jax(training, dtype):
    x, w, b, rm, rv = _bn_args(5, 3, dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    jrm, jrv = paddle.to_tensor(rm), paddle.to_tensor(rv)
    want = JF.batch_norm(
        paddle.to_tensor(jnp.asarray(x, jdt)), jrm, jrv,
        paddle.to_tensor(jnp.asarray(w, jdt)),
        paddle.to_tensor(jnp.asarray(b, jdt)), training=training)
    trm, trv = torch.from_numpy(rm.copy()), torch.from_numpy(rv.copy())
    got = F.batch_norm(torch.from_numpy(x).to(tdt), trm, trv,
                       torch.from_numpy(w).to(tdt),
                       torch.from_numpy(b).to(tdt), training=training)
    assert got.dtype == tdt
    want = np.asarray(jnp.asarray(want._value, jnp.float32))
    tol = TOL if dtype == "float32" else dict(rtol=1e-2, atol=2e-2)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)
    # the running statistics: updated in training (f32 buffers), kept in
    # eval
    np.testing.assert_allclose(trm.numpy(), jrm.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(trv.numpy(), jrv.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert np.array_equal(trm.numpy(), rm) != training


def test_batch_norm_update_is_paddles_not_torchs():
    """m = 0.9 keeps 90% of the running value, and the variance that
    enters is the biased one (torch keeps 90% with its momentum 0.1 and
    the unbiased variance)."""
    x = torch.tensor([[1.0], [3.0]])           # mean 2, biased var 1
    rm, rv = torch.zeros(1), torch.ones(1)
    F.batch_norm(x, rm, rv, training=True)
    assert float(rm) == pytest.approx(0.2) and float(rv) == pytest.approx(1.0)
    layer = pnn.BatchNorm2D(3)
    assert set(layer.state_dict()) == {"weight", "bias", "_mean",
                                       "_variance"}


def test_max_pool2d_forward_and_ties_gradient_match_jax():
    x = np.random.RandomState(0).randint(0, 3, (2, 3, 9, 8)).astype(
        np.float32)
    g = _rand(1, 2, 3, 6, 6)
    for kw in (dict(kernel_size=3, stride=2, padding=1),
               dict(kernel_size=2), dict(kernel_size=3, stride=2,
                                         padding=1, ceil_mode=True),
               dict(kernel_size=(3, 2), stride=(2, 2), padding=[1, 0])):
        jx = paddle.to_tensor(x, stop_gradient=False)
        jout = JF.max_pool2d(jx, **kw)
        gj = g[..., :jout.shape[2], :jout.shape[3]]
        (jout * paddle.to_tensor(np.ascontiguousarray(gj))).sum().backward()
        tx = torch.from_numpy(x).requires_grad_()
        tout = F.max_pool2d(tx, **kw)
        assert tuple(tout.shape) == tuple(jout.shape), kw
        (tout * torch.from_numpy(np.ascontiguousarray(gj))).sum().backward()
        np.testing.assert_array_equal(tout.detach().numpy(), jout.numpy())
        np.testing.assert_array_equal(tx.grad.numpy(), jx.grad.numpy(),
                                      err_msg=str(kw))


def test_max_pool2d_nhwc_and_adaptive_avg_pool2d_match_jax():
    x = _rand(2, 2, 9, 7, 3)                        # NHWC
    want = JF.max_pool2d(paddle.to_tensor(x), 3, 2, 1,
                         data_format="NHWC").numpy()
    got = F.max_pool2d(torch.from_numpy(x), 3, 2, 1, data_format="NHWC")
    np.testing.assert_array_equal(got.numpy(), want)
    x = _rand(3, 2, 3, 7, 9)
    for size in ((1, 1), (3, 4), 2, (None, 3)):
        want = JF.adaptive_avg_pool2d(paddle.to_tensor(x), size).numpy()
        got = F.adaptive_avg_pool2d(torch.from_numpy(x), size)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6,
                                   err_msg=str(size))


@pytest.mark.parametrize("decay,nesterov", [(None, False), (1e-2, False),
                                            (1e-2, True)],
                         ids=["plain", "l2", "l2-nesterov"])
def test_momentum_matches_jax(decay, nesterov):
    rs = np.random.RandomState(0)
    shapes = {"conv.weight": (4, 3, 3, 3), "fc.bias": (3,)}
    init = {n: rs.randn(*s).astype(np.float32) for n, s in shapes.items()}
    grads = [{n: rs.randn(*s).astype(np.float32) for n, s in shapes.items()}
             for _ in range(3)]
    jparams = [JaxParameter(jnp.asarray(v), name=n) for n, v in init.items()]
    jopt = paddle.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                     parameters=jparams, weight_decay=decay,
                                     use_nesterov=nesterov)
    tparams = [(n, torch.from_numpy(v.copy()).requires_grad_())
               for n, v in init.items()]
    topt = Momentum(learning_rate=0.1, momentum=0.9, parameters=tparams,
                    weight_decay=decay, use_nesterov=nesterov)
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
    assert "conv.weight_velocity" in topt.state_dict()


# -- the model -----------------------------------------------------------------

def _pair(build_jax, build_port, seed=0):
    paddle.seed(seed)
    jm = build_jax()
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    pm = build_port()
    load_jax_state(pm, state)
    return jm, pm, state


MODELS = {
    "resnet18-64": (lambda: jmodels.resnet18(num_classes=10),
                    lambda: pmodels.resnet18(num_classes=10, device="cpu"),
                    64),
    "depth50-64": (lambda: jmodels.ResNet(depth=50, num_classes=10),
                   lambda: pmodels.ResNet(depth=50, num_classes=10,
                                          device="cpu"), 64),
    "depth50-s2d-64": (
        lambda: jmodels.ResNet(depth=50, num_classes=10, stem_s2d=True),
        lambda: pmodels.ResNet(depth=50, num_classes=10, stem_s2d=True,
                               device="cpu"), 64),
}


@pytest.mark.parametrize("name", list(MODELS))
def test_resnet_forward_matches_jax(name):
    build_jax, build_port, size = MODELS[name]
    jm, pm, _ = _pair(build_jax, build_port)
    x = _rand(4, 4, 3, size, size)
    want = jm(paddle.to_tensor(x)).numpy()
    got = pm(torch.from_numpy(x))
    assert pm.training and got.shape == (4, 10)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-3,
                               atol=1e-3)
    after = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    for k, v in to_jax_state(pm).items():
        if k.endswith(("_mean", "_variance")):
            np.testing.assert_allclose(v, after[k], rtol=1e-4, atol=1e-4,
                                       err_msg=k)
    jm.eval()
    pm.eval()
    np.testing.assert_allclose(pm(torch.from_numpy(x)).detach().numpy(),
                               jm(paddle.to_tensor(x)).numpy(), rtol=2e-5,
                               atol=2e-5)


def test_resnet_state_round_trip_and_torch_state_refused():
    jm, pm, state = _pair(*MODELS["resnet18-64"][:2])
    back = to_jax_state(pm)
    assert set(back) == set(state)
    for k, v in state.items():
        assert back[k].shape == v.shape and np.array_equal(back[k], v), k
    assert pm.fc.weight.shape == (10, 512)            # [out, in] in torch
    assert not any("num_batches_tracked" in k for k in pm.state_dict())
    torch_style = dict(state, **{"bn1.num_batches_tracked": np.int64(0)})
    with pytest.raises(KeyError, match="num_batches_tracked"):
        load_jax_state(pmodels.resnet18(num_classes=10, device="cpu"),
                       torch_style)
    with pytest.raises(ValueError, match="pretrained"):
        pmodels.resnet50(pretrained=True, device="cpu")


def test_resnet_conv_flops_counts_two_a_multiply_add():
    """8.18 GFLOP an image for resnet50 at 224^2: the usual 4.09 G
    multiply-adds at 2 FLOPs each (``bench.py``'s 3.8e9 counts
    multiply-adds); the s2d stem is refused (it counts the plain one)."""
    flops = pmodels.resnet_conv_flops(pmodels.resnet50(device="cpu"))
    assert flops == pytest.approx(8.18e9, rel=2e-3)
    with pytest.raises(ValueError, match="stem_s2d"):
        pmodels.resnet_conv_flops(pmodels.resnet18(stem_s2d=True,
                                                   device="cpu"))


def _batches(n=3, B=4, size=64):
    rs = np.random.RandomState(7)
    x = rs.standard_normal((n, B, 3, size, size)).astype(np.float32)
    y = rs.randint(0, 10, (n, B)).astype(np.int64)
    return x, y


def test_resnet_train_steps_match_jax():
    """The port's step against the JAX package's eager tape (forward,
    ``loss.backward()``, ``Momentum.step()``).  JAX's compiled
    ``make_train_step`` gives the same first loss but other gradients (up
    to 34% of a tensor's largest element in layer4, with or without jit;
    ROADMAP section 3), so its later losses are not the reference."""
    jm, pm, _ = _pair(*MODELS["resnet18-64"][:2], seed=3)
    x, y = _batches()
    jopt = paddle.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                     parameters=jm.parameters(),
                                     weight_decay=1e-4)
    crit = jnn.CrossEntropyLoss()
    want = []
    for i in range(3):
        loss = crit(jm(paddle.to_tensor(x[i])), paddle.to_tensor(y[i]))
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        want.append(float(loss.numpy()))
    step = make_train_step(pm, Momentum(0.1, momentum=0.9, parameters=pm,
                                        weight_decay=1e-4),
                           loss_fn=pnn.CrossEntropyLoss())
    got = [float(step(x[i], y[i])) for i in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert step.compile_count == 1
    after = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    for k, v in to_jax_state(pm).items():
        np.testing.assert_allclose(v, after[k], rtol=0, atol=5e-4, err_msg=k)
    # the compiled JAX step agrees on the first loss (the forward)
    jm2, _, _ = _pair(*MODELS["resnet18-64"][:2], seed=3)
    jstep = jdist.make_train_step(jm2, paddle.optimizer.Momentum(
        learning_rate=0.1, momentum=0.9, parameters=jm2.parameters(),
        weight_decay=1e-4), loss_fn=jnn.CrossEntropyLoss())
    assert float(jstep(x[0], y[0])) == pytest.approx(got[0], rel=1e-6)


def test_run_steps_equals_single_steps():
    x, y = _batches(B=2)
    outs = []
    for stacked in (False, True):
        _, pm, _ = _pair(*MODELS["resnet18-64"][:2], seed=4)
        step = make_train_step(pm, Momentum(0.1, momentum=0.9, parameters=pm,
                                            weight_decay=1e-4),
                               loss_fn=pnn.CrossEntropyLoss())
        if stacked:
            losses = step.run_steps(x, y)
            assert losses.shape == (3,) and losses.dtype == torch.float32
        else:
            losses = torch.stack([step(x[i], y[i]) for i in range(3)])
        outs.append((losses, to_jax_state(pm)))
    assert torch.equal(outs[0][0], outs[1][0])
    for k, v in outs[0][1].items():
        assert np.array_equal(v, outs[1][1][k]), k
