"""The port's ``nn.initializer`` against the JAX package's, on the CPU.

* ``Constant``, ``Assign`` and ``Dirac`` give exactly the JAX values.
* ``_fan_in_out`` gives the JAX fans for every rank (2-D is paddle's
  ``[in, out]``), and the Xavier and Kaiming bounds and standard
  deviations follow from them as in the JAX formulas.
* The random initializers' draws are not the JAX package's (its keys are
  functional): their range holds exactly, and their mean and standard
  deviation over 40000 draws agree with the distribution's to 0.03 of the
  standard deviation (about 6 standard errors), as the JAX draws' do.
* ``Orthogonal`` gives orthonormal rows or columns (to 1e-5), times
  ``gain``.
* Draws come from the port's generator on the given device (the same
  after ``paddle.seed``; torch's global generator untouched) and land in
  the given dtype.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu.nn.initializer as JI
import paddle_tpu_torch
import paddle_tpu_torch.nn.initializer as PI
from _torch_cpu_place import cpu_place  # noqa: F401

N = (200, 200)
SHAPES = [(), (7,), (5, 9), (6, 4, 3), (8, 3, 2, 5), (4, 2, 3, 3, 2)]


def _port(init, shape=N, dtype=torch.float32):
    return init(shape, dtype, "cpu").numpy()


def _jax(init, shape=N):
    return np.asarray(init(shape, jnp.float32))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_fans_match_jax(shape):
    assert PI._fan_in_out(shape) == JI._fan_in_out(shape)


DETERMINISTIC = [
    ("constant", lambda I: I.Constant(0.25), (3, 4)),
    ("constant-neg", lambda I: I.Constant(-3.0), (5,)),
    ("assign", lambda I: I.Assign(
        np.arange(12, dtype=np.float32).reshape(3, 4)), (3, 4)),
    ("assign-reshaped", lambda I: I.Assign(
        [[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]]), (2, 3)),
    ("dirac", lambda I: I.Dirac(), (6, 3, 3, 3)),
    ("dirac-groups", lambda I: I.Dirac(groups=2), (6, 3, 3)),
]


@pytest.mark.parametrize("name,make,shape", DETERMINISTIC,
                         ids=[d[0] for d in DETERMINISTIC])
def test_deterministic_values_equal_jax(name, make, shape):
    np.testing.assert_array_equal(_port(make(PI), shape),
                                  _jax(make(JI), shape))


def test_assign_takes_a_surface_tensor_and_reshapes():
    t = paddle_tpu_torch.to_tensor(np.arange(6, dtype=np.float32))
    np.testing.assert_array_equal(_port(PI.Assign(t), (2, 3)),
                                  np.arange(6).reshape(2, 3))


def _limit(kind, shape, **kw):
    fin, fout = JI._fan_in_out(shape)
    if kind == "xavier":
        return kw.get("gain", 1.0) * math.sqrt(6.0 / (fin + fout))
    slope = kw.get("negative_slope", 0.0)
    gain = math.sqrt(2.0 / (1 + slope ** 2)) \
        if kw.get("nonlinearity", "relu") in ("relu", "leaky_relu") else 1.0
    return gain * math.sqrt(3.0 / kw.get("fan_in", fin))


UNIFORM = [
    ("uniform", lambda I: I.Uniform(-0.3, 0.7), (-0.3, 0.7), N),
    ("xavier", lambda I: I.XavierUniform(), None, N),
    ("xavier-gain", lambda I: I.XavierUniform(gain=2.0), None, (40, 30, 3)),
    ("kaiming", lambda I: I.KaimingUniform(), None, (300, 150)),
    ("kaiming-conv", lambda I: I.KaimingUniform(
        fan_in=27, negative_slope=math.sqrt(5.0), nonlinearity="leaky_relu"),
     None, (64, 3, 3, 3)),
]


@pytest.mark.parametrize("name,make,rng,shape", UNIFORM,
                         ids=[u[0] for u in UNIFORM])
def test_uniform_family_range_and_moments(name, make, rng, shape):
    if rng is None:
        kw = {"xavier-gain": dict(gain=2.0),
              "kaiming-conv": dict(fan_in=27, negative_slope=math.sqrt(5.0),
                                   nonlinearity="leaky_relu")}.get(name, {})
        lim = _limit(name.split("-")[0], shape, **kw)
        lo, hi = -lim, lim
    else:
        lo, hi = rng
    for x in (_port(make(PI), shape), _jax(make(JI), shape)):
        assert x.shape == tuple(shape)
        assert lo <= x.min() and x.max() <= hi
        std = (hi - lo) / math.sqrt(12.0)
        assert abs(x.mean() - (lo + hi) / 2) < 0.03 * std * max(
            1.0, math.sqrt(40000 / x.size))
        assert abs(x.std() - std) < 0.03 * std * max(
            1.0, math.sqrt(40000 / x.size))


NORMAL = [
    ("normal", lambda I: I.Normal(0.5, 2.0), (0.5, 2.0)),
    ("xavier", lambda I: I.XavierNormal(), (0.0, math.sqrt(2.0 / 400))),
    ("xavier-fans", lambda I: I.XavierNormal(fan_in=10, fan_out=30,
                                             gain=0.5),
     (0.0, 0.5 * math.sqrt(2.0 / 40))),
    ("kaiming", lambda I: I.KaimingNormal(),
     (0.0, math.sqrt(2.0) / 200 ** .5)),
    ("kaiming-linear", lambda I: I.KaimingNormal(nonlinearity="linear"),
     (0.0, 1.0 / 200 ** .5)),
]


@pytest.mark.parametrize("name,make,moments", NORMAL,
                         ids=[n[0] for n in NORMAL])
def test_normal_family_moments(name, make, moments):
    mean, std = moments
    for x in (_port(make(PI)), _jax(make(JI))):
        assert abs(x.mean() - mean) < 0.03 * std
        assert abs(x.std() - std) < 0.03 * std


def test_truncated_normal_range_and_moments():
    # a standard normal truncated to [-2, 2] has std 0.8796
    tstd = 0.87962566
    for x in (_port(PI.TruncatedNormal(1.0, 0.5)),
              _jax(JI.TruncatedNormal(1.0, 0.5))):
        assert 0.0 <= x.min() and x.max() <= 2.0
        assert abs(x.mean() - 1.0) < 0.03 * 0.5
        assert abs(x.std() - 0.5 * tstd) < 0.03 * 0.5


@pytest.mark.parametrize("shape", [(6, 6), (8, 3), (3, 8), (4, 2, 3, 3)],
                         ids=str)
def test_orthogonal_is_orthonormal(shape):
    for x in (_port(PI.Orthogonal(2.0), shape),
              _jax(JI.Orthogonal(2.0), shape)):
        m = x.reshape(-1, shape[-1]) / 2.0
        g = m.T @ m if m.shape[0] >= m.shape[1] else m @ m.T
        np.testing.assert_allclose(g, np.eye(g.shape[0]), atol=1e-5)


def test_draws_follow_paddle_seed_device_and_dtype():
    torch_state = torch.get_rng_state()
    paddle_tpu_torch.seed(7)
    a = PI.Normal()((4, 5), torch.bfloat16, "cpu")
    b = PI.XavierUniform()((4, 5), torch.float32, torch.device("cpu"))
    paddle_tpu_torch.seed(7)
    c = PI.Normal()((4, 5), torch.bfloat16, "cpu")
    d = PI.XavierUniform()((4, 5), torch.float32, torch.device("cpu"))
    assert torch.equal(a, c) and torch.equal(b, d)
    assert a.dtype == torch.bfloat16 and a.device.type == "cpu"
    assert not torch.equal(a.float(), PI.Normal()((4, 5), torch.bfloat16,
                                                  "cpu").float())
    assert torch.equal(torch.get_rng_state(), torch_state)
    paddle_tpu_torch.seed(0)
