"""The port's ``distribution`` against the JAX package's, on the CPU.

The same numpy-seeded parameters go through both packages.  ``mean``,
``variance``, ``log_prob``, ``prob``, ``entropy`` and ``kl_divergence``
agree within 1e-5 relative, with an absolute floor of 1e-5 of the largest
magnitude compared (``lgamma`` / ``digamma`` and the logs round in other
orders).  Draws cannot equal the JAX package's (its keys are
functional): they are held to shape, dtype, support and their moments
against the closed form (within 5 standard errors), and the port's
generators repeat them under ``paddle_tpu_torch.seed`` and leave torch's
global generator alone.

The specs are ``tests/test_profiler_flags_distribution.py:145-235``.
"""
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as jpaddle
import paddle_tpu.distribution as jd

import _torch_global_state as global_state
import paddle_tpu_torch as paddle
import paddle_tpu_torch.distribution as pd
from _torch_cpu_place import cpu_place  # noqa: F401,E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _global_state_unchanged():
    before = global_state.snapshot()
    yield
    assert global_state.snapshot() == before


def _np(v):
    if isinstance(v, (jpaddle.Tensor, paddle.Tensor)):
        return v.numpy()
    return np.asarray(v)


def _close(got, want, rtol=1e-5, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite, err_msg=what)
    np.testing.assert_array_equal(got[~finite], want[~finite], err_msg=what)
    floor = rtol * max(float(np.abs(want[finite]).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(got[finite], want[finite], rtol=rtol,
                               atol=floor, err_msg=what)


RS = np.random.RandomState(0)
POS = RS.uniform(0.5, 3.0, (3,)).astype(np.float32)      # rates, scales
POS2 = RS.uniform(0.5, 3.0, (3,)).astype(np.float32)
LOC = RS.standard_normal((3,)).astype(np.float32)
PROB = RS.uniform(0.1, 0.9, (3,)).astype(np.float32)
LOGITS = RS.standard_normal((2, 4)).astype(np.float32)
CONC = RS.uniform(0.5, 3.0, (2, 4)).astype(np.float32)

# name -> (constructor arguments, a value in the support)
CASES = {
    "Normal": ((LOC, POS), RS.standard_normal((5, 3)).astype(np.float32)),
    "LogNormal": ((LOC, POS), RS.uniform(0.1, 4, (5, 3)).astype(np.float32)),
    "Uniform": ((LOC, LOC + POS),
                (LOC + RS.uniform(-0.5, 1.5, (5, 3)) * POS).astype(
                    np.float32)),
    "Bernoulli": ((PROB,), RS.randint(0, 2, (5, 3)).astype(np.float32)),
    "Categorical": ((LOGITS,), RS.randint(0, 4, (2,)).astype(np.int64)),
    "Multinomial": ((6, CONC[0]), np.array([[1, 2, 0, 3], [0, 0, 6, 0]],
                                           np.float32)),
    "Beta": ((POS, POS2), RS.uniform(0.05, 0.95, (5, 3)).astype(np.float32)),
    "Dirichlet": ((CONC,), RS.dirichlet(np.ones(4), (5, 2)).astype(
        np.float32)),
    "Laplace": ((LOC, POS), RS.standard_normal((5, 3)).astype(np.float32)),
    "Gumbel": ((LOC, POS), RS.standard_normal((5, 3)).astype(np.float32)),
    "Exponential": ((POS,), RS.uniform(0, 4, (5, 3)).astype(np.float32)),
    "Gamma": ((POS, POS2), RS.uniform(0.1, 4, (5, 3)).astype(np.float32)),
    "Poisson": ((POS,), RS.randint(0, 6, (5, 3)).astype(np.float32)),
    "Geometric": ((PROB,), RS.randint(0, 6, (5, 3)).astype(np.float32)),
}


def _make(pkg_mod, pkg, name, args):
    return getattr(pkg_mod, name)(*[pkg.to_tensor(a) if isinstance(
        a, np.ndarray) else a for a in args])


def _pair(name):
    args, _ = CASES[name]
    return _make(jd, jpaddle, name, args), _make(pd, paddle, name, args)


@pytest.mark.parametrize("name", sorted(CASES))
def test_densities_and_moments_match_jax(name):
    jdist, pdist = _pair(name)
    value = CASES[name][1]
    assert tuple(pdist.batch_shape) == tuple(jdist.batch_shape)
    assert tuple(pdist.event_shape) == tuple(jdist.event_shape)
    for what in ("log_prob", "prob"):
        _close(getattr(pdist, what)(paddle.to_tensor(value)),
               getattr(jdist, what)(jpaddle.to_tensor(value)),
               what=f"{name}.{what}")
    _close(pdist.entropy(), jdist.entropy(), what=f"{name}.entropy")
    if name != "Categorical":           # the JAX class has no moments
        _close(pdist.mean, jdist.mean, what=f"{name}.mean")
        _close(pdist.variance, jdist.variance, what=f"{name}.variance")
    if name == "Normal":
        _close(pdist.stddev, jdist.stddev, what="Normal.stddev")


KL_PAIRS = {
    "Normal": ((LOC, POS), (LOC[::-1].copy(), POS2)),
    "LogNormal": ((LOC, POS), (LOC[::-1].copy(), POS2)),
    "Uniform": ((LOC, LOC + POS), (LOC - 1, LOC + POS + 1)),
    "Categorical": ((LOGITS,), (LOGITS[::-1].copy(),)),
    "Bernoulli": ((PROB,), (PROB[::-1].copy(),)),
    "Beta": ((POS, POS2), (POS2, POS)),
    "Dirichlet": ((CONC,), (CONC[::-1].copy(),)),
    "Exponential": ((POS,), (POS2,)),
}


@pytest.mark.parametrize("name", sorted(KL_PAIRS))
def test_kl_divergence_matches_jax(name):
    a, b = KL_PAIRS[name]
    want = jd.kl_divergence(_make(jd, jpaddle, name, a),
                            _make(jd, jpaddle, name, b))
    p, q = _make(pd, paddle, name, a), _make(pd, paddle, name, b)
    _close(pd.kl_divergence(p, q), want, what=f"kl {name}")
    _close(p.kl_divergence(q), want, what=f"{name}.kl_divergence")


def test_kl_registry_refuses_a_subclass_against_its_base_and_takes_new():
    for mod, pkg in ((jd, jpaddle), (pd, paddle)):
        with pytest.raises(NotImplementedError):
            mod.kl_divergence(mod.LogNormal(0.0, 1.0), mod.Normal(0.0, 1.0))
        with pytest.raises(NotImplementedError):
            mod.kl_divergence(mod.Gamma(1.0, 1.0), mod.Beta(1.0, 1.0))

    class MyNormal(pd.Normal):
        pass

    # a subclass pair with no entry of its own takes its bases' formula
    got = pd.kl_divergence(MyNormal(0.0, 1.0), MyNormal(1.0, 2.0))
    _close(got, jd.kl_divergence(jd.Normal(0.0, 1.0), jd.Normal(1.0, 2.0)))
    calls = []

    @pd.register_kl(MyNormal, MyNormal)
    def _mine(p, q):
        calls.append(1)
        return pd.distributions._wrap(torch.zeros(()))

    try:
        assert float(pd.kl_divergence(MyNormal(0.0, 1.0),
                                      MyNormal(1.0, 2.0))) == 0.0
        assert calls == [1]
    finally:
        del pd.distributions._KL_REGISTRY[(MyNormal, MyNormal)]


# (sample shape, distribution) -> the closed-form mean and variance of one
# draw, the support check
N_DRAWS = 20000
SAMPLING = {
    "Normal": (lambda: pd.Normal(1.5, 2.0), 1.5, 4.0, None),
    "LogNormal": (lambda: pd.LogNormal(0.0, 0.5), math.exp(0.125),
                  (math.exp(0.25) - 1) * math.exp(0.25), lambda s: s > 0),
    "Uniform": (lambda: pd.Uniform(-1.0, 3.0), 1.0, 16 / 12,
                lambda s: (s >= -1) & (s < 3)),
    "Bernoulli": (lambda: pd.Bernoulli(0.3), 0.3, 0.21,
                  lambda s: (s == 0) | (s == 1)),
    "Beta": (lambda: pd.Beta(2.0, 3.0), 0.4, 6 / (25 * 6),
             lambda s: (s > 0) & (s < 1)),
    "Laplace": (lambda: pd.Laplace(0.5, 1.5), 0.5, 2 * 2.25, None),
    "Gumbel": (lambda: pd.Gumbel(0.5, 2.0), 0.5 + 2.0 * 0.5772156649015329,
               (math.pi * 2.0) ** 2 / 6, None),
    "Exponential": (lambda: pd.Exponential(2.0), 0.5, 0.25,
                    lambda s: s >= 0),
    "Gamma": (lambda: pd.Gamma(3.0, 2.0), 1.5, 0.75, lambda s: s > 0),
    "Poisson": (lambda: pd.Poisson(3.0), 3.0, 3.0,
                lambda s: (s >= 0) & (s == np.floor(s))),
    "Geometric": (lambda: pd.Geometric(0.3), 0.7 / 0.3, 0.7 / 0.09,
                  lambda s: (s >= 0) & (s == np.floor(s))),
}


@pytest.mark.parametrize("name", sorted(SAMPLING))
def test_draws_have_shape_support_and_moments(name):
    make, mean, var, support = SAMPLING[name]
    paddle.seed(5)
    s = make().sample([N_DRAWS])
    assert isinstance(s, paddle.Tensor) and s.shape == [N_DRAWS]
    assert s.dtype == torch.float32 and s.stop_gradient
    x = s.numpy().astype(np.float64)
    if support is not None:
        assert support(x).all()
    se = math.sqrt(var / N_DRAWS)
    assert abs(x.mean() - mean) < 5 * se, (x.mean(), mean)
    assert abs(x.var() - var) < 0.1 * var, (x.var(), var)


def test_vector_draws_categorical_multinomial_dirichlet():
    paddle.seed(6)
    probs = np.array([[0.2, 0.3, 0.5], [0.6, 0.3, 0.1]], np.float32)
    c = pd.Categorical(paddle.to_tensor(np.log(probs)))
    s = c.sample([N_DRAWS])
    assert s.shape == [N_DRAWS, 2] and s.dtype == torch.int64
    for row in range(2):
        freq = np.bincount(s.numpy()[:, row], minlength=3) / N_DRAWS
        se = np.sqrt(probs[row] * (1 - probs[row]) / N_DRAWS)
        assert (np.abs(freq - probs[row]) < 5 * se).all()
    m = pd.Multinomial(10, paddle.to_tensor(probs))
    s = m.sample([N_DRAWS // 4]).numpy()
    assert s.shape == (N_DRAWS // 4, 2, 3) and s.dtype == np.float32
    np.testing.assert_array_equal(s.sum(-1), 10.0)
    se = np.sqrt(10 * probs * (1 - probs) / s.shape[0])
    assert (np.abs(s.mean(0) - 10 * probs) < 5 * se).all()
    conc = np.array([1.0, 2.0, 3.0], np.float32)
    d = pd.Dirichlet(paddle.to_tensor(conc))
    s = d.sample([N_DRAWS]).numpy()
    assert s.shape == (N_DRAWS, 3) and (s > 0).all()
    np.testing.assert_allclose(s.sum(-1), 1.0, rtol=1e-5)
    mean, var = conc / 6, (conc / 6) * (1 - conc / 6) / 7
    assert (np.abs(s.mean(0) - mean) < 5 * np.sqrt(var / N_DRAWS)).all()


def test_draws_repeat_under_seed_and_spare_torch_global_generator():
    torch_state = torch.random.get_rng_state()
    makers = [make for make, *_ in SAMPLING.values()] + [
        lambda: pd.Categorical(paddle.to_tensor(LOGITS)),
        lambda: pd.Multinomial(4, paddle.to_tensor(CONC[0])),
        lambda: pd.Dirichlet(paddle.to_tensor(CONC))]
    draws = []
    for _ in range(2):
        paddle.seed(11)
        draws.append([make().sample([64]).numpy() for make in makers])
    for a, b in zip(*draws):
        np.testing.assert_array_equal(a, b)
    paddle.seed(12)
    assert not np.array_equal(makers[0]().sample([64]).numpy(), draws[0][0])
    assert torch.equal(torch.random.get_rng_state(), torch_state)


def test_results_are_tape_free_and_on_the_parameters_device():
    loc = paddle.to_tensor(LOC, stop_gradient=False)
    d = pd.Normal(loc, 2.0)
    for out in (d.log_prob(paddle.to_tensor(LOC)), d.entropy(), d.mean,
                d.sample([3]), d.rsample([3])):
        assert out.stop_gradient and out.value.grad_fn is None
        assert out.value.device.type == "cpu"
    kl = pd.kl_divergence(d, pd.Normal(loc, 3.0))
    assert kl.stop_gradient


TRANSFORMS = {
    "AffineTransform": ((0.5, 2.0), RS.standard_normal((4,))),
    "ExpTransform": ((), RS.standard_normal((4,))),
    "AbsTransform": ((), RS.uniform(0.1, 2, (4,))),
    "PowerTransform": ((3.0,), RS.uniform(0.1, 2, (4,))),
    "SigmoidTransform": ((), RS.standard_normal((4,))),
    "TanhTransform": ((), RS.uniform(-2, 2, (4,))),
    "SoftmaxTransform": ((), RS.standard_normal((2, 4))),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transforms_match_jax(name):
    args, x = TRANSFORMS[name]
    x = x.astype(np.float32)
    jt, pt = getattr(jd, name)(*args), getattr(pd, name)(*args)
    jy, py = jt(jpaddle.to_tensor(x)), pt(paddle.to_tensor(x))
    _close(py, jy, what=f"{name} forward")
    _close(pt.inverse(py), jt.inverse(jy), what=f"{name} inverse")
    if name == "SoftmaxTransform":
        for t, pkg in ((jt, jpaddle), (pt, paddle)):
            with pytest.raises(NotImplementedError):
                t.forward_log_det_jacobian(pkg.to_tensor(x))
        return
    _close(pt.forward_log_det_jacobian(paddle.to_tensor(x)),
           jt.forward_log_det_jacobian(jpaddle.to_tensor(x)),
           what=f"{name} fldj")
    _close(pt.inverse_log_det_jacobian(py),
           jt.inverse_log_det_jacobian(jy), what=f"{name} ildj")


def test_chain_and_transformed_distribution_match_jax():
    def chain(mod):
        return mod.ChainTransform([mod.AffineTransform(0.5, 2.0),
                                   mod.ExpTransform()])

    x = RS.standard_normal((4,)).astype(np.float32)
    _close(chain(pd).forward_log_det_jacobian(paddle.to_tensor(x)),
           chain(jd).forward_log_det_jacobian(jpaddle.to_tensor(x)))
    v = RS.uniform(0.2, 5.0, (4,)).astype(np.float32)
    for ts in (lambda m: [m.ExpTransform()],
               lambda m: [m.AffineTransform(1.0, 3.0)],
               lambda m: [chain(m)],
               lambda m: m.SigmoidTransform()):
        got = pd.TransformedDistribution(pd.Normal(0.2, 1.3), ts(pd))
        want = jd.TransformedDistribution(jd.Normal(0.2, 1.3), ts(jd))
        vv = 1.0 / (1.0 + v) if isinstance(ts(pd), pd.SigmoidTransform) \
            else v
        _close(got.log_prob(paddle.to_tensor(vv)),
               want.log_prob(jpaddle.to_tensor(vv)))
    paddle.seed(3)
    s = pd.TransformedDistribution(pd.Normal(0.0, 1.0),
                                   [pd.ExpTransform()]).rsample([100])
    assert (s.numpy() > 0).all()


def test_independent_matches_jax():
    base = (LOGITS, np.abs(LOGITS) + 0.5)
    jind = jd.Independent(jd.Normal(*map(jpaddle.to_tensor, base)), 1)
    pind = pd.Independent(pd.Normal(*map(paddle.to_tensor, base)), 1)
    assert pind.batch_shape == jind.batch_shape == (2,)
    assert pind.event_shape == jind.event_shape == (4,)
    v = RS.standard_normal((3, 2, 4)).astype(np.float32)
    _close(pind.log_prob(paddle.to_tensor(v)),
           jind.log_prob(jpaddle.to_tensor(v)))
    _close(pind.entropy(), jind.entropy())
    _close(pind.mean, jind.mean)
    assert pind.sample([5]).shape == [5, 2, 4]
    for mod, pkg in ((jd, jpaddle), (pd, paddle)):
        with pytest.raises(ValueError):
            mod.Independent(mod.Normal(pkg.to_tensor(LOC), 1.0), 2)
        with pytest.raises(TypeError):
            mod.Independent("not a distribution", 1)


def _normal_family(mod, xp):
    """A Normal in natural parameters over ``mod.ExponentialFamily``, the
    math in ``xp`` (jnp or torch)."""

    class NaturalNormal(mod.ExponentialFamily):
        def __init__(self, loc, scale):
            self.loc, self.scale = loc, scale
            super().__init__(batch_shape=loc.shape)

        @property
        def _natural_parameters(self):
            return (self.loc / self.scale ** 2, -0.5 / self.scale ** 2)

        def _log_normalizer(self, x, y):
            return -0.25 * x ** 2 / y + 0.5 * xp.log(-math.pi / y)

        @property
        def _mean_carrier_measure(self):
            return 0.0

    return NaturalNormal


def test_exponential_family_entropy_matches_jax_and_closed_form():
    import jax.numpy as jnp

    want = _normal_family(jd, jnp)(jnp.asarray(LOC), jnp.asarray(POS))
    got = _normal_family(pd, torch)(torch.from_numpy(LOC),
                                    torch.from_numpy(POS))
    _close(got.entropy(), want.entropy())
    _close(got.entropy(), 0.5 + 0.5 * np.log(2 * np.pi) + np.log(POS))


# -- the JAX package's spec tests, on the port ------------------------------

def test_spec_normal_moments_and_sampling():
    paddle.seed(0)
    d = pd.Normal(loc=1.5, scale=2.0)
    s = d.sample([20000])
    assert abs(float(s.numpy().mean()) - 1.5) < 0.1
    assert abs(float(s.numpy().std()) - 2.0) < 0.1
    lp = d.log_prob(paddle.to_tensor(np.array([1.5], "float32")))
    expected = -np.log(2.0) - 0.5 * np.log(2 * np.pi)
    np.testing.assert_allclose(lp.numpy()[0], expected, rtol=1e-5)
    assert float(d.entropy().numpy()) == pytest.approx(
        0.5 + 0.5 * np.log(2 * np.pi) + np.log(2.0), rel=1e-5)


def test_spec_uniform_categorical():
    paddle.seed(1)
    u = pd.Uniform(low=-1.0, high=3.0)
    s = u.sample([10000]).numpy()
    assert s.min() >= -1 and s.max() < 3
    assert abs(s.mean() - 1.0) < 0.1
    assert float(u.entropy().numpy()) == pytest.approx(np.log(4.0), rel=1e-5)
    logits = np.log(np.array([0.2, 0.3, 0.5], "float32"))
    c = pd.Categorical(paddle.to_tensor(logits))
    s = c.sample([20000]).numpy()
    freq = np.bincount(s, minlength=3) / len(s)
    np.testing.assert_allclose(freq, [0.2, 0.3, 0.5], atol=0.02)
    np.testing.assert_allclose(
        c.log_prob(paddle.to_tensor(np.array([2], "int64"))).numpy(),
        [np.log(0.5)], rtol=1e-5)


def test_spec_beta_dirichlet_multinomial():
    paddle.seed(2)
    b = pd.Beta(2.0, 3.0)
    assert float(b.mean.numpy()) == pytest.approx(0.4)
    assert abs(b.sample([5000]).numpy().mean() - 0.4) < 0.05
    d = pd.Dirichlet(paddle.to_tensor(np.array([1.0, 2.0, 3.0], "float32")))
    np.testing.assert_allclose(d.mean.numpy(), [1 / 6, 2 / 6, 3 / 6],
                               rtol=1e-5)
    np.testing.assert_allclose(d.sample([2]).numpy().sum(-1), 1.0,
                               rtol=1e-5)
    mn = pd.Multinomial(10, paddle.to_tensor(np.array([0.2, 0.8],
                                                       "float32")))
    s = mn.sample([4]).numpy()
    assert s.shape == (4, 2)
    np.testing.assert_allclose(s.sum(-1), 10.0)
    lp = mn.log_prob(paddle.to_tensor(np.array([2.0, 8.0], "float32")))
    expected = math.log(math.comb(10, 2) * 0.2 ** 2 * 0.8 ** 8)
    np.testing.assert_allclose(float(lp.numpy()), expected, rtol=1e-4)


def test_spec_kl_divergence():
    p, q = pd.Normal(0.0, 1.0), pd.Normal(1.0, 2.0)
    kl = float(pd.kl_divergence(p, q).numpy())
    np.testing.assert_allclose(kl, np.log(2.0) + 2 / 8 - 0.5, rtol=1e-5)
    assert float(pd.kl_divergence(p, pd.Normal(0.0, 1.0)).numpy()) == \
        pytest.approx(0.0, abs=1e-6)


def test_spec_transformed_distribution():
    paddle.seed(3)
    base = pd.Normal(0.0, 1.0)
    logn = pd.TransformedDistribution(base, [pd.ExpTransform()])
    assert (logn.sample([5000]).numpy() > 0).all()
    v = np.array([0.5, 1.0, 2.0], "float32")
    lp = logn.log_prob(paddle.to_tensor(v)).numpy()
    expected = -np.log(v) - 0.5 * np.log(2 * np.pi) - np.log(v) ** 2 / 2
    np.testing.assert_allclose(lp, expected, rtol=1e-4)
    aff = pd.TransformedDistribution(base, [pd.AffineTransform(2.0, 3.0)])
    s = aff.sample([20000]).numpy()
    assert abs(s.mean() - 2.0) < 0.1 and abs(s.std() - 3.0) < 0.1
