"""The distributions (``paddle_tpu.distribution.distributions``
counterparts): the JAX package's formulas in torch, on the parameters'
device.

* Parameters: a surface ``Tensor`` or a torch tensor keeps its dtype and
  device; anything else becomes an f32 tensor on the device of the
  other parameters' tensors, or on the current place (the card unless
  the caller set the CPU).
* Results are tape-free, as the JAX package's ``_wrap`` makes them:
  parameters and values are detached, so no result carries a gradient.
* Draws come from the port's generators (``core.random.generator``), so
  ``paddle_tpu_torch.seed`` repeats them and torch's global generator is
  never touched.  They cannot equal the JAX package's; shapes, dtypes,
  supports and moments agree.  Where the JAX package samples by a
  transform of a standard draw (Laplace, Gumbel, Exponential, Geometric's
  inverse CDF, LogNormal), the port applies the same transform.
"""
from __future__ import annotations

import math

import torch

from ..core import place as place_mod
from ..core.random import generator
from ..core.tensor import Tensor

__all__ = ["Distribution", "Normal", "LogNormal", "Uniform", "Bernoulli",
           "Categorical", "Multinomial", "Beta", "Dirichlet", "Laplace",
           "Gumbel", "Exponential", "Gamma", "Poisson", "Geometric",
           "Independent", "ExponentialFamily", "kl_divergence",
           "register_kl"]


def _device(*xs):
    for x in xs:
        if isinstance(x, Tensor):
            return x._value.device
        if isinstance(x, torch.Tensor):
            return x.device
    return place_mod.current_device()


def _t(x, device=None):
    """``x`` as a detached torch tensor (f32 unless it is one already)."""
    if isinstance(x, Tensor):
        return x._value.detach()
    if isinstance(x, torch.Tensor):
        return x.detach()
    return torch.as_tensor(x, dtype=torch.float32,
                           device=device if device is not None
                           else place_mod.current_device())


def _params(*xs):
    dev = _device(*xs)
    return [_t(x, dev) for x in xs]


def _wrap(v):
    return Tensor._wrap(v)


def _shape(sample_shape):
    if sample_shape is None:
        return ()
    return tuple(int(s) for s in sample_shape)


def _uniform(shape, ref, low=0.0):
    """Uniform draws in ``[low, 1)`` of ``shape`` on ``ref``'s device, f32,
    from the port's generator."""
    u = torch.rand(shape, generator=generator(ref.device),
                   device=ref.device, dtype=torch.float32)
    return u if low == 0.0 else low + u * (1.0 - low)


class Distribution:
    def __init__(self, batch_shape=(), event_shape=()):
        self._batch_shape = tuple(batch_shape)
        self._event_shape = tuple(event_shape)

    @property
    def batch_shape(self):
        return self._batch_shape

    @property
    def event_shape(self):
        return self._event_shape

    @property
    def mean(self):
        raise NotImplementedError

    @property
    def variance(self):
        raise NotImplementedError

    def sample(self, shape=()):
        raise NotImplementedError

    def rsample(self, shape=()):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError

    def prob(self, value):
        return _wrap(torch.exp(self.log_prob(value)._value))

    def entropy(self):
        raise NotImplementedError

    def kl_divergence(self, other):
        return kl_divergence(self, other)


def _batch(*xs):
    return tuple(torch.broadcast_shapes(*[x.shape for x in xs]))


class Normal(Distribution):
    def __init__(self, loc, scale, name=None):
        self.loc, self.scale = _params(loc, scale)
        super().__init__(_batch(self.loc, self.scale))

    @property
    def mean(self):
        return _wrap(self.loc.expand(self.batch_shape))

    @property
    def variance(self):
        return _wrap(torch.square(self.scale).expand(self.batch_shape))

    @property
    def stddev(self):
        return _wrap(self.scale.expand(self.batch_shape))

    def sample(self, shape=(), seed=0):
        shp = _shape(shape) + self.batch_shape
        eps = torch.randn(shp, generator=generator(self.loc.device),
                          device=self.loc.device, dtype=torch.float32)
        return _wrap(self.loc + eps * self.scale)

    rsample = sample

    def log_prob(self, value):
        v = _t(value, self.loc.device)
        var = torch.square(self.scale)
        return _wrap(-torch.square(v - self.loc) / (2 * var) -
                     torch.log(self.scale) - 0.5 * math.log(2 * math.pi))

    def entropy(self):
        return _wrap((0.5 + 0.5 * math.log(2 * math.pi) +
                      torch.log(self.scale)).expand(self.batch_shape))


class LogNormal(Normal):
    def sample(self, shape=(), seed=0):
        return _wrap(torch.exp(super().sample(shape)._value))

    rsample = sample

    @property
    def mean(self):
        return _wrap(torch.exp(self.loc + torch.square(self.scale) / 2))

    @property
    def variance(self):
        s2 = torch.square(self.scale)
        return _wrap((torch.exp(s2) - 1) * torch.exp(2 * self.loc + s2))

    def log_prob(self, value):
        logv = torch.log(_t(value, self.loc.device))
        return _wrap(Normal.log_prob(self, logv)._value - logv)

    def entropy(self):
        return _wrap(Normal.entropy(self)._value + self.loc)


class Uniform(Distribution):
    def __init__(self, low, high, name=None):
        self.low, self.high = _params(low, high)
        super().__init__(_batch(self.low, self.high))

    @property
    def mean(self):
        return _wrap((self.low + self.high) / 2)

    @property
    def variance(self):
        return _wrap(torch.square(self.high - self.low) / 12)

    def sample(self, shape=(), seed=0):
        u = _uniform(_shape(shape) + self.batch_shape, self.low)
        return _wrap(self.low + u * (self.high - self.low))

    rsample = sample

    def log_prob(self, value):
        v = _t(value, self.low.device)
        inside = (v >= self.low) & (v < self.high)
        lp = -torch.log(self.high - self.low)
        return _wrap(torch.where(inside, lp, -math.inf))

    def entropy(self):
        return _wrap(torch.log(self.high - self.low))


class Bernoulli(Distribution):
    def __init__(self, probs, name=None):
        self.probs = _t(probs)
        super().__init__(self.probs.shape)

    @property
    def mean(self):
        return _wrap(self.probs)

    @property
    def variance(self):
        return _wrap(self.probs * (1 - self.probs))

    def sample(self, shape=()):
        shp = _shape(shape) + self.batch_shape
        p = self.probs.to(torch.float32).expand(shp)
        return _wrap(torch.bernoulli(p, generator=generator(p.device)))

    def log_prob(self, value):
        v = _t(value, self.probs.device)
        p = torch.clip(self.probs, 1e-7, 1 - 1e-7)
        return _wrap(v * torch.log(p) + (1 - v) * torch.log1p(-p))

    def entropy(self):
        p = torch.clip(self.probs, 1e-7, 1 - 1e-7)
        return _wrap(-(p * torch.log(p) + (1 - p) * torch.log1p(-p)))


def _multinomial(probs, n, g):
    """``n`` categorical draws for each row of ``probs`` ``[..., K]``:
    ``[n, ...]`` int64."""
    flat = probs.reshape(-1, probs.shape[-1]).to(torch.float32)
    draws = torch.multinomial(flat, n, replacement=True, generator=g)
    return draws.t().reshape((n,) + tuple(probs.shape[:-1]))


class Categorical(Distribution):
    def __init__(self, logits, name=None):
        self.logits = _t(logits)
        self._log_norm = self.logits - torch.logsumexp(
            self.logits, dim=-1, keepdim=True)
        super().__init__(self.logits.shape[:-1])

    @property
    def probs_(self):
        return torch.exp(self._log_norm)

    def sample(self, shape=()):
        sample = _shape(shape)
        n = math.prod(sample)
        draws = _multinomial(self.probs_, n,
                             generator(self.logits.device))
        return _wrap(draws.reshape(sample + self.batch_shape))

    def log_prob(self, value):
        v = _t(value, self.logits.device).long()
        ln = self._log_norm
        if ln.ndim == 1:  # scalar batch: any value shape indexes the pmf
            return _wrap(ln[v])
        shp = torch.broadcast_shapes(v.shape, ln.shape[:-1])
        ln = ln.expand(shp + ln.shape[-1:])
        return _wrap(torch.gather(ln, -1, v.expand(shp)[..., None])[..., 0])

    def probs(self, value):
        return _wrap(torch.exp(self.log_prob(value)._value))

    def entropy(self):
        return _wrap(-(self.probs_ * self._log_norm).sum(-1))


class Multinomial(Distribution):
    def __init__(self, total_count, probs, name=None):
        self.total_count = int(total_count)
        p = _t(probs)
        self.probs = p / p.sum(-1, keepdim=True)
        super().__init__(self.probs.shape[:-1], self.probs.shape[-1:])

    @property
    def mean(self):
        return _wrap(self.total_count * self.probs)

    @property
    def variance(self):
        return _wrap(self.total_count * self.probs * (1 - self.probs))

    def sample(self, shape=()):
        sample = _shape(shape)
        k = self.probs.shape[-1]
        n = math.prod(sample)
        draws = _multinomial(self.probs, self.total_count * n,
                             generator(self.probs.device))
        # [..., total_count] class ids -> [..., k] counts
        ids = draws.reshape((self.total_count,) + sample +
                            self.batch_shape).movedim(0, -1)
        counts = torch.zeros(sample + self.batch_shape + (k,),
                             dtype=torch.float32, device=draws.device)
        counts.scatter_add_(-1, ids, torch.ones(ids.shape,
                                                device=draws.device))
        return _wrap(counts)

    def log_prob(self, value):
        v = _t(value, self.probs.device)
        logits = torch.log(torch.clip(self.probs, 1e-12))
        return _wrap(math.lgamma(self.total_count + 1.0) -
                     torch.lgamma(v + 1.0).sum(-1) + (v * logits).sum(-1))

    def entropy(self):
        # the JAX package's approximation: the categorical entropy scaled
        p = self.probs
        cat_ent = -(p * torch.log(torch.clip(p, 1e-12))).sum(-1)
        return _wrap(self.total_count * cat_ent)


def _standard_gamma(conc, shape):
    c = conc.to(torch.float32).expand(shape).contiguous()
    return torch._standard_gamma(c, generator=generator(c.device))


class Beta(Distribution):
    def __init__(self, alpha, beta, name=None):
        self.alpha, self.beta = _params(alpha, beta)
        super().__init__(_batch(self.alpha, self.beta))

    @property
    def mean(self):
        return _wrap(self.alpha / (self.alpha + self.beta))

    @property
    def variance(self):
        s = self.alpha + self.beta
        return _wrap(self.alpha * self.beta / (torch.square(s) * (s + 1)))

    def sample(self, shape=()):
        shp = _shape(shape) + self.batch_shape
        x = _standard_gamma(self.alpha, shp)
        y = _standard_gamma(self.beta, shp)
        return _wrap(x / (x + y))

    def log_prob(self, value):
        v = _t(value, self.alpha.device)
        return _wrap((self.alpha - 1) * torch.log(v) +
                     (self.beta - 1) * torch.log1p(-v) -
                     (torch.lgamma(self.alpha) + torch.lgamma(self.beta) -
                      torch.lgamma(self.alpha + self.beta)))

    def entropy(self):
        a, b = self.alpha, self.beta
        lbeta = torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)
        return _wrap(lbeta - (a - 1) * torch.digamma(a) -
                     (b - 1) * torch.digamma(b) +
                     (a + b - 2) * torch.digamma(a + b))


class Dirichlet(Distribution):
    def __init__(self, concentration, name=None):
        self.concentration = _t(concentration)
        super().__init__(self.concentration.shape[:-1],
                         self.concentration.shape[-1:])

    @property
    def mean(self):
        c = self.concentration
        return _wrap(c / c.sum(-1, keepdim=True))

    @property
    def variance(self):
        c = self.concentration
        c0 = c.sum(-1, keepdim=True)
        m = c / c0
        return _wrap(m * (1 - m) / (c0 + 1))

    def sample(self, shape=()):
        shp = _shape(shape) + self.batch_shape + self.event_shape
        c = self.concentration.to(torch.float32).expand(shp).contiguous()
        return _wrap(torch._sample_dirichlet(c, generator=generator(
            c.device)))

    def log_prob(self, value):
        v = _t(value, self.concentration.device)
        c = self.concentration
        return _wrap(((c - 1) * torch.log(v)).sum(-1) +
                     torch.lgamma(c.sum(-1)) - torch.lgamma(c).sum(-1))

    def entropy(self):
        c = self.concentration
        c0 = c.sum(-1)
        k = c.shape[-1]
        lnB = torch.lgamma(c).sum(-1) - torch.lgamma(c0)
        return _wrap(lnB + (c0 - k) * torch.digamma(c0) -
                     ((c - 1) * torch.digamma(c)).sum(-1))


class Laplace(Distribution):
    def __init__(self, loc, scale, name=None):
        self.loc, self.scale = _params(loc, scale)
        super().__init__(_batch(self.loc, self.scale))

    @property
    def mean(self):
        return _wrap(self.loc.expand(self.batch_shape))

    @property
    def variance(self):
        return _wrap(2 * torch.square(self.scale))

    def sample(self, shape=()):
        # the standard Laplace from u in (-1, 1): -sign(u) log1p(-|u|)
        eps = torch.finfo(torch.float32).eps
        u = 2.0 * _uniform(_shape(shape) + self.batch_shape, self.loc) - 1.0
        u = torch.clip(u, -1.0 + eps, 1.0)
        e = -torch.sign(u) * torch.log1p(-torch.abs(u))
        return _wrap(self.loc + self.scale * e)

    rsample = sample

    def log_prob(self, value):
        v = _t(value, self.loc.device)
        return _wrap(-torch.abs(v - self.loc) / self.scale -
                     torch.log(2 * self.scale))

    def entropy(self):
        return _wrap((1 + torch.log(2 * self.scale)).expand(self.batch_shape))


class Gumbel(Distribution):
    def __init__(self, loc, scale, name=None):
        self.loc, self.scale = _params(loc, scale)
        super().__init__(_batch(self.loc, self.scale))

    _EULER = 0.5772156649015329

    @property
    def mean(self):
        return _wrap(self.loc + self.scale * self._EULER)

    @property
    def variance(self):
        return _wrap(torch.square(math.pi * self.scale) / 6)

    def sample(self, shape=()):
        tiny = torch.finfo(torch.float32).tiny
        u = _uniform(_shape(shape) + self.batch_shape, self.loc, low=tiny)
        return _wrap(self.loc + self.scale * -torch.log(-torch.log(u)))

    rsample = sample

    def log_prob(self, value):
        z = (_t(value, self.loc.device) - self.loc) / self.scale
        return _wrap(-(z + torch.exp(-z)) - torch.log(self.scale))

    def entropy(self):
        return _wrap((torch.log(self.scale) + 1 + self._EULER).expand(
            self.batch_shape))


class Exponential(Distribution):
    def __init__(self, rate, name=None):
        self.rate = _t(rate)
        super().__init__(self.rate.shape)

    @property
    def mean(self):
        return _wrap(1.0 / self.rate)

    @property
    def variance(self):
        return _wrap(1.0 / torch.square(self.rate))

    def sample(self, shape=()):
        u = _uniform(_shape(shape) + self.batch_shape, self.rate)
        return _wrap(-torch.log1p(-u) / self.rate)

    rsample = sample

    def log_prob(self, value):
        v = _t(value, self.rate.device)
        return _wrap(torch.log(self.rate) - self.rate * v)

    def entropy(self):
        return _wrap(1.0 - torch.log(self.rate))


class Gamma(Distribution):
    def __init__(self, concentration, rate, name=None):
        self.concentration, self.rate = _params(concentration, rate)
        super().__init__(_batch(self.concentration, self.rate))

    @property
    def mean(self):
        return _wrap(self.concentration / self.rate)

    @property
    def variance(self):
        return _wrap(self.concentration / torch.square(self.rate))

    def sample(self, shape=()):
        shp = _shape(shape) + self.batch_shape
        return _wrap(_standard_gamma(self.concentration, shp) / self.rate)

    def log_prob(self, value):
        v = _t(value, self.rate.device)
        a, b = self.concentration, self.rate
        return _wrap(a * torch.log(b) + (a - 1) * torch.log(v) - b * v -
                     torch.lgamma(a))

    def entropy(self):
        a, b = self.concentration, self.rate
        return _wrap(a - torch.log(b) + torch.lgamma(a) +
                     (1 - a) * torch.digamma(a))


class Poisson(Distribution):
    def __init__(self, rate, name=None):
        self.rate = _t(rate)
        super().__init__(self.rate.shape)

    @property
    def mean(self):
        return _wrap(self.rate)

    @property
    def variance(self):
        return _wrap(self.rate)

    def sample(self, shape=()):
        shp = _shape(shape) + self.batch_shape
        r = self.rate.to(torch.float32).expand(shp).contiguous()
        return _wrap(torch.poisson(r, generator=generator(r.device)))

    def log_prob(self, value):
        v = _t(value, self.rate.device)
        return _wrap(v * torch.log(self.rate) - self.rate -
                     torch.lgamma(v + 1.0))

    def entropy(self):
        # second-order Stirling approximation (the JAX package's)
        r = self.rate
        return _wrap(0.5 * torch.log(2 * math.pi * math.e * r) -
                     1 / (12 * r) - 1 / (24 * torch.square(r)))


class Geometric(Distribution):
    """Failures before the first success: support {0, 1, ...}, pmf
    p (1 - p)^k."""

    def __init__(self, probs, name=None):
        self.probs = _t(probs)
        super().__init__(self.probs.shape)

    @property
    def mean(self):
        return _wrap((1.0 - self.probs) / self.probs)

    @property
    def variance(self):
        return _wrap((1 - self.probs) / torch.square(self.probs))

    def sample(self, shape=()):
        u = _uniform(_shape(shape) + self.batch_shape, self.probs)
        return _wrap(torch.floor(torch.log1p(-u) / torch.log1p(-self.probs)))

    def log_prob(self, value):
        v = _t(value, self.probs.device)
        return _wrap(v * torch.log1p(-self.probs) + torch.log(self.probs))

    def entropy(self):
        p = self.probs
        q = 1 - p
        return _wrap(-(q * torch.log(q) + p * torch.log(p)) / p)


# -- the KL registry ---------------------------------------------------------

_KL_REGISTRY = {}


def register_kl(p_cls, q_cls):
    def deco(fn):
        _KL_REGISTRY[(p_cls, q_cls)] = fn
        return fn
    return deco


def kl_divergence(p: Distribution, q: Distribution):
    exact = _KL_REGISTRY.get((type(p), type(q)))
    if exact is not None:
        return exact(p, q)
    # a subclass against its base (LogNormal against Normal) must not take
    # the base's formula: the supports differ
    if type(p) is not type(q) and (isinstance(p, type(q)) or
                                   isinstance(q, type(p))):
        raise NotImplementedError(
            f"no KL registered for ({type(p).__name__}, {type(q).__name__})")
    best = None
    for (pc, qc), fn in _KL_REGISTRY.items():
        if isinstance(p, pc) and isinstance(q, qc):
            score = type(p).__mro__.index(pc) + type(q).__mro__.index(qc)
            if best is None or score < best[0]:
                best = (score, fn)
    if best is not None:
        return best[1](p, q)
    raise NotImplementedError(
        f"no KL registered for ({type(p).__name__}, {type(q).__name__})")


@register_kl(Normal, Normal)
def _kl_normal(p, q):
    var_ratio = torch.square(p.scale / q.scale)
    t1 = torch.square((p.loc - q.loc) / q.scale)
    return _wrap(0.5 * (var_ratio + t1 - 1 - torch.log(var_ratio)))


@register_kl(LogNormal, LogNormal)
def _kl_lognormal(p, q):
    # KL is invariant under the shared exp bijection
    return _kl_normal(p, q)


@register_kl(Uniform, Uniform)
def _kl_uniform(p, q):
    return _wrap(torch.log((q.high - q.low) / (p.high - p.low)))


@register_kl(Categorical, Categorical)
def _kl_categorical(p, q):
    return _wrap((p.probs_ * (p._log_norm - q._log_norm)).sum(-1))


@register_kl(Bernoulli, Bernoulli)
def _kl_bernoulli(p, q):
    pp = torch.clip(p.probs, 1e-7, 1 - 1e-7)
    qp = torch.clip(q.probs, 1e-7, 1 - 1e-7)
    return _wrap(pp * (torch.log(pp) - torch.log(qp)) +
                 (1 - pp) * (torch.log1p(-pp) - torch.log1p(-qp)))


@register_kl(Beta, Beta)
def _kl_beta(p, q):
    def lbeta(a, b):
        return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)
    a1, b1, a2, b2 = p.alpha, p.beta, q.alpha, q.beta
    s1 = a1 + b1
    return _wrap(lbeta(a2, b2) - lbeta(a1, b1) +
                 (a1 - a2) * torch.digamma(a1) +
                 (b1 - b2) * torch.digamma(b1) +
                 (a2 - a1 + b2 - b1) * torch.digamma(s1))


@register_kl(Dirichlet, Dirichlet)
def _kl_dirichlet(p, q):
    c1, c2 = p.concentration, q.concentration
    s1 = c1.sum(-1)
    return _wrap(torch.lgamma(s1) - torch.lgamma(c2.sum(-1)) -
                 (torch.lgamma(c1) - torch.lgamma(c2)).sum(-1) +
                 ((c1 - c2) * (torch.digamma(c1) -
                               torch.digamma(s1)[..., None])).sum(-1))


@register_kl(Exponential, Exponential)
def _kl_exponential(p, q):
    ratio = q.rate / p.rate
    return _wrap(torch.log(p.rate) - torch.log(q.rate) + ratio - 1)


def _raw(t):
    return t._value if isinstance(t, Tensor) else torch.as_tensor(t)


class Independent(Distribution):
    """The rightmost ``reinterpreted_batch_rank`` batch dims of a base
    distribution taken as event dims: ``log_prob`` and ``entropy`` sum
    over them."""

    def __init__(self, base, reinterpreted_batch_rank):
        if not isinstance(base, Distribution):
            raise TypeError("base should be a Distribution")
        r = int(reinterpreted_batch_rank)
        if not (0 < r <= len(base.batch_shape)):
            raise ValueError(
                "reinterpreted_batch_rank must be in (0, "
                f"{len(base.batch_shape)}], got {reinterpreted_batch_rank}")
        self._base = base
        self._rank = r
        super().__init__(batch_shape=base.batch_shape[:-r],
                         event_shape=base.batch_shape[-r:]
                         + base.event_shape)

    @property
    def mean(self):
        return self._base.mean

    @property
    def variance(self):
        return self._base.variance

    def sample(self, shape=()):
        return self._base.sample(shape)

    def log_prob(self, value):
        lp = _raw(self._base.log_prob(value))
        return _wrap(lp.sum(dim=tuple(range(-self._rank, 0))))

    def entropy(self):
        e = _raw(self._base.entropy())
        return _wrap(e.sum(dim=tuple(range(-self._rank, 0))))


class ExponentialFamily(Distribution):
    """Base of the exponential families: a subclass gives its natural
    parameters, log normalizer and carrier measure's mean, and inherits
    the Bregman-divergence entropy, the log normalizer's gradient taken
    by autograd (``jax.grad`` in the JAX package)."""

    @property
    def _natural_parameters(self):
        raise NotImplementedError

    def _log_normalizer(self, *natural_params):
        raise NotImplementedError

    @property
    def _mean_carrier_measure(self):
        raise NotImplementedError

    def entropy(self):
        nat = [_raw(p).detach().requires_grad_(True)
               for p in self._natural_parameters]
        with torch.enable_grad():
            lz = _raw(self._log_normalizer(*nat))
            grads = torch.autograd.grad(lz.sum(), nat)
        ent = lz.detach() - self._mean_carrier_measure
        for p, g in zip(nat, grads):
            ent = ent - p.detach() * g
        return _wrap(ent)
