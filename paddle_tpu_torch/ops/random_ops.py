"""Random sampling ops (``paddle_tpu.ops.random_ops`` counterpart;
reference python/paddle/tensor/random.py).  Every draw comes from the
port's generator for the tensor's device (``core.random.generator``),
reseeded by ``paddle.seed``: same seed, same draws on one device.  The
draws are not the JAX package's (its keys are functional)."""
from __future__ import annotations

import torch

from ..core import random as rnd
from ..core.dtype import convert_dtype, get_default_dtype
from ..core.op import apply_op
from ..core.place import current_device
from ..core.tensor import Tensor

__all__ = ["rand", "randn", "standard_normal", "normal", "uniform", "randint",
           "randint_like", "randperm", "bernoulli", "multinomial", "poisson",
           "exponential_", "uniform_", "normal_"]


def _shape(shape):
    if isinstance(shape, Tensor):
        return tuple(int(s) for s in shape._value.reshape(-1).tolist())
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s._value) if isinstance(s, Tensor) else int(s)
                 for s in shape)


def _dt(dtype):
    return convert_dtype(dtype) if dtype is not None else get_default_dtype()


def _draw(fn, *args, dtype=None, **kwargs):
    dev = current_device()
    return Tensor._wrap(fn(*args, dtype=dtype, device=dev,
                           generator=rnd.generator(dev), **kwargs))


def rand(shape, dtype=None, name=None) -> Tensor:
    return _draw(torch.rand, _shape(shape), dtype=_dt(dtype))


def randn(shape, dtype=None, name=None) -> Tensor:
    return _draw(torch.randn, _shape(shape), dtype=_dt(dtype))


def standard_normal(shape, dtype=None, name=None) -> Tensor:
    return randn(shape, dtype)


def normal(mean=0.0, std=1.0, shape=None, name=None) -> Tensor:
    if isinstance(mean, Tensor) or isinstance(std, Tensor):
        def impl(m, s):
            shp = torch.broadcast_shapes(tuple(m.shape), tuple(s.shape))
            z = torch.randn(shp, dtype=_dt(None), device=m.device,
                            generator=rnd.generator(m.device))
            return m + s * z
        dev = next(t._value.device for t in (mean, std)
                   if isinstance(t, Tensor))
        return apply_op(impl, "gaussian", tuple(
            t if isinstance(t, Tensor) else Tensor._wrap(torch.as_tensor(
                t, dtype=_dt(None), device=dev)) for t in (mean, std)), {})
    shp = _shape(shape) if shape is not None else ()
    z = randn(shp)
    return Tensor._wrap(mean + std * z._value)


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None) -> Tensor:  # noqa: A002
    dev = current_device()
    gen = torch.Generator(device=dev).manual_seed(int(seed)) if seed \
        else rnd.generator(dev)
    u = torch.rand(_shape(shape), dtype=_dt(dtype), device=dev, generator=gen)
    return Tensor._wrap(u * (float(max) - float(min)) + float(min))


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None) -> Tensor:
    if high is None:
        low, high = 0, low
    return _draw(torch.randint, int(low), int(high), _shape(shape),
                 dtype=convert_dtype(dtype))


def randint_like(x, low=0, high=None, dtype=None, name=None) -> Tensor:
    return randint(low, high, tuple(x.shape), dtype or x.dtype)


def randperm(n, dtype="int64", name=None) -> Tensor:
    return _draw(torch.randperm, int(n), dtype=convert_dtype(dtype))


def bernoulli(x, name=None) -> Tensor:
    return apply_op(lambda p: torch.bernoulli(
        p, generator=rnd.generator(p.device)), "bernoulli", (x,), {})


def multinomial(x, num_samples=1, replacement=False, name=None) -> Tensor:
    def impl(p):
        p2 = p.reshape(-1, p.shape[-1])
        out = torch.multinomial(p2, int(num_samples),
                                replacement=bool(replacement),
                                generator=rnd.generator(p.device))
        return out.reshape(*p.shape[:-1], int(num_samples))
    return apply_op(impl, "multinomial", (x,), {})


def poisson(x, name=None) -> Tensor:
    return apply_op(lambda lam: torch.poisson(
        lam, generator=rnd.generator(lam.device)), "poisson", (x,), {})


def _fill(x, draw):
    with torch.no_grad():
        val = draw(x._value)
    return x._rebind(val)


def exponential_(x, lam=1.0, name=None) -> Tensor:
    return _fill(x, lambda v: torch.empty_like(v).exponential_(
        lam, generator=rnd.generator(v.device)))


def uniform_(x, min=-1.0, max=1.0, name=None) -> Tensor:  # noqa: A002
    return _fill(x, lambda v: torch.empty_like(v).uniform_(
        float(min), float(max), generator=rnd.generator(v.device)))


def normal_(x, mean=0.0, std=1.0, name=None) -> Tensor:
    return _fill(x, lambda v: torch.empty_like(v).normal_(
        mean, std, generator=rnd.generator(v.device)))


Tensor.uniform_ = uniform_
Tensor.normal_ = normal_
Tensor.exponential_ = exponential_
Tensor.bernoulli = bernoulli
Tensor.multinomial = multinomial
