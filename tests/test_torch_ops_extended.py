"""Parity sweep of the port's long-tail ops against the JAX package's:
``ops.extended`` (``addmm`` ... ``max_unpool2d``, the 26 ops) and the
registered ops of ``ops.compat_surface`` (``gcd`` ... ``nanquantile``),
on the registry sweep's seeded inputs.  Forward values and dtypes, and
gradients where the sweep's spec marks the op differentiable; f32 to
1e-5 relative (1e-6 absolute).

Then the unregistered top-level names of ``compat_surface`` on both
packages: ``vsplit``, ``rank``, ``shape``, the ``is_*`` predicates, the
aliases and the in-place forms (the Tensor rebinds; its gradient flows
through the new value)."""
import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from _torch_cpu_place import cpu_place  # noqa: F401
from _torch_op_parity import check, family


@pytest.mark.parametrize("name", family("ops.extended",
                                        "ops.compat_surface"))
def test_op_matches_jax(name):
    check(name)


def test_sweep_covers_the_modules():
    names = family("ops.extended", "ops.compat_surface")
    assert len(family("ops.extended")) == 26
    assert set(names) >= {"gather_tree", "viterbi_decode", "gcd", "take",
                          "nanquantile", "heaviside"}


X = np.arange(24, dtype=np.float32).reshape(6, 4) / 7.0


def _both(fn):
    return fn(jpaddle), fn(tpaddle)


@pytest.mark.parametrize("case", [
    lambda p: p.vsplit(p.to_tensor(X), 3),
    lambda p: p.vsplit(p.to_tensor(X), [1, 4]),
    lambda p: p.rank(p.to_tensor(X)),
    lambda p: p.shape(p.to_tensor(X)),
    lambda p: p.mm(p.to_tensor(X), p.to_tensor(X.T)),
    lambda p: p.mod(p.to_tensor(X), 0.3),
    lambda p: p.floor_mod(p.to_tensor(-X), 0.3),
    lambda p: p.reverse(p.to_tensor(X), [0]),
    lambda p: p.cast(p.to_tensor(X), "int32"),
    lambda p: p.squeeze_(p.to_tensor(X[None]), 0),
    lambda p: p.unsqueeze_(p.to_tensor(X), 1),
    lambda p: p.reshape_(p.to_tensor(X), [4, 6]),
    lambda p: p.scatter_(p.to_tensor(X), p.to_tensor(np.array([1, 3])),
                         p.to_tensor(np.ones((2, 4), np.float32))),
    lambda p: p.index_add_(p.to_tensor(X), p.to_tensor(np.array([0, 2])), 0,
                           p.to_tensor(np.ones((2, 4), np.float32))),
], ids=["vsplit-int", "vsplit-indices", "rank", "shape", "mm", "mod",
        "floor_mod", "reverse", "cast", "squeeze_", "unsqueeze_", "reshape_",
        "scatter_", "index_add_"])
def test_top_level_names_match_jax(case):
    want, got = _both(case)
    want = want if isinstance(want, list) else [want]
    got = got if isinstance(got, list) else [got]
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert str(w.dtype).split(".")[-1].replace("paddle_", "") in \
            str(g.dtype), (w.dtype, g.dtype)
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_predicates_tolist_and_in_place_identity():
    for p in (jpaddle, tpaddle):
        x = p.to_tensor(X)
        assert p.is_floating_point(x) and not p.is_integer(x)
        assert not p.is_complex(x)
        assert p.is_integer(p.to_tensor(np.arange(3)))
        assert p.tolist(x) == x.tolist()
        y = p.squeeze_(p.to_tensor(X[None]), 0)
        assert y.shape == [6, 4]
    t = tpaddle.to_tensor(X, stop_gradient=False)
    base = t * 2.0
    same = tpaddle.reshape_(base, [24])
    assert same is base and base.shape == [24]
    base.sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.full((6, 4), 2.0))


def test_create_parameter_and_set_printoptions():
    from paddle_tpu_torch.nn import ParamAttr, initializer
    p = tpaddle.create_parameter([3, 2], "float32", attr=ParamAttr(
        initializer=initializer.Constant(0.5), learning_rate=0.1))
    assert isinstance(p, tpaddle.nn.Parameter) and p.shape == [3, 2]
    np.testing.assert_array_equal(p.numpy(), np.full((3, 2), 0.5))
    assert p.optimize_attr["learning_rate"] == 0.1 and not p.stop_gradient
    b = tpaddle.create_parameter([4], "float32", is_bias=True, name="b0")
    assert b.name == "b0" and float(b.numpy().sum()) == 0.0
    before = np.get_printoptions()
    try:
        tpaddle.set_printoptions(precision=3, linewidth=120)
        assert np.get_printoptions()["precision"] == 3
    finally:
        np.set_printoptions(**before)
