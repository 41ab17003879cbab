"""The Tensor surface and eager autograd, the same calls on both packages.

The cases of ``tests/test_tensor.py`` and ``tests/test_autograd.py``,
parametrised over the package (``paddle_tpu`` and ``paddle_tpu_torch``),
except the ones that need a module the port has not ported yet (the
``nn`` Layer surface, ``paddle.save``, sparse embeddings, ``amp``,
optimizers over surface Tensors).  Then what the port adds: the aliasing
rule (a tensor taken before an in-place write keeps its values) and
in-place rebinding under autograd, on both packages; the port's places,
dtypes, RNG and type promotion against the JAX package's; the functions
that the registry does not hold, against the JAX package on the same
inputs (f32 to 1e-5 relative).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu.core.dtype import dtype_name as jax_dtype_name
from paddle_tpu_torch.core.dtype import dtype_name as port_dtype_name


@pytest.fixture(params=["jax", "torch"])
def paddle(request):
    if request.param == "torch":
        paddle_tpu_torch.set_device("cpu")
        return paddle_tpu_torch
    return paddle_tpu


def _name(pkg, dtype):
    return (port_dtype_name if pkg is paddle_tpu_torch
            else jax_dtype_name)(dtype)


# -- tests/test_tensor.py ----------------------------------------------------

def test_to_tensor_dtypes(paddle):
    assert paddle.to_tensor(1).dtype == paddle.int64
    assert paddle.to_tensor(1.0).dtype == paddle.float32
    assert paddle.to_tensor([True]).dtype == paddle.bool_
    assert paddle.to_tensor(np.zeros(3, np.float64)).dtype == paddle.float64
    t = paddle.to_tensor([1, 2], dtype="float32")
    assert t.dtype == paddle.float32


def test_creation_ops(paddle):
    assert paddle.zeros([2, 3]).shape == [2, 3]
    assert paddle.ones([2]).numpy().tolist() == [1.0, 1.0]
    assert paddle.full([2], 7).numpy().tolist() == [7, 7]
    assert paddle.arange(5).dtype == paddle.int64
    assert paddle.arange(0, 1, 0.25).shape == [4]
    np.testing.assert_allclose(paddle.eye(3).numpy(), np.eye(3))
    assert paddle.linspace(0, 1, 5).shape == [5]
    x = paddle.to_tensor([[1., 2.], [3., 4.]])
    np.testing.assert_allclose(paddle.tril(x).numpy(), np.tril(x.numpy()))
    assert paddle.ones_like(x).shape == [2, 2]


def test_properties(paddle):
    x = paddle.randn([3, 4])
    assert x.shape == [3, 4]
    assert x.ndim == 2
    assert x.size == 12
    assert x.numel() == 12
    assert len(x) == 3
    assert x.T.shape == [4, 3]
    assert x.stop_gradient is True
    assert x.is_leaf


def test_indexing(paddle):
    x = paddle.to_tensor(np.arange(12).reshape(3, 4).astype(np.float32))
    assert x[0].shape == [4]
    assert x[0, 1].item() == 1.0
    assert x[:, 1:3].shape == [3, 2]
    assert x[-1, -1].item() == 11.0
    idx = paddle.to_tensor([0, 2])
    assert x[idx].shape == [2, 4]
    # boolean mask (eager only)
    m = x > 5
    assert (x[m] > 5).all().item()
    np.testing.assert_array_equal(x[::-1, 3:0:-2].numpy(),
                                  x.numpy()[::-1, 3:0:-2])


def test_setitem(paddle):
    x = paddle.zeros([3, 3])
    x[0, 0] = 5.0
    assert x[0, 0].item() == 5.0
    x[1] = paddle.ones([3])
    np.testing.assert_allclose(x[1].numpy(), np.ones(3))


def test_inplace_ops(paddle):
    x = paddle.to_tensor([1., 2.])
    y = x
    x.add_(paddle.to_tensor([1., 1.]))
    np.testing.assert_allclose(y.numpy(), [2., 3.])
    x.scale_(2.0)
    np.testing.assert_allclose(y.numpy(), [4., 6.])
    x.zero_()
    np.testing.assert_allclose(y.numpy(), [0., 0.])


def test_operators(paddle):
    a = paddle.to_tensor([4., 9.])
    b = paddle.to_tensor([2., 3.])
    np.testing.assert_allclose((a + b).numpy(), [6., 12.])
    np.testing.assert_allclose((a - b).numpy(), [2., 6.])
    np.testing.assert_allclose((a * b).numpy(), [8., 27.])
    np.testing.assert_allclose((a / b).numpy(), [2., 3.])
    np.testing.assert_allclose((a ** 2).numpy(), [16., 81.])
    np.testing.assert_allclose((1 + a).numpy(), [5., 10.])
    np.testing.assert_allclose((10 / b).numpy(), [5., 10 / 3], rtol=1e-6)
    np.testing.assert_allclose((-a).numpy(), [-4., -9.])
    np.testing.assert_allclose(abs(paddle.to_tensor([-1., 2.])).numpy(),
                               [1., 2.])
    assert (a > b).all().item()
    assert (a == a).all().item()
    assert (a != b).any().item()


def test_astype_and_item(paddle):
    x = paddle.to_tensor([1.7])
    assert x.astype("int32").dtype == paddle.int32
    assert x.astype(paddle.int64).item() == 1
    assert isinstance(x.item(), float)
    assert float(x) == pytest.approx(1.7, rel=1e-6)


def test_clone_detach(paddle):
    x = paddle.to_tensor([1., 2.], stop_gradient=False)
    d = x.detach()
    assert d.stop_gradient
    c = x.clone()
    assert not c.stop_gradient
    (c.sum()).backward()
    assert x.grad is not None


def test_seed_reproducible(paddle):
    paddle.seed(42)
    a = paddle.randn([4])
    paddle.seed(42)
    b = paddle.randn([4])
    np.testing.assert_allclose(a.numpy(), b.numpy())


# -- tests/test_autograd.py ----------------------------------------------------

def test_simple_backward(paddle):
    x = paddle.to_tensor([2., 3.], stop_gradient=False)
    y = (x * x).sum()
    y.backward()
    np.testing.assert_allclose(x.grad.numpy(), [4., 6.])


def test_chain(paddle):
    x = paddle.to_tensor(2.0, stop_gradient=False)
    y = x * x          # 4
    z = y * x + y      # 8 + 4
    z.backward()
    # dz/dx = 3x^2 + 2x = 16
    np.testing.assert_allclose(x.grad.numpy(), 16.0)


def test_grad_accumulation(paddle):
    x = paddle.to_tensor([1.0], stop_gradient=False)
    (x * 2).backward()
    (x * 3).backward()
    np.testing.assert_allclose(x.grad.numpy(), [5.0])
    x.clear_grad()
    assert x.grad is None


def test_branching_graph(paddle):
    x = paddle.to_tensor([1., 2.], stop_gradient=False)
    a = x * 2
    b = x * 3
    (a + b).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [5., 5.])


def test_no_grad(paddle):
    x = paddle.to_tensor([1.], stop_gradient=False)
    with paddle.no_grad():
        y = x * 2
    assert y.stop_gradient
    assert y.is_leaf


def test_stop_gradient_propagation(paddle):
    x = paddle.to_tensor([1.], stop_gradient=False)
    y = x.detach() * 2
    assert y.stop_gradient


def test_multi_output_op(paddle):
    x = paddle.to_tensor(np.array([[3., 1.], [2., 4.]]), stop_gradient=False)
    vals, idx = paddle.topk(x, 1, axis=1)
    vals.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [[1., 0.], [0., 1.]])


def test_paddle_grad(paddle):
    x = paddle.to_tensor([3.], stop_gradient=False)
    y = x * x
    (g,) = paddle.grad(y, x)
    np.testing.assert_allclose(g.numpy(), [6.])
    assert x.grad is None  # paddle.grad must not pollute .grad


def test_retain_graph(paddle):
    x = paddle.to_tensor([1.], stop_gradient=False)
    y = (x * x).sum()
    y.backward(retain_graph=True)
    y.backward(retain_graph=False)
    np.testing.assert_allclose(x.grad.numpy(), [4.0])
    with pytest.raises(RuntimeError):
        y.backward()


def test_backward_non_scalar_requires_grad_tensor(paddle):
    x = paddle.to_tensor([1., 2.], stop_gradient=False)
    y = x * 2
    with pytest.raises(RuntimeError):
        y.backward()
    y.backward(paddle.ones_like(y))
    np.testing.assert_allclose(x.grad.numpy(), [2., 2.])


def test_backward_several_roots(paddle):
    x = paddle.to_tensor([1., 2.], stop_gradient=False)
    a, b = (x * x).sum(), x * 3
    paddle.autograd.backward([a, b], [None, paddle.to_tensor([1., 10.])])
    np.testing.assert_allclose(x.grad.numpy(), [2. + 3., 4. + 30.])


def test_pylayer(paddle):
    class Double(paddle.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * 2

        @staticmethod
        def backward(ctx, grad):
            (x,) = ctx.saved_tensor()
            return grad * 2

    x = paddle.to_tensor([1., 2.], stop_gradient=False)
    y = Double.apply(x)
    y.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [2., 2.])


def test_pylayer_two_inputs_two_outputs(paddle):
    class MulAdd(paddle.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, y, scale=1.0):
            ctx.save_for_backward(x, y)
            ctx.scale = scale
            return x * y * scale, x + y

        @staticmethod
        def backward(ctx, g_mul, g_add):
            x, y = ctx.saved_tensor()
            return g_mul * y * ctx.scale + g_add, g_mul * x * ctx.scale + g_add

    x = paddle.to_tensor([1., 2.], stop_gradient=False)
    y = paddle.to_tensor([3., 5.], stop_gradient=False)
    m, s = MulAdd.apply(x, y, scale=2.0)
    (m.sum() + (s * s).sum()).backward()
    np.testing.assert_allclose(x.grad.numpy(), [2 * 3 + 2 * 4, 2 * 5 + 2 * 7])
    np.testing.assert_allclose(y.grad.numpy(), [2 * 1 + 2 * 4, 2 * 2 + 2 * 7])


def test_grad_through_getitem_and_concat(paddle):
    x = paddle.to_tensor([1., 2., 3.], stop_gradient=False)
    y = paddle.concat([x[0:2], x[1:3]])
    y.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [1., 2., 1.])


def test_grad_matmul(paddle):
    rs = np.random.RandomState(0)
    a = paddle.to_tensor(rs.randn(3, 4).astype(np.float32),
                         stop_gradient=False)
    b = paddle.to_tensor(rs.randn(4, 5).astype(np.float32),
                         stop_gradient=False)
    paddle.matmul(a, b).sum().backward()
    np.testing.assert_allclose(a.grad.numpy(),
                               np.ones((3, 5)) @ b.numpy().T, rtol=1e-5)
    np.testing.assert_allclose(b.grad.numpy(),
                               a.numpy().T @ np.ones((3, 5)), rtol=1e-5)


def test_setitem_grad(paddle):
    x = paddle.to_tensor([1., 2., 3.], stop_gradient=False)
    y = x * 2
    y[0] = 10.0
    y.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [0., 2., 2.])


def test_create_graph_matches_jax_hessian(paddle):
    rng = np.random.RandomState(0)
    W1 = rng.standard_normal((3, 5)).astype(np.float32) * 0.5
    W2 = rng.standard_normal((5, 1)).astype(np.float32) * 0.5
    xv = rng.standard_normal((3,)).astype(np.float32)

    def f_jax(x):
        return (jnp.tanh(x @ W1) @ W2).sum()

    H_ref = np.asarray(jax.hessian(f_jax)(xv))

    xt = paddle.to_tensor(xv)
    xt.stop_gradient = False
    out = (paddle.tanh(xt @ paddle.to_tensor(W1))
           @ paddle.to_tensor(W2)).sum()
    (g,) = paddle.grad(out, xt, create_graph=True)
    assert not g.stop_gradient
    rows = [paddle.grad(g[i], xt, retain_graph=True)[0].numpy()
            for i in range(3)]
    np.testing.assert_allclose(np.stack(rows), H_ref, rtol=1e-4, atol=1e-5)


def test_create_graph_triple_backward(paddle):
    x = paddle.to_tensor(np.array([1.5], np.float32))
    x.stop_gradient = False
    y = (x ** 4).sum()                       # y''' = 24x
    (g1,) = paddle.grad(y, x, create_graph=True)
    (g2,) = paddle.grad(g1.sum(), x, create_graph=True)
    (g3,) = paddle.grad(g2.sum(), x)
    np.testing.assert_allclose(g3.numpy(), [24 * 1.5], rtol=1e-5)


def test_create_graph_mixed_seed_accumulation(paddle):
    x = paddle.to_tensor(np.array([1.5], np.float32))
    x.stop_gradient = False
    y1 = (x ** 2).sum()
    y2 = y1 * y1
    (g,) = paddle.grad([y1, y2], [x], create_graph=True)
    np.testing.assert_allclose(g.numpy(), [2 * 1.5 + 4 * 1.5 ** 3],
                               rtol=1e-6)
    (gg,) = paddle.grad(g.sum(), x)
    np.testing.assert_allclose(gg.numpy(), [29.0], rtol=1e-6)


def test_create_graph_inside_no_grad_scope(paddle):
    x = paddle.to_tensor(np.array([1.5], np.float32))
    x.stop_gradient = False
    y = (x ** 3).sum()
    with paddle.no_grad():
        (g,) = paddle.grad(y, x, create_graph=True)
    np.testing.assert_allclose(g.numpy(), [3 * 1.5 ** 2], rtol=1e-6)
    (gg,) = paddle.grad(g.sum(), x)
    np.testing.assert_allclose(gg.numpy(), [6 * 1.5], rtol=1e-6)


def test_grad_allow_unused(paddle):
    x = paddle.to_tensor([1.], stop_gradient=False)
    z = paddle.to_tensor([2.], stop_gradient=False)
    y = (x * 3).sum()
    with pytest.raises(RuntimeError):
        paddle.grad(y, [x, z], retain_graph=True)
    gx, gz = paddle.grad(y, [x, z], allow_unused=True)
    np.testing.assert_allclose(gx.numpy(), [3.])
    assert gz is None


def test_pylayer_double_backward_matches_closed_form(paddle):
    PyLayer = paddle.autograd.PyLayer

    class Cube(PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x ** 3

        @staticmethod
        def backward(ctx, g):
            (x,) = ctx.saved_tensor()
            return 3.0 * x ** 2 * g

    x = paddle.to_tensor(np.array([0.7, -1.3, 2.1], np.float32))
    x.stop_gradient = False
    y = Cube.apply(x).sum()
    (gx,) = paddle.grad(y, x, create_graph=True)
    np.testing.assert_allclose(gx.numpy(), 3 * x.numpy() ** 2, rtol=1e-6)
    # d/dx (gx**2).sum() = 2*(3x^2)*(6x) = 36 x^3
    penalty = (gx ** 2).sum()
    (gp,) = paddle.grad(penalty, x)
    np.testing.assert_allclose(gp.numpy(), 36 * x.numpy() ** 3, rtol=1e-5)


def test_pylayer_gradient_penalty_matches_finite_differences(paddle):
    PyLayer = paddle.autograd.PyLayer

    class SoftAbs(PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return (x ** 2 + 1e-2) ** 0.5

        @staticmethod
        def backward(ctx, g):
            (x,) = ctx.saved_tensor()
            return g * x * (x ** 2 + 1e-2) ** -0.5

    w = np.random.RandomState(5).randn(3, 3).astype(np.float64)
    xs = np.random.RandomState(1).randn(4, 3).astype(np.float64)

    def penalty(w_np, with_grad=False):
        wt = paddle.to_tensor(w_np.astype(np.float64))
        wt.stop_gradient = False
        out = SoftAbs.apply(paddle.matmul(paddle.to_tensor(xs), wt)).sum()
        (gw,) = paddle.grad(out, wt, create_graph=True)
        p = (gw ** 2).sum()
        return paddle.grad(p, wt)[0] if with_grad else float(p)

    gp = penalty(w, with_grad=True)
    eps = 1e-6
    fd = np.zeros_like(w)
    for i in range(3):
        for j in range(3):
            wp, wm = w.copy(), w.copy()
            wp[i, j] += eps
            wm[i, j] -= eps
            fd[i, j] = (penalty(wp) - penalty(wm)) / (2 * eps)
    np.testing.assert_allclose(gp.numpy(), fd, rtol=1e-4, atol=1e-6)


# -- the aliasing rule and in-place rebinding ---------------------------------

def test_a_view_taken_before_an_inplace_write_keeps_its_values(paddle):
    """JAX arrays are immutable, so ``y = x[0]; x[0] = 5`` leaves y as it
    was; the port's Tensor rebinds its value on every in-place form and
    never writes into the storage a torch view shares."""
    x = paddle.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3))
    row, col, whole = x[0], x[:, 1], x.reshape([6])
    x[0] = 5.0
    x.add_(paddle.ones([2, 3]))
    x.scale_(2.0)
    x.zero_()
    np.testing.assert_array_equal(row.numpy(), [0., 1., 2.])
    np.testing.assert_array_equal(col.numpy(), [1., 4.])
    np.testing.assert_array_equal(whole.numpy(), np.arange(6))
    np.testing.assert_array_equal(x.numpy(), np.zeros((2, 3)))
    h = x.numpy()               # read-only in the JAX package, a copy here
    if h.flags.writeable:
        h[0, 0] = 7.0
    assert x[0, 0].item() == 0.0


def test_inplace_rebinding_keeps_the_graph(paddle):
    x = paddle.to_tensor([1., 2., 3.], stop_gradient=False)
    y = x * 2
    y.add_(paddle.to_tensor([1., 1., 1.]))
    y.multiply_(x)                      # y = (2x + 1) * x
    y[1] = 0.0
    y.exp_()
    y.sum().backward()
    xv = x.numpy()
    want = np.exp((2 * xv + 1) * xv) * (4 * xv + 1)
    want[1] = 0.0
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=1e-5)
    assert not y.stop_gradient and not y.is_leaf


def test_inplace_on_a_leaf_under_no_grad_keeps_it_a_leaf(paddle):
    w = paddle.to_tensor([1., 2.], stop_gradient=False)
    (w * w).sum().backward()
    with paddle.no_grad():
        w.add_(paddle.to_tensor([10., 10.]))
        w[0] = 0.5
    assert w.is_leaf and not w.stop_gradient
    np.testing.assert_allclose(w.numpy(), [0.5, 12.])
    np.testing.assert_allclose(w.grad.numpy(), [2., 4.])


# -- the port against the JAX package -----------------------------------------

def test_creation_without_a_place_and_a_card_raises():
    """The default place is CUDAPlace(0); with no card it raises, never
    a CPU tensor (the JAX package falls back quietly)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default place works")
    from paddle_tpu_torch.core import place
    saved = place._current_place
    place._current_place = paddle_tpu_torch.CUDAPlace(0)
    try:
        for make in (lambda: paddle_tpu_torch.to_tensor([1.0]),
                     lambda: paddle_tpu_torch.zeros([2]),
                     lambda: paddle_tpu_torch.randn([2]),
                     lambda: paddle_tpu_torch.set_device("gpu")):
            with pytest.raises(RuntimeError, match="no CUDA card"):
                make()
        assert paddle_tpu_torch.to_tensor(
            [1.0], place=paddle_tpu_torch.CPUPlace()).place == \
            paddle_tpu_torch.CPUPlace()
    finally:
        place._current_place = saved


def test_places_and_devices():
    P = paddle_tpu_torch
    assert P.set_device("cpu") == P.CPUPlace() and P.get_device() == "cpu"
    assert P.to_tensor([1.0]).place == P.CPUPlace()
    assert P.CUDAPlace(1) == P.CUDAPlace(1) != P.CUDAPlace(0)
    assert P.CUDAPlace(0).get_device_id() == 0
    assert P.device.device_count() == torch.cuda.device_count()
    assert not P.is_compiled_with_tpu() and not P.is_compiled_with_xpu()
    with pytest.raises(ValueError):
        P.set_device("tpu")
    assert P.device.get_device() == "cpu"
    assert P.device.get_available_device()[0] == "cpu"


@pytest.mark.parametrize("alias", ["bool", "uint8", "int8", "int16", "int32",
                                   "int64", "float16", "fp16", "half",
                                   "bfloat16", "bf16", "float32", "fp32",
                                   "float", "float64", "fp64", "double",
                                   "complex64", "complex128"])
def test_dtype_aliases_match(alias):
    from paddle_tpu.core import dtype as jd
    from paddle_tpu_torch.core import dtype as td
    assert td.dtype_name(td.convert_dtype(alias)) == \
        jd.dtype_name(jd.convert_dtype(alias))
    assert td.convert_dtype(alias) is getattr(torch, td.dtype_name(alias)
                                              .replace("bool", "bool"))
    assert td.is_floating_point(alias) == jd.is_floating_point(alias)
    assert td.is_integer(alias) == jd.is_integer(alias)


def test_default_dtype_round_trip():
    P = paddle_tpu_torch
    P.set_device("cpu")
    assert P.get_default_dtype() is torch.float32
    P.set_default_dtype("float64")
    try:
        assert P.to_tensor(1.5).dtype is torch.float64
        assert P.zeros([1]).dtype is torch.float64
    finally:
        P.set_default_dtype("float32")
    with pytest.raises(TypeError):
        P.set_default_dtype("int32")


_PROMOTE = [
    ("i64 + 1.5", lambda p, t: t["i64"] + 1.5),
    ("i32 + 1.5", lambda p, t: t["i32"] + 1.5),
    ("i64 + 1", lambda p, t: t["i64"] + 1),
    ("bool + 1", lambda p, t: t["b"] + 1),
    ("bool + 1.5", lambda p, t: t["b"] + 1.5),
    ("bool + bool", lambda p, t: t["b"] + t["b"]),
    ("u8 + i8", lambda p, t: t["u8"] + t["i8"]),
    ("f32 + f64 0-d", lambda p, t: t["f32"] + t["f64s"]),
    ("f32 + i64", lambda p, t: t["f32"] + t["i64"]),
    ("f16 * 1.5", lambda p, t: t["f16"] * 1.5),
    ("i64 / i64", lambda p, t: t["i64"] / t["i64"]),
    ("i32 / i32", lambda p, t: t["i32"] / t["i32"]),
    ("i32 / 2", lambda p, t: t["i32"] / 2),
    ("bool / 2", lambda p, t: t["b"] / 2),
    ("i64 ** 0.5", lambda p, t: t["i64"] ** 0.5),
    ("2 ** i64", lambda p, t: 2 ** t["i64"]),
    ("i64 // 2", lambda p, t: t["i64"] // 2),
    ("i64 % 2.5", lambda p, t: t["i64"] % 2.5),
    ("f32 * 1j", lambda p, t: t["f32"] * 1j),
    ("sqrt(i32)", lambda p, t: p.sqrt(t["i32"])),
    ("sqrt(i64)", lambda p, t: p.sqrt(t["i64"])),
    ("exp(bool)", lambda p, t: p.exp(t["b"])),
    ("mean(i32)", lambda p, t: p.mean(t["i32"])),
    ("mean(i64)", lambda p, t: p.mean(t["i64"])),
    ("std(i64)", lambda p, t: p.std(t["i64"])),
    ("sum(i32)", lambda p, t: p.sum(t["i32"])),
    ("sum(bool)", lambda p, t: p.sum(t["b"])),
    ("prod(i32)", lambda p, t: p.prod(t["i32"])),
    ("cumsum(i32)", lambda p, t: p.cumsum(t["i32"])),
    ("cumsum(bool)", lambda p, t: p.cumsum(t["b"])),
    ("max(i32)", lambda p, t: p.max(t["i32"])),
    ("median(i64)", lambda p, t: p.median(t["i64"])),
    ("floor(i64)", lambda p, t: p.floor(t["i64"])),
    ("scale(i64)", lambda p, t: p.scale(t["i64"], 2.0)),
    ("clip(i64)", lambda p, t: p.clip(t["i64"], 0.5, 1.5)),
    ("maximum(i32, f32)", lambda p, t: p.maximum(t["i32"], t["f32"])),
    ("where(bool, i64, 0.5)", lambda p, t: p.where(t["b"], t["i64"], 0.5)),
    ("concat(i32, i64)", lambda p, t: p.concat([t["i32"], t["i64"]])),
]


@pytest.mark.parametrize("case", [c[0] for c in _PROMOTE])
def test_type_promotion_follows_jax(case):
    """Where torch promotes differently (0-d tensors, int with a Python
    float, integer division and float functions of integers, integer
    scans), the port follows the JAX package (x64 on): dtype equal,
    values to 1e-6."""
    fn = dict(_PROMOTE)[case]
    paddle_tpu_torch.set_device("cpu")
    outs = []
    for p in (paddle_tpu, paddle_tpu_torch):
        t = dict(i64=p.to_tensor(np.array([1, 2], np.int64)),
                 i32=p.to_tensor(np.array([1, 2], np.int32)),
                 i8=p.to_tensor(np.array([1, 2], np.int8)),
                 u8=p.to_tensor(np.array([1, 2], np.uint8)),
                 b=p.to_tensor(np.array([True, False])),
                 f16=p.to_tensor(np.array([1, 2], np.float16)),
                 f32=p.to_tensor(np.array([1, 2], np.float32)),
                 f64s=p.to_tensor(np.array(2.0)))
        out = fn(p, t)
        outs.append((_name(p, out.dtype), out.numpy()))
    (jd, jv), (td, tv) = outs
    assert td == jd
    np.testing.assert_allclose(tv, jv, rtol=1e-6)


def test_random_ops_shape_dtype_range_moments_and_seed():
    """Draws cannot equal the JAX package's: shape, dtype, range, moments
    (4-sigma bounds at n = 20000) and same-seed determinism, as the JAX
    package's own tests hold them."""
    P = paddle_tpu_torch
    P.set_device("cpu")
    P.seed(7)
    n = 20000
    u = P.uniform([n], min=-2.0, max=3.0)
    assert u.dtype is torch.float32 and u.shape == [n]
    v = u.numpy()
    assert v.min() >= -2.0 and v.max() < 3.0
    assert abs(v.mean() - 0.5) < 4 * 5 / np.sqrt(12 * n)
    z = P.randn([n]).numpy()
    assert abs(z.mean()) < 4 / np.sqrt(n) and abs(z.std() - 1) < 0.03
    r = P.randint(2, 9, [n]).numpy()
    assert r.dtype == np.int64 and r.min() == 2 and r.max() == 8
    perm = P.randperm(50).numpy()
    assert sorted(perm.tolist()) == list(range(50))
    b = P.bernoulli(P.full([n], 0.3)).numpy()
    assert set(np.unique(b)) <= {0.0, 1.0} and abs(b.mean() - 0.3) < 0.02
    m = P.multinomial(P.to_tensor([[0.1, 0.0, 0.9]]), 5, True).numpy()
    assert m.shape == (1, 5) and 1 not in m
    x = P.zeros([n]).normal_(1.0, 2.0).numpy()
    assert abs(x.mean() - 1.0) < 4 * 2 / np.sqrt(n)
    assert P.poisson(P.full([4], 3.0)).dtype is torch.float32
    P.seed(11)
    a = [P.rand([3]).numpy(), P.normal(0.0, 1.0, [3]).numpy()]
    P.seed(11)
    c = [P.rand([3]).numpy(), P.normal(0.0, 1.0, [3]).numpy()]
    for s, t in zip(a, c):
        np.testing.assert_array_equal(s, t)
    state = P.get_rng_state()
    d = P.rand([3]).numpy()
    P.set_rng_state(state)
    np.testing.assert_array_equal(P.rand([3]).numpy(), d)
    # the port never touches torch's global generator
    torch.manual_seed(0)
    ref = torch.rand(3)
    torch.manual_seed(0)
    P.rand([3])
    assert torch.equal(torch.rand(3), ref)


def _rs_inputs():
    rs = np.random.RandomState(3)
    return dict(a=rs.standard_normal((3, 4)).astype(np.float32),
                b=rs.standard_normal((3, 4)).astype(np.float32),
                c=rs.standard_normal((4, 2)).astype(np.float32),
                v=rs.standard_normal(5).astype(np.float32),
                cplx=rs.standard_normal((3, 2)).astype(np.float32),
                idx=np.array([[0, 1], [2, 0]], np.int64))


# functions outside OP_REGISTRY (created, composed or list-taking), the
# same call on both packages
_UNREGISTERED = {
    "zeros": lambda p, t: p.zeros([2, 3], "int32"),
    "ones": lambda p, t: p.ones([2]),
    "full": lambda p, t: p.full([2, 2], 1.5),
    "full tensor": lambda p, t: p.full([2], p.to_tensor(3)),
    "empty": lambda p, t: p.empty([2]),
    "zeros_like": lambda p, t: p.zeros_like(t["a"], "float64"),
    "ones_like": lambda p, t: p.ones_like(t["a"]),
    "full_like": lambda p, t: p.full_like(t["a"], 2.0),
    "empty_like": lambda p, t: p.empty_like(t["a"]),
    "arange": lambda p, t: p.arange(1, 10, 2),
    "arange float": lambda p, t: p.arange(0.0, 1.0, 0.25),
    "linspace": lambda p, t: p.linspace(0, 1, 7),
    "logspace": lambda p, t: p.logspace(0, 2, 5),
    "eye": lambda p, t: p.eye(3, 4),
    "meshgrid": lambda p, t: p.meshgrid(t["v"], t["v"][:3]),
    "assign": lambda p, t: p.assign(t["a"]),
    "clone": lambda p, t: p.clone(t["a"]),
    "numel": lambda p, t: p.numel(t["a"]),
    "one_hot": lambda p, t: p.one_hot(p.to_tensor([0, 2, 1]), 4),
    "complex": lambda p, t: p.complex(t["a"], t["b"]),
    "as_complex": lambda p, t: p.as_complex(t["cplx"]),
    "as_real": lambda p, t: p.as_real(p.as_complex(t["cplx"])),
    "concat": lambda p, t: p.concat([t["a"], t["b"]], axis=1),
    "stack": lambda p, t: p.stack([t["a"], t["b"]], axis=-1),
    "split": lambda p, t: p.split(t["a"], [1, -1], axis=1),
    "split even": lambda p, t: p.split(t["a"], 2, axis=1),
    "chunk": lambda p, t: p.chunk(t["a"], 3, axis=0),
    "unbind": lambda p, t: p.unbind(t["a"], axis=1),
    "expand_as": lambda p, t: p.expand_as(t["a"][0:1], t["b"]),
    "broadcast_tensors": lambda p, t: p.broadcast_tensors(
        [t["a"], t["a"][0]]),
    "scatter_nd": lambda p, t: p.scatter_nd(
        p.to_tensor(np.array([[1], [3]], np.int64)), t["a"][:2], [5, 4]),
    "slice": lambda p, t: p.slice(t["a"], [0, 1], [1, -3], [3, 10]),
    "strided_slice": lambda p, t: p.strided_slice(t["a"], [1], [3], [0],
                                                  [-2]),
    "crop": lambda p, t: p.crop(t["a"], [2, -1], [1, 2]),
    "tensordot": lambda p, t: p.tensordot(t["a"], t["c"], axes=1),
    "multi_dot": lambda p, t: p.multi_dot([t["a"], t["c"], t["c"].T]),
    "einsum": lambda p, t: p.einsum("ij,jk->ik", t["a"], t["c"]),
    "add_n": lambda p, t: p.add_n([t["a"], t["b"], t["a"]]),
    "where": lambda p, t: p.where(t["a"] > 0, t["a"], t["b"]),
    "where nonzero": lambda p, t: p.where(t["a"] > 0),
    "is_empty": lambda p, t: p.is_empty(t["a"]),
    "T": lambda p, t: t["a"].T,
    "getitem": lambda p, t: t["a"][t["idx"]],
    "cast": lambda p, t: t["a"].astype("float16"),
    "flatten_": lambda p, t: t["a"].clone().flatten_(),
    "lerp_": lambda p, t: t["a"].clone().lerp_(t["b"], 0.25),
    "method chunk": lambda p, t: t["a"].chunk(2, axis=1),
}


@pytest.mark.parametrize("name", sorted(_UNREGISTERED))
def test_unregistered_functions_match_jax(name):
    paddle_tpu_torch.set_device("cpu")
    outs = []
    for p in (paddle_tpu, paddle_tpu_torch):
        t = {k: p.to_tensor(v) for k, v in _rs_inputs().items()}
        out = _UNREGISTERED[name](p, t)
        out = list(out) if isinstance(out, (list, tuple)) else [out]
        outs.append([(_name(p, o.dtype), o.numpy()) for o in out])
    assert len(outs[0]) == len(outs[1])
    for (jd, jv), (td, tv) in zip(*outs):
        assert td == jd and np.shape(tv) == np.shape(jv)
        np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-6)


def test_saved_tensors_hooks_pack_and_unpack():
    """``paddle.autograd.saved_tensors_hooks`` is torch's: pack runs as an
    op records its residuals, unpack at backward, grads unchanged."""
    P = paddle_tpu_torch
    P.set_device("cpu")
    packed, unpacked = [], []

    def pack(t):
        packed.append(tuple(t.shape))
        return t.clone()

    def unpack(t):
        unpacked.append(tuple(t.shape))
        return t

    x = P.to_tensor([1., 2., 3.], stop_gradient=False)
    with P.autograd.saved_tensors_hooks(pack, unpack):
        y = (P.sin(x) * x).sum()
    assert packed and not unpacked
    y.backward()
    assert unpacked
    xv = x.numpy()
    np.testing.assert_allclose(x.grad.numpy(), np.cos(xv) * xv + np.sin(xv),
                               rtol=1e-6)


def test_check_nan_inf_flag():
    from paddle_tpu_torch.core import op
    P = paddle_tpu_torch
    P.set_device("cpu")
    op.CHECK_NAN_INF = True
    try:
        P.exp(P.to_tensor([1.0]))
        with pytest.raises(RuntimeError, match="1 NaN and 0 Inf"):
            P.log(P.to_tensor([-1.0]))
    finally:
        op.CHECK_NAN_INF = False
