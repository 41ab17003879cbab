"""The rest of the port's ``incubate`` (``autograd``, ``asp``,
``autotune``, ``multiprocessing``, ``passes``) and ``strings`` against
the JAX package's, on the CPU.

``autograd``: the same numpy-seeded inputs through both packages'
``jvp``, ``vjp``, ``Jacobian``, ``Hessian`` (with ``is_batched``),
``forward_grad`` and ``grad`` over functions 4-8 wide: within 1e-5
relative, with an absolute floor of 1e-5 of the largest magnitude.
``asp``: the masks equal the JAX package's bit for bit on the same
weights; sparsity survives the decorated optimizer's steps.
``multiprocessing``: a Tensor through the reducer, a queue, and a
spawned consumer and back (its own timeout), equal bit for bit, nothing
left in ``/dev/shm``.  ``autotune``, ``passes`` and ``strings`` behave
as the JAX package's.  Every process-wide setting a test changes is
restored in a ``finally``; the autouse fixture checks it.

The specs are ``tests/test_text_audio_sparse_autograd.py:189-238, 262``,
``tests/test_fft_linalg_incubate_opt.py:126-151``,
``tests/test_legacy_namespaces.py:229-242`` and
``tests/test_text_datasets_mp.py:171-177``.
"""
import contextlib
import copy
import json
import os
import pickle
from multiprocessing.reduction import ForkingPickler

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as jpaddle
import paddle_tpu.incubate.asp as jasp
import paddle_tpu.incubate.autograd as jag
import paddle_tpu.incubate.autotune as jautotune
import paddle_tpu.incubate.passes as jpasses
import paddle_tpu.nn.layout as jlayout
import paddle_tpu.strings as jstrings

import _torch_global_state as global_state
import paddle_tpu_torch as paddle
import paddle_tpu_torch.incubate.asp as pasp
import paddle_tpu_torch.incubate.autograd as pag
import paddle_tpu_torch.incubate.autotune as pautotune
import paddle_tpu_torch.incubate.multiprocessing as pmp
import paddle_tpu_torch.incubate.passes as ppasses
import paddle_tpu_torch.nn.layout as playout
import paddle_tpu_torch.strings as pstrings
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
    floor = rtol * max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=floor,
                               err_msg=what)


def _tree_close(got, want, what=""):
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want)
        for g, w in zip(got, want):
            _tree_close(g, w, what)
        return
    _close(got, want, what=what)


# -- autograd ----------------------------------------------------------------

RS = np.random.RandomState(0)
W1 = RS.standard_normal((6, 8)).astype(np.float32) / 3
B1 = RS.standard_normal((8,)).astype(np.float32) / 3
W2 = RS.standard_normal((8, 4)).astype(np.float32) / 3
X = RS.standard_normal((3, 6)).astype(np.float32)
Y = RS.standard_normal((3, 6)).astype(np.float32)


def _mlp(pkg):
    w1, b1, w2 = (pkg.to_tensor(a) for a in (W1, B1, W2))

    def f(x):
        return pkg.tanh(pkg.matmul(pkg.tanh(pkg.matmul(x, w1) + b1), w2))
    return f


def _two_inputs(pkg):
    def f(x, y):
        return pkg.sin(x) * y + x * x
    return f


def _scalar(pkg):
    f = _mlp(pkg)

    def g(x):
        return (f(x) ** 2).sum()
    return g


def _per_row(pkg):
    f = _mlp(pkg)

    def g(x):
        return (f(x) ** 3).sum(-1, keepdim=True)
    return g


def _both(fn, make, *arrays, **kw):
    want = fn(jag, make(jpaddle), [jpaddle.to_tensor(a) for a in arrays], kw)
    got = fn(pag, make(paddle), [paddle.to_tensor(a) for a in arrays], kw)
    return got, want


def _pkg(m):
    return jpaddle if m is jag else paddle


def test_jvp_vjp_match_jax():
    v = RS.standard_normal(X.shape).astype(np.float32)
    cot = RS.standard_normal((3, 4)).astype(np.float32)
    for tangent in (None, v):
        got, want = _both(lambda m, f, xs, kw: m.jvp(
            f, xs[0], None if tangent is None else
            _pkg(m).to_tensor(tangent)), _mlp, X)
        _tree_close(got, want, "jvp")
    for c in (None, cot):
        got, want = _both(lambda m, f, xs, kw: m.vjp(
            f, xs[0], None if c is None else _pkg(m).to_tensor(c)), _mlp, X)
        _tree_close(got, want, "vjp")
    # two inputs: a list of gradients, a list of tangents
    got, want = _both(lambda m, f, xs, kw: m.vjp(f, xs), _two_inputs, X, Y)
    assert isinstance(got[1], list) and len(got[1]) == 2
    _tree_close(got, want, "vjp two inputs")
    got, want = _both(lambda m, f, xs, kw: m.jvp(f, xs, xs), _two_inputs,
                      X, Y)
    _tree_close(got, want, "jvp two inputs")
    got, want = _both(lambda m, f, xs, kw: m.forward_grad(f, xs[0]), _mlp, X)
    _close(got, want, what="forward_grad")
    got, want = _both(lambda m, f, xs, kw: m.grad(f, xs[0]), _mlp, X)
    _close(got, want, what="grad")
    assert got.stop_gradient


@pytest.mark.parametrize("batched", [False, True])
def test_jacobian_matches_jax(batched):
    got, want = _both(lambda m, f, xs, kw: m.Jacobian(f, xs[0], **kw),
                      _mlp, X, is_batched=batched)
    assert got.shape == list(want.shape)
    _close(got.numpy(), want.numpy(), what="Jacobian")
    _close(got[0], want[0], what="Jacobian row")
    got, want = _both(lambda m, f, xs, kw: m.Jacobian(f, xs), _two_inputs,
                      X[:1, :4], Y[:1, :4])
    assert got.shape == [list(s) for s in
                         ([1, 4, 1, 4], [1, 4, 1, 4])]
    _tree_close(got.numpy(), want.numpy(), "Jacobian two inputs")
    _tree_close(got[0], want[0], "Jacobian two inputs, row 0")


def test_hessian_matches_jax():
    got, want = _both(lambda m, f, xs, kw: m.Hessian(f, xs[0]), _scalar,
                      X[0])
    assert got.shape == [6, 6]
    _close(got.numpy(), want.numpy(), what="Hessian")
    _close(got[1], want[1], what="Hessian row")
    got, want = _both(lambda m, f, xs, kw: m.Hessian(f, xs[0],
                                                     is_batched=True),
                      _per_row, X)
    assert got.shape == [3, 6, 6]
    _close(got.numpy(), want.numpy(), what="batched Hessian")

    def two(pkg):
        return lambda x, y: (pkg.sin(x) * y * y).sum()
    got, want = _both(lambda m, f, xs, kw: m.Hessian(f, xs), two,
                      X[0, :4], Y[0, :4])
    got_m, want_m = got._compute(), want._compute()
    for i in range(2):
        for j in range(2):
            _close(got_m[i][j], want_m[i][j], what=f"Hessian[{i}][{j}]")
    for mod, pkg in ((jag, jpaddle), (pag, paddle)):
        with pytest.raises(ValueError, match="one input"):
            mod.Hessian(lambda a, b: a.sum(), [pkg.to_tensor(X),
                                               pkg.to_tensor(Y)],
                        is_batched=True).numpy()


def test_functions_torch_func_cannot_trace_fall_back_to_autograd():
    """A factor read through numpy (a constant to both AD routes) makes
    ``torch.func`` refuse the function; ``torch.autograd.functional``
    runs it on real tensors.  ``float(t.sum())`` inside a batched
    Hessian's ``vmap`` takes the same route."""
    x = paddle.to_tensor(X[:2, :4])

    def f(t):
        return t * t * paddle.to_tensor(t.numpy())

    d = 3 * X[:2, :4] ** 2 - X[:2, :4] ** 2      # 2 t * t (t constant)
    _close(pag.jvp(f, x)[1], d)
    _close(pag.vjp(f, x)[1], d)
    jac = pag.Jacobian(f, x).numpy().reshape(8, 8)
    _close(jac, np.diag(d.reshape(-1)))
    assert pag.Jacobian(f, x, is_batched=True).shape == [2, 4, 4]

    def g(t):
        return (t ** 3 * float(t.sum())).sum(-1, keepdim=True)

    h = pag.Hessian(g, x, is_batched=True).numpy()
    for i in range(2):
        _close(h[i], np.diag(6 * X[i, :4] * X[i, :4].sum()))


def test_prim_switch_in_both_packages():
    for mod in (jag, pag):
        assert not mod.prim_enabled()
        try:
            mod.enable_prim()
            assert mod.prim_enabled()
        finally:
            mod.disable_prim()
        assert not mod.prim_enabled()


def test_spec_jvp_vjp():
    x = paddle.to_tensor(np.array([1.0, 2.0, 3.0], "float32"))
    out, tangent = pag.jvp(lambda t: t * t, x)
    np.testing.assert_allclose(tangent.numpy(), [2.0, 4.0, 6.0])
    out, g = pag.vjp(lambda t: t * t, x)
    np.testing.assert_allclose(g.numpy(), [2.0, 4.0, 6.0])


def test_spec_jacobian():
    x = paddle.to_tensor(np.array([1.0, 2.0], "float32"))
    np.testing.assert_allclose(np.asarray(pag.Jacobian(lambda t: t ** 2,
                                                       x).numpy()),
                               [[2.0, 0.0], [0.0, 4.0]])


def test_spec_hessian_batched():
    x = paddle.to_tensor(np.array([[1.0, 2.0], [3.0, 4.0]], "float32"))
    out = np.asarray(pag.Hessian(lambda t: (t ** 3).sum(-1, keepdim=True),
                                 x, is_batched=True).numpy())
    assert out.shape == (2, 2, 2)
    np.testing.assert_allclose(out[0], np.diag([6.0, 12.0]), rtol=1e-5)
    np.testing.assert_allclose(out[1], np.diag([18.0, 24.0]), rtol=1e-5)


def test_spec_hessian():
    x = paddle.to_tensor(np.array([1.0, 2.0, 3.0], "float32"))
    np.testing.assert_allclose(
        np.asarray(pag.Hessian(lambda t: (t * t).sum(), x).numpy()),
        2 * np.eye(3), atol=1e-6)


# -- asp ---------------------------------------------------------------------

@pytest.fixture
def asp_state():
    """Both packages' excluded names and mask registries, restored."""
    saved = [(m, set(m._EXCLUDED), dict(m._MASK_REGISTRY))
             for m in (jasp, pasp)]
    try:
        yield
    finally:
        for m, excluded, registry in saved:
            m._EXCLUDED.clear()
            m._EXCLUDED.update(excluded)
            m._MASK_REGISTRY.clear()
            m._MASK_REGISTRY.update(registry)


@pytest.mark.parametrize("shape", [(8, 8), (16, 12), (5, 4, 8), (3, 6)])
def test_masks_equal_jax_bit_for_bit(shape):
    w = np.random.RandomState(1).standard_normal(shape).astype(np.float32)
    rows = w.reshape(-1, shape[-1])
    rows[0, :4] = 0.5                  # ties inside a group
    rows[-1, -4:] = [-1.0, 1.0, 1.0, -1.0]
    want = np.asarray(jasp.create_mask(jpaddle.to_tensor(w)))
    got = pasp.create_mask(paddle.to_tensor(w))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(pasp.create_mask(w), jasp.create_mask(w))
    if shape[-1] % 4 == 0:
        assert pasp.check_mask_2d(got) and jasp.check_mask_2d(want)
    for n, m in ((1, 4), (2, 8)):
        if shape[-1] % m == 0:
            np.testing.assert_array_equal(
                pasp.create_mask(paddle.to_tensor(w), n=n, m=m).numpy(),
                np.asarray(jasp.create_mask(jpaddle.to_tensor(w), n=n,
                                            m=m)))
    assert pasp.calculate_density(got) == pytest.approx(
        jasp.calculate_density(want))
    assert pasp.calculate_density(paddle.to_tensor(w * got.numpy())) == \
        jasp.calculate_density(jpaddle.to_tensor(w * want))


def test_prune_model_matches_jax_and_excludes(asp_state):
    w = np.random.RandomState(3).standard_normal((8, 16)).astype(np.float32)
    nets = [jpaddle.nn.Linear(8, 16), paddle.nn.Linear(8, 16)]
    for net, pkg in zip(nets, (jpaddle, paddle)):
        net.set_state_dict({"weight": pkg.to_tensor(w),
                            "bias": pkg.to_tensor(np.zeros(16, np.float32))})
    jmasks, pmasks = jasp.prune_model(nets[0]), pasp.prune_model(nets[1])
    assert len(jmasks) == len(pmasks) == 1       # the bias is 1-D
    np.testing.assert_array_equal(list(pmasks.values())[0].numpy(),
                                  np.asarray(list(jmasks.values())[0]))
    np.testing.assert_array_equal(nets[1].weight.numpy(),
                                  nets[0].weight.numpy())
    net = paddle.nn.Linear(8, 8)
    pasp.set_excluded_layers([net.weight.name])
    assert pasp.prune_model(net) == {}
    pasp.reset_excluded_layers()
    assert list(pasp.prune_model(net)) == [net.weight.name]


def test_spec_asp_mask_and_decorate(asp_state):
    paddle.seed(2)
    net = paddle.nn.Linear(8, 8, bias_attr=False)
    masks = pasp.prune_model(net)
    assert masks, "no prunable weight found"
    w = net.weight.numpy()
    assert pasp.check_mask_2d((w != 0).astype("float32"))
    assert pasp.calculate_density(net.weight) == pytest.approx(0.5)
    opt = pasp.decorate(paddle.optimizer.SGD(parameters=net.parameters(),
                                             learning_rate=0.1), model=net)
    x = paddle.to_tensor(np.ones((4, 8), "float32"))
    for _ in range(3):
        loss = (net(x) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
    assert pasp.calculate_density(net.weight) == pytest.approx(0.5)
    assert np.array_equal(net.weight.numpy() != 0, w != 0)


def test_decorate_before_prune_keeps_sparsity(asp_state):
    paddle.seed(4)
    net = paddle.nn.Linear(8, 8, bias_attr=False)
    opt = pasp.decorate(paddle.optimizer.SGD(parameters=net.parameters(),
                                             learning_rate=0.1))
    pasp.prune_model(net)
    x = paddle.to_tensor(np.ones((2, 8), "float32"))
    (net(x) ** 2).mean().backward()
    opt.step()
    assert pasp.calculate_density(net.weight) == pytest.approx(0.5)


# -- autotune, passes, strings -----------------------------------------------

@pytest.fixture
def autotune_state():
    saved = [(m, copy.deepcopy(m._config), lay._global_on)
             for m, lay in ((jautotune, jlayout), (pautotune, playout))]
    try:
        yield
    finally:
        for m, config, on in saved:
            m._config.clear()
            m._config.update(config)
        jlayout.set_global_channels_last(saved[0][2])
        playout.set_global_channels_last(saved[1][2])


def test_spec_autotune_set_config(tmp_path, autotune_state):
    pautotune.set_config({"layout": {"enable": True}})
    assert playout.is_channels_last() and not jlayout.is_channels_last()
    assert paddle.nn.Conv2D(3, 4, 3)._data_format == "NHWC"
    pautotune.set_config({"layout": {"enable": False}})
    assert not playout.is_channels_last()
    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps(
        {"kernel": {"enable": True, "tuning_range": [1, 3]}}))
    pautotune.set_config(str(cfg))
    assert pautotune.get_config()["kernel"]["tuning_range"] == [1, 3]
    with pytest.raises(ValueError):
        pautotune.set_config(42)


def test_autotune_configs_equal_jax(autotune_state):
    for cfg in ({"kernel": {"enable": "yes", "tuning_range": 5}},
                {"dataloader": {"enable": True}}, None,
                {"layout": {"enable": False}}):
        for m in (jautotune, pautotune):
            with pytest.warns(UserWarning) if cfg and "kernel" in cfg \
                    else contextlib.nullcontext():
                m.set_config(copy.deepcopy(cfg))
        assert pautotune.get_config() == jautotune.get_config()
        assert playout.is_channels_last() == jlayout.is_channels_last()


def test_passes_flag_in_both_packages():
    for mod in (jpasses, ppasses):
        assert not mod.fuse_resnet_unit_requested()
        try:
            mod.fuse_resnet_unit()
            assert mod.fuse_resnet_unit_requested()
        finally:
            mod._requested = False


def test_strings_match_jax():
    data = [["Hello", "WÖRLD"], ["ÀbC", ""]]
    for name in ("lower", "upper"):
        got = getattr(pstrings, name)(pstrings.to_string_tensor(data))
        want = getattr(jstrings, name)(jstrings.to_string_tensor(data))
        assert got.tolist() == want.tolist() and got.shape == want.shape
        assert got == want.numpy()
    assert pstrings.lower("ABC").tolist() == "abc"
    e = pstrings.empty([2, 3])
    assert e.shape == (2, 3) and e == jstrings.empty([2, 3]).numpy()
    assert pstrings.empty_like(data).shape == (2, 2)
    assert "StringTensor(shape=(2, 2)" in repr(pstrings.StringTensor(data))


def test_spec_strings_ops():
    st = pstrings.to_string_tensor([["Hello", "WORLD"], ["MiXeD", ""]])
    assert pstrings.lower(st).tolist() == [["hello", "world"], ["mixed", ""]]
    assert pstrings.upper(st).tolist() == [["HELLO", "WORLD"], ["MIXED", ""]]
    e = pstrings.empty((2, 2))
    assert e.shape == (2, 2) and e.tolist() == [["", ""], ["", ""]]
    assert pstrings.empty_like(st).shape == st.shape


# -- multiprocessing ---------------------------------------------------------

@pytest.fixture
def reductions():
    """The port's reducer registered for the test, then taken out."""
    before = dict(ForkingPickler._extra_reducers)
    try:
        pmp.init_reductions()
        yield
    finally:
        ForkingPickler._extra_reducers.clear()
        ForkingPickler._extra_reducers.update(before)
        pmp._INITIALIZED = False


def _shm_names():
    return set(os.listdir("/dev/shm")) if os.path.isdir("/dev/shm") \
        else set()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int64, torch.bool, torch.float64])
def test_reducer_round_trip_exactly_once(dtype):
    v = torch.arange(12).reshape(3, 4).to(dtype)
    t = paddle.Tensor._wrap(v)
    fn, args = pmp._reduce_tensor(t)
    assert args[2] == str(dtype).split(".")[-1]
    out = fn(*args)
    assert out.dtype == dtype and torch.equal(out.value, v)
    assert out.stop_gradient
    assert args[0] not in _shm_names()
    with pytest.raises(FileNotFoundError):
        fn(*args)                       # rebuilt once: the segment is gone


def test_reducer_is_registered_on_the_port_tensor_only(reductions):
    assert ForkingPickler._extra_reducers[paddle.Tensor] is \
        pmp._reduce_tensor
    assert torch.Tensor not in ForkingPickler._extra_reducers or \
        ForkingPickler._extra_reducers[torch.Tensor] is not \
        pmp._reduce_tensor
    t = paddle.to_tensor(np.arange(4, dtype=np.float32))
    t.stop_gradient = False
    blob = ForkingPickler.dumps(t)
    out = pickle.loads(blob)
    assert np.array_equal(out.numpy(), t.numpy()) and not out.stop_gradient


def test_window_of_segments_is_bounded():
    made = [pmp._reduce_tensor(paddle.to_tensor(np.full(3, i, np.float32)))
            for i in range(pmp.WINDOW + 3)]
    try:
        assert len(pmp._LIVE_SEGMENTS) <= pmp.WINDOW
        assert {a[0] for _, a in made[:3]} <= set(pmp._EVICTED_NAMES)
        for i, (fn, args) in enumerate(made):
            assert float(fn(*args).numpy()[0]) == i
    finally:
        pmp._cleanup_segments()
    assert not pmp._LIVE_SEGMENTS and not pmp._EVICTED_NAMES


def test_spec_tensor_through_real_mp_queue(reductions):
    q = pmp.Queue()
    t = paddle.to_tensor(np.ones((4,), np.float32) * 7)
    q.put(t)
    out = q.get(timeout=30)
    np.testing.assert_array_equal(out.numpy(), t.numpy())


def test_round_trip_through_a_spawned_consumer(reductions):
    import _torch_mp_echo

    mine = {seg.name for seg in pmp._LIVE_SEGMENTS}
    q_in, q_out = pmp.Queue(), pmp.Queue()
    proc = pmp.Process(target=_torch_mp_echo.echo, args=(q_in, q_out, "cpu"))
    proc.start()
    try:
        x = np.random.RandomState(7).standard_normal((64, 33)).astype(
            np.float32)
        t = paddle.to_tensor(x)
        q_in.put(t)
        where, back = q_out.get(timeout=180)
        q_in.put(None)                  # the consumer may exit now
        theirs = q_out.get(timeout=60)
        assert where == "cpu" and back.dtype == torch.float32
        np.testing.assert_array_equal(back.numpy(), x)
        proc.join(timeout=60)
        assert proc.exitcode == 0
    finally:
        if proc.is_alive():
            proc.kill()
            proc.join()
    sent = {seg.name for seg in pmp._LIVE_SEGMENTS} - mine
    # each side's segment was rebuilt once and unlinked by the other side
    # (checked by name: other test processes make segments of their own)
    assert len(sent) == 1 and len(theirs) == 1
    assert not (sent | set(theirs)) & _shm_names()
    pmp._cleanup_segments()
