"""``paddle_tpu_torch.sparse`` against ``paddle_tpu.sparse`` on the CPU
(the spec: ``tests/test_text_audio_sparse_autograd.py``'s sparse cases).

Inputs are numpy arrays from a seed, carried into both packages; values
and gradients (through ``values()``, upstream weights from the seed) are
held at 1e-5 (f32), structures exactly.  The conv rulebooks equal the
JAX package's ``_build_rulebook`` exactly: the pairs as sorted
``(in, out, offset)`` triples, the output sites in order.
"""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.sparse as jsp
import paddle_tpu_torch
import paddle_tpu_torch.sparse as psp
from _torch_cpu_place import cpu_place  # noqa: F401
from paddle_tpu.sparse import _build_rulebook
from paddle_tpu_torch.sparse import conv as pconv

TOL = dict(rtol=1e-5, atol=1e-5)
PKGS = ((paddle_tpu, jsp), (paddle_tpu_torch, psp))


def _values(mod, vals):
    return mod.to_tensor(vals, stop_gradient=False)


def _coo(pkg, sp, idx, vals, shape):
    v = _values(pkg, vals)
    return sp.sparse_coo_tensor(idx, v, shape=shape), v


def _dense(x):
    return np.asarray(x.to_dense().numpy())


def _idx(x):
    return np.asarray(x.indices().numpy())


def _matrix(seed=0, shape=(4, 5), nnz=8, dups=False):
    rng = np.random.RandomState(seed)
    flat = rng.choice(shape[0] * shape[1], nnz, replace=dups)
    idx = np.stack(np.unravel_index(flat, shape)).astype(np.int64)
    return idx, rng.uniform(0.2, 0.9, nnz).astype(np.float32)


def test_the_namespace_is_covered():
    for jmod, pmod in ((jsp, psp), (jsp.nn, psp.nn),
                       (jsp.nn.functional, psp.nn.functional)):
        public = {n for n in dir(jmod) if not n.startswith("_")
                  and n not in ("annotations", "np", "jax", "jnp",
                                "jsparse", "Tensor")}
        missing = {n for n in public if not hasattr(pmod, n)}
        assert not missing, sorted(missing)
    import paddle_tpu.incubate.sparse as jinc

    import paddle_tpu_torch.incubate.sparse as pinc
    for sub in ("", "binary", "creation", "multiary", "nn", "unary"):
        jm = getattr(jinc, sub) if sub else jinc
        pm = getattr(pinc, sub) if sub else pinc
        public = {n for n in dir(jm) if not n.startswith("_")
                  and n not in ("annotations", "Layer")}
        assert not {n for n in public if not hasattr(pm, n)}, sub


def test_coo_csr_round_trip_matches_jax():
    idx, vals = _matrix(0, (5, 6), 11)
    out = {}
    for pkg, sp in PKGS:
        x, _ = _coo(pkg, sp, idx, vals, [5, 6])
        csr = x.to_sparse_csr()
        back = csr.to_sparse_coo()
        out[pkg] = (_dense(x), csr.crows().numpy(), csr.cols().numpy(),
                    csr.values().numpy(), _dense(back), x.nnz(), csr.nnz(),
                    x.shape)
    for a, b in zip(out[paddle_tpu], out[paddle_tpu_torch]):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    # a shape inferred from the indices
    x = psp.sparse_coo_tensor(idx, vals)
    assert x.shape == [int(idx[0].max()) + 1, int(idx[1].max()) + 1]


def test_coalesce_orders_and_sums_like_np_unique():
    rng = np.random.RandomState(1)
    idx = rng.randint(0, 3, (3, 20)).astype(np.int64)
    vals = rng.standard_normal((20, 2)).astype(np.float32)
    res = {}
    for pkg, sp in PKGS:
        x, v = _coo(pkg, sp, idx, vals, [3, 3, 3, 2])
        c = sp.coalesce(x)
        (c.values() * pkg.to_tensor(np.arange(c.nnz() * 2).reshape(
            -1, 2).astype(np.float32))).sum().backward()
        res[pkg] = _idx(c), c.values().numpy(), v.grad.numpy()
    want = np.unique(idx.T, axis=0).T
    np.testing.assert_array_equal(res[paddle_tpu_torch][0], want)
    for a, b in zip(res[paddle_tpu], res[paddle_tpu_torch]):
        np.testing.assert_allclose(b, a, **TOL)


VALUEWISE = ["abs", "sin", "sinh", "asin", "asinh", "tan", "tanh", "atan",
             "atanh", "acos", "sqrt", "square", "log1p", "expm1", "relu",
             "relu6", ("acosh", 1.5), ("leaky_relu", 0.0, dict(
                 negative_slope=0.2)), ("pow", 0.0, dict(factor=3)),
             ("scale", 0.0, dict(scale=2.0, bias=0.5)),
             ("scale", 0.0, dict(scale=2.0, bias=0.5,
                                 bias_after_scale=False)),
             ("divide_scalar", 0.0, dict(scalar=4.0)),
             ("cast", 0.0, dict(value_dtype="float64"))]


def _spec(s):
    s = (s,) if isinstance(s, str) else tuple(s)
    return s + (0.0, {})[len(s) - 1:]


@pytest.mark.parametrize("spec", VALUEWISE,
                         ids=[f"{_spec(s)[0]}-{i}" for i, s in
                              enumerate(VALUEWISE)])
def test_valuewise_ops_and_gradients_match_jax(spec):
    name, shift, kw = _spec(spec)
    idx, vals = _matrix(2, (4, 5), 7)
    vals = (vals - 0.55 + shift).astype(np.float32)
    res = {}
    for pkg, sp in PKGS:
        x, v = _coo(pkg, sp, idx, vals, [4, 5])
        y = getattr(sp, name)(x, **kw)
        y.values().astype("float32").sum().backward()
        res[pkg] = _idx(y), y.values().numpy(), v.grad.numpy(), y.shape
    assert res[paddle_tpu_torch][1].dtype == res[paddle_tpu][1].dtype
    for a, b in zip(res[paddle_tpu], res[paddle_tpu_torch]):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), **TOL)


def _binary(sp, pkg, name, x, y_sparse, y_dense, vec):
    if name == "add_sparse":
        return sp.add(x, y_sparse)
    if name == "add_dense":
        return sp.add(x, y_dense)
    if name == "subtract_sparse":
        return sp.subtract(x, y_sparse)
    if name == "subtract_dense":
        return sp.subtract(x, y_dense)
    if name == "multiply_dense":
        return sp.multiply(x, y_dense)
    if name == "multiply_sparse":
        return sp.multiply(x, y_sparse)
    if name == "multiply_scalar":
        return sp.multiply(x, pkg.to_tensor(np.float32(3.0)))
    if name == "divide_dense":
        return sp.divide(x, y_dense + 2.0)
    if name == "matmul":
        return sp.matmul(x, vec[0])
    if name == "mv":
        return sp.mv(x, vec[1])
    if name == "addmm":
        return sp.addmm(y_dense @ vec[0] * 0 + 1.0, x, vec[0], beta=0.5,
                        alpha=2.0)
    if name == "masked_matmul":
        return sp.masked_matmul(y_dense, vec[2], x)
    if name == "softmax":
        return sp.softmax(x)
    if name == "softmax_csr":
        return sp.softmax(x.to_sparse_csr())
    if name == "transpose":
        return sp.transpose(x, [1, 0])
    if name == "full_like":
        return sp.full_like(x, 2.5)
    if name == "full_like_csr":
        return sp.full_like(x.to_sparse_csr(), 2.5, dtype="float64")
    raise KeyError(name)


BINARY = ["add_sparse", "add_dense", "subtract_sparse", "subtract_dense",
          "multiply_dense", "multiply_sparse", "multiply_scalar",
          "divide_dense", "matmul", "mv", "addmm", "masked_matmul",
          "softmax", "softmax_csr", "transpose", "full_like",
          "full_like_csr"]


@pytest.mark.parametrize("name", BINARY)
def test_binary_and_matrix_ops_match_jax(name):
    idx, vals = _matrix(3, (4, 5), 9)
    idx2, vals2 = _matrix(4, (4, 5), 6)
    rng = np.random.RandomState(5)
    dense = rng.standard_normal((4, 5)).astype(np.float32)
    vecs = [rng.standard_normal((5, 3)).astype(np.float32),
            rng.standard_normal(5).astype(np.float32),
            rng.standard_normal((5, 5)).astype(np.float32)]
    res = {}
    for pkg, sp in PKGS:
        x, v = _coo(pkg, sp, idx, vals, [4, 5])
        y, _ = _coo(pkg, sp, idx2, vals2, [4, 5])
        d = _values(pkg, dense)
        vec = [_values(pkg, a) for a in vecs]
        out = _binary(sp, pkg, name, x, y, d, vec)
        is_sparse = not isinstance(out, pkg.Tensor)
        val = out.values() if is_sparse else out
        if val.dtype != x.values().dtype:
            val = val.astype("float32")
        w = np.random.RandomState(6).standard_normal(
            tuple(val.shape)).astype(np.float32)
        (val * pkg.to_tensor(w)).sum().backward()
        grads = [t.grad for t in [v, d] + vec]
        res[pkg] = ([_dense(out) if is_sparse else out.numpy(),
                     _idx(out) if hasattr(out, "indices") else None,
                     out.crows().numpy() if hasattr(out, "crows")
                     else None]
                    + [None if g is None else g.numpy() for g in grads])
    for i, (a, b) in enumerate(zip(res[paddle_tpu], res[paddle_tpu_torch])):
        assert (a is None) == (b is None), i
        if a is not None:
            np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                       err_msg=f"{name} output {i}", **TOL)


def test_hybrid_to_sparse_coo_transpose_and_cast():
    rng = np.random.RandomState(7)
    grid = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    grid[rng.uniform(size=(2, 3, 4)) < 0.6] = 0.0
    res = {}
    for pkg, sp in PKGS:
        g = _values(pkg, grid)
        x = sp.to_sparse_coo(g, sparse_dim=3)
        t = sp.transpose(x, [2, 0, 1, 3])
        c = sp.cast(x, index_dtype="int32", value_dtype="float64")
        (t.values() * 2).sum().backward()
        full = sp.to_sparse_coo(g.detach())
        res[pkg] = (_idx(x), x.values().numpy(), _dense(t), t.shape,
                    g.grad.numpy(), str(c.values().dtype).split(".")[-1],
                    full.nnz(), _idx(sp.to_sparse_csr(
                        sp.to_sparse_coo(g.detach()[0, 0])).to_sparse_coo()))
    assert res[paddle_tpu][5] == res[paddle_tpu_torch][5] == "float64"
    for a, b in zip(res[paddle_tpu], res[paddle_tpu_torch]):
        if not isinstance(a, str):
            np.testing.assert_allclose(np.asarray(b), np.asarray(a), **TOL)
    x = psp.to_sparse_coo(paddle_tpu_torch.to_tensor(grid), sparse_dim=3)
    assert psp.cast(x, index_dtype="int32").indices().dtype == torch.int32
    assert psp.is_same_shape(x, x) and not psp.is_same_shape(
        x, psp.to_sparse_coo(paddle_tpu_torch.to_tensor(grid[0])))


def _voxels(seed, batch, spatial, n, channels):
    rng = np.random.RandomState(seed)
    coords = np.unique(np.stack(
        [rng.randint(0, batch, n)] +
        [rng.randint(0, s, n) for s in spatial], 1), axis=0)
    vals = rng.standard_normal((len(coords), channels)).astype(np.float32)
    return coords, vals


# (kernel, stride, padding, dilation, subm): the JAX tests' settings
# (3x3x3 padding 1, plain and submanifold) and SECOND's strided layers
CONV_CASES = [
    ((3, 3, 3), 1, 1, 1, False),
    ((3, 3, 3), 1, 1, 1, True),
    ((3, 3, 3), 2, 1, 1, False),
    ((3, 3, 3), 2, (0, 1, 1), 1, False),
    ((3, 1, 1), (2, 1, 1), 0, 1, False),
    ((3, 3, 3), 1, 2, 2, True),
    ((2, 3, 3), (1, 2, 2), (1, 0, 1), (2, 1, 1), False),
    ((1, 1, 1), 1, 0, 1, True),
]


@pytest.mark.parametrize("ksize, stride, padding, dilation, subm",
                         CONV_CASES)
def test_rulebook_equals_jax_exactly(ksize, stride, padding, dilation, subm):
    coords, _ = _voxels(0, 2, (5, 7, 6), 60, 1)
    to3 = pconv._to3
    args = ((5, 7, 6), ksize, to3(padding), to3(dilation), to3(stride),
            subm)
    pin, pout, poff, out_idx, out_sp = _build_rulebook(coords, *args)
    rb = pconv.build_rulebook(torch.from_numpy(coords), 2, *args)
    qin, qout, qoff = (t.numpy() for t in pconv.rulebook_pairs(rb))
    assert tuple(rb.out_spatial) == tuple(out_sp)
    np.testing.assert_array_equal(rb.out_idx.numpy(), out_idx)
    assert rb.n_out == len(out_idx)
    want = sorted(zip(pin.tolist(), pout.tolist(), poff.tolist()))
    got = sorted(zip(qin.tolist(), qout.tolist(), qoff.tolist()))
    assert got == want and len(got) > 0


@pytest.mark.parametrize("ksize, stride, padding, dilation, subm",
                         CONV_CASES)
def test_conv3d_values_and_gradients_match_jax(ksize, stride, padding,
                                               dilation, subm):
    coords, vals = _voxels(1, 2, (5, 7, 6), 60, 3)
    rng = np.random.RandomState(2)
    w = (rng.standard_normal(ksize + (3, 4)) * 0.3).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    res = {}
    for pkg, sp in PKGS:
        x, v = _coo(pkg, sp, coords.T, vals, [2, 5, 7, 6, 3])
        wt, bt = _values(pkg, w), _values(pkg, b)
        fn = sp.subm_conv3d if subm else sp.conv3d
        out = fn(x, wt, bt, stride=stride, padding=padding,
                 dilation=dilation)
        up = np.random.RandomState(3).standard_normal(
            tuple(out.values().shape)).astype(np.float32)
        (sp.relu(out).values() * pkg.to_tensor(up)).sum().backward()
        res[pkg] = (_idx(out), out.values().numpy(), out.shape,
                    v.grad.numpy(), wt.grad.numpy(), bt.grad.numpy())
    for a, b_ in zip(res[paddle_tpu], res[paddle_tpu_torch]):
        np.testing.assert_allclose(np.asarray(b_), np.asarray(a), **TOL)


def test_consecutive_submanifold_layers_share_one_rulebook():
    coords, vals = _voxels(4, 1, (6, 6, 6), 50, 2)
    x = psp.sparse_coo_tensor(coords.T, vals, shape=[1, 6, 6, 6, 2])
    net = [psp.nn.SubmConv3D(2, 4, 3, padding=1),
           psp.nn.SubmConv3D(4, 4, 3, padding=1),
           psp.nn.Conv3D(4, 8, 3, stride=2, padding=1),
           psp.nn.SubmConv3D(8, 8, 3, padding=1),
           psp.nn.SubmConv3D(8, 8, 3, padding=1)]
    pconv.rulebook_stats(reset=True)
    h = x
    for layer in net:
        h = psp.nn.ReLU()(layer(h))
    assert pconv.rulebook_stats() == {"built": 3, "reused": 2}
    assert h.shape[1:4] == [3, 3, 3]


def test_max_pool3d_matches_jax_with_ties():
    coords, vals = _voxels(5, 1, (4, 6, 6), 40, 3)
    vals[:, 1] = 1.0                   # every window ties in channel 1
    res = {}
    for pkg, sp in PKGS:
        x, v = _coo(pkg, sp, coords.T, vals, [1, 4, 6, 6, 3])
        out = sp.max_pool3d(x, kernel_size=2, stride=2)
        out.values().sum().backward()
        res[pkg] = _idx(out), out.values().numpy(), out.shape, \
            v.grad.numpy()
    for a, b in zip(res[paddle_tpu], res[paddle_tpu_torch]):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), **TOL)
    # both split a tied window's gradient evenly among its sites
    g = res[paddle_tpu_torch][3][:, 1]
    assert 0 < g.min() and g.max() <= 1.0 and (g < 1.0).any()
    with pytest.raises(NotImplementedError):
        psp.max_pool3d(psp.sparse_coo_tensor(coords.T, vals), 2,
                       ceil_mode=True)
    with pytest.raises(NotImplementedError):
        psp.conv3d(psp.sparse_coo_tensor(coords.T, vals),
                   torch.zeros(3, 3, 3, 3, 2), data_format="NCDHW")
    with pytest.raises(NotImplementedError):
        psp.conv3d(psp.sparse_coo_tensor(coords.T, vals),
                   torch.zeros(3, 3, 3, 3, 2), groups=2)


@pytest.mark.parametrize("mask_kind", ["coo3d", "coo2d", "csr2d"])
def test_fused_attention_matches_jax(mask_kind):
    rng = np.random.RandomState(8)
    B, NH, M, HD = 2, 2, 8, 4
    qkv = [rng.standard_normal((B, NH, M, HD)).astype(np.float32)
           for _ in range(3)]
    kpm = np.where(rng.uniform(size=(B, M)) < 0.2, -1e4, 0.0).astype(
        np.float32)
    am = (rng.standard_normal((M, M)) * 0.1).astype(np.float32)
    if mask_kind == "coo3d":
        md = (rng.uniform(size=(B * NH, M, M)) < 0.4) | np.eye(M, dtype=bool)
    else:
        md = (np.abs(np.subtract.outer(np.arange(M), np.arange(M))) <= 2)
        md[:, :1] = md[:1, :] = True
    midx = np.argwhere(md).T
    res = {}
    for pkg, sp in PKGS:
        q, k, v = (_values(pkg, a) for a in qkv)
        mask = sp.sparse_coo_tensor(midx, np.ones(midx.shape[1],
                                                  np.float32),
                                    shape=list(md.shape))
        if mask_kind == "csr2d":
            mask = mask.to_sparse_csr()
        out = sp.fused_attention(q, k, v, mask,
                                 key_padding_mask=pkg.to_tensor(kpm),
                                 attn_mask=pkg.to_tensor(am))
        w = np.random.RandomState(9).standard_normal(out.shape).astype(
            np.float32)
        (out * pkg.to_tensor(w)).sum().backward()
        res[pkg] = [out.numpy()] + [t.grad.numpy() for t in (q, k, v)]
    for a, b in zip(res[paddle_tpu], res[paddle_tpu_torch]):
        np.testing.assert_allclose(b, a, **TOL)


def test_layers_carry_the_jax_weights():
    coords, vals = _voxels(6, 2, (6, 5, 6), 50, 2)
    layers = [("SubmConv3D", (2, 4, 3), dict(padding=1)),
              ("Conv3D", (4, 6, 3), dict(stride=2, padding=1)),
              ("MaxPool3D", (2,), dict(stride=1)),
              ("ReLU", (), {})]
    res = {}
    for pkg, sp in PKGS:
        x, v = _coo(pkg, sp, coords.T, vals, [2, 6, 5, 6, 2])
        h = x
        for name, args, kw in layers:
            layer = getattr(sp.nn, name)(*args, **kw)
            if "Conv" not in name:      # no parameters to carry
                h = layer(h)
                continue
            if pkg is paddle_tpu:
                sd = {k: np.asarray(t.numpy())
                      for k, t in layer.state_dict().items()}
                res.setdefault("state", []).append(sd)
            else:
                want = res["state"].pop(0)
                assert set(layer.state_dict()) == set(want), name
                layer.set_state_dict(want)
            h = layer(h)
        h.values().sum().backward()
        res[pkg] = _idx(h), h.values().numpy(), v.grad.numpy()
    for a, b in zip(res[paddle_tpu], res[paddle_tpu_torch]):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), **TOL)


def test_incubate_sparse_layers():
    import paddle_tpu.incubate.sparse as jinc

    import paddle_tpu_torch.incubate.sparse as pinc
    idx, vals = _matrix(9, (3, 4), 6)
    vals = vals - 0.5
    res = {}
    for (pkg, _), inc in zip(PKGS, (jinc, pinc)):
        x = inc.sparse_coo_tensor(idx, vals, shape=[3, 4])
        outs = [inc.nn.ReLU()(x), inc.nn.ReLU6()(inc.unary.scale(x, 10.0)),
                inc.nn.LeakyReLU(0.3)(x), inc.nn.Softmax()(x),
                inc.unary.tanh(x), inc.binary.add(x, x),
                inc.creation.sparse_csr_tensor(
                    [0, 2, 4, 6], idx[1][:6] % 4, vals, [3, 4])]
        res[pkg] = [_dense(o) for o in outs] + [
            inc.multiary.addmm(pkg.to_tensor(np.ones((3, 2), np.float32)),
                               x, pkg.to_tensor(np.ones((4, 2),
                                                        np.float32))).numpy()]
    assert paddle_tpu_torch.incubate.sparse is pinc
    assert pinc.nn.SubmConv3D is psp.nn.SubmConv3D
    for a, b in zip(res[paddle_tpu], res[paddle_tpu_torch]):
        np.testing.assert_allclose(b, a, **TOL)
