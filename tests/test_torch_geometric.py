"""The port's ``geometric`` (message passing, segment reductions,
sampling, reindexing), ``incubate.operators``' graph ops and
``incubate``'s segment names against the JAX package, on the CPU.

The same seeded numpy graphs go through both packages.  Tolerances:

* sum, mean, max and min reductions and their gradients (through
  ``loss = sum(out * w)`` with a fixed random ``w``), f32: rtol 1e-6 with
  an absolute floor of 1e-6 of the largest value (f32 sums of the same
  terms in another order); integer features exactly;
* untouched segments are 0 for max and min, ids outside ``[0, n)`` are
  dropped, mean divides by ``max(count, 1)`` in f32: exactly as JAX;
* ``sample_neighbors`` (both generators lazily seeded from the same
  framework seed, and a ``perm_buffer``), ``reindex_graph``,
  ``reindex_heter_graph`` and ``graph_khop_sampler``: exactly.

The spec is ``tests/test_geometric.py`` and
``tests/test_legacy_namespaces.py:180-194, 220-225``.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as jpaddle
from paddle_tpu import geometric as JG
from paddle_tpu.geometric import sampling as jsampling
from paddle_tpu.incubate import operators as jops

import paddle_tpu_torch as paddle
from paddle_tpu_torch import geometric as PG
from paddle_tpu_torch.geometric import sampling as psampling
from paddle_tpu_torch.incubate import operators as pops
from _torch_cpu_place import cpu_place  # noqa: F401,E402

torch.set_num_threads(1)


def _np(v):
    if isinstance(v, (jpaddle.Tensor, paddle.Tensor)):
        return v.numpy()
    if torch.is_tensor(v):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _close(got, want, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (
        what, got.shape, want.shape, got.dtype, want.dtype)
    if not np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    floor = 1e-6 * max(float(np.abs(want).max()), 1.0) if want.size else 0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=floor,
                               err_msg=what)


def _pair(arr, grad=False):
    j, p = jpaddle.to_tensor(arr), paddle.to_tensor(arr)
    if grad:
        j.stop_gradient = False
        p.stop_gradient = False
    return j, p


def _graph(seed, n=40, e=300, f=8):
    """A random directed graph: features, edge features, src, dst (node
    39 receives no edge, so every reduction has an untouched row)."""
    rs = np.random.RandomState(seed)
    x = rs.standard_normal((n, f)).astype(np.float32)
    y = rs.uniform(0.5, 2.0, (e, f)).astype(np.float32)
    src = rs.randint(0, n, e).astype(np.int64)
    dst = rs.randint(0, n - 1, e).astype(np.int64)
    return x, y, src, dst


def _both(fn_j, fn_p, arrays, grad_idx=(), seed=0):
    """Run ``fn(*tensors)`` in both packages: outputs, then the gradients
    of ``sum(out * w)`` for the arrays at ``grad_idx``."""
    res = []
    for i, fn in enumerate((fn_j, fn_p)):
        ts = [_pair(a, k in grad_idx)[i] for k, a in enumerate(arrays)]
        out = fn(*ts)
        grads = []
        if grad_idx:
            w = np.random.RandomState(seed).standard_normal(
                tuple(out.shape)).astype(np.float32)
            (out * _pair(w)[i]).sum().backward()
            grads = [ts[k].grad for k in grad_idx]
        res.append([out] + grads)
    for a, b in zip(res[1], res[0]):
        assert a is not None and b is not None
        _close(a, b)
    return res


@pytest.mark.parametrize("reduce_op", ["sum", "mean", "max", "min"])
def test_send_u_recv_matches_jax(reduce_op):
    x, _, src, dst = _graph(0)
    res = _both(lambda *t: JG.send_u_recv(*t, reduce_op=reduce_op),
                lambda *t: PG.send_u_recv(*t, reduce_op=reduce_op),
                (x, src, dst), grad_idx=(0,))
    assert not res[1][0].numpy()[39].any()      # the untouched node: 0


@pytest.mark.parametrize("message_op, reduce_op", [
    ("add", "sum"), ("sub", "mean"), ("mul", "max"), ("div", "min")])
def test_send_ue_recv_matches_jax(message_op, reduce_op):
    x, y, src, dst = _graph(1)
    _both(lambda *t: JG.send_ue_recv(*t, message_op=message_op,
                                     reduce_op=reduce_op, out_size=48),
          lambda *t: PG.send_ue_recv(*t, message_op=message_op,
                                     reduce_op=reduce_op, out_size=48),
          (x, y, src, dst), grad_idx=(0, 1))


@pytest.mark.parametrize("message_op", ["add", "sub", "mul", "div"])
def test_send_uv_matches_jax(message_op):
    x, _, src, dst = _graph(2)
    y = np.random.RandomState(3).uniform(0.5, 2, x.shape).astype(np.float32)
    _both(lambda *t: JG.send_uv(*t, message_op=message_op),
          lambda *t: PG.send_uv(*t, message_op=message_op),
          (x, y, src, dst), grad_idx=(0, 1))


@pytest.mark.parametrize("pool", ["sum", "mean", "max", "min"])
def test_segment_reductions_match_jax(pool):
    rs = np.random.RandomState(4)
    data = rs.standard_normal((50, 3, 2)).astype(np.float32)
    ids = np.sort(rs.randint(0, 12, 50)).astype(np.int64)
    ids[ids == 5] = 6                             # segment 5 stays empty
    name = f"segment_{pool}"
    _both(getattr(JG, name), getattr(PG, name), (data, ids), grad_idx=(0,))
    # num_segments past max(ids) + 1, and incubate's names for the same
    _both(lambda d, s: getattr(jpaddle.incubate, name)(d, s, 15),
          lambda d, s: getattr(paddle.incubate, name)(d, s, 15),
          (data, ids))
    assert getattr(paddle.incubate.tensor.math, name) is getattr(PG, name)


def test_integer_features_and_dropped_ids_match_jax():
    rs = np.random.RandomState(5)
    x = rs.randint(-50, 50, (30, 4)).astype(np.int32)
    src = rs.randint(0, 30, 100).astype(np.int64)
    dst = rs.randint(-3, 33, 100).astype(np.int64)   # some out of [0, 30)
    for op, size in (("sum", None), ("max", 20)):
        _both(lambda *t: JG.send_u_recv(*t, reduce_op=op, out_size=size),
              lambda *t: PG.send_u_recv(*t, reduce_op=op, out_size=size),
              (x, src, dst))


def test_mean_of_bf16_counts_in_f32():
    """More than 256 rows into one segment: a bf16 count would round, the
    f32 one does not (the JAX package's reason for it)."""
    n = 300
    data = torch.ones(n, 2, dtype=torch.bfloat16)
    out = PG.segment_mean(data, torch.zeros(n, dtype=torch.int64))
    assert out.dtype == torch.bfloat16 and torch.equal(
        out, torch.ones(1, 2, dtype=torch.bfloat16))


def test_bare_torch_in_gives_torch_out():
    x, _, src, dst = _graph(6)
    out = PG.send_u_recv(torch.from_numpy(x), torch.from_numpy(src),
                         torch.from_numpy(dst), reduce_op="mean")
    assert type(out) is torch.Tensor and out.shape == x.shape
    nb, cnt = PG.sample_neighbors(torch.tensor([1, 2, 0]),
                                  torch.tensor([0, 1, 2, 3]),
                                  torch.tensor([0, 2]))
    assert type(nb) is torch.Tensor and nb.tolist() == [1, 0]


def test_a_sage_layer_trains_like_jax():
    """Two mean-aggregation layers (``concat(h, agg) @ W``, relu) and an
    MSE loss: three SGD steps from the same weights give the same losses
    and weights."""
    x, _, src, dst = _graph(7, f=8)
    rs = np.random.RandomState(8)
    w1 = (rs.standard_normal((16, 8)) * 0.3).astype(np.float32)
    w2 = (rs.standard_normal((16, 4)) * 0.3).astype(np.float32)
    target = rs.standard_normal((40, 4)).astype(np.float32)
    losses = []
    for i, (pkg, G) in enumerate(((jpaddle, JG), (paddle, PG))):
        wn = [w1, w2]
        xs, s, d, tg = (_pair(a)[i] for a in (x, src, dst, target))
        got = []
        for _ in range(3):
            ws = [_pair(w, True)[i] for w in wn]
            h = xs
            for k, w in enumerate(ws):
                agg = G.send_u_recv(h, s, d, reduce_op="mean")
                h = pkg.matmul(pkg.concat([h, agg], axis=-1), w)
                if k == 0:
                    h = pkg.nn.functional.relu(h)
            loss = ((h - tg) ** 2).mean()
            loss.backward()
            wn = [w.numpy() - 0.1 * w.grad.numpy() for w in ws]
            got.append(float(loss.numpy()))
        losses.append((got, wn))
    np.testing.assert_allclose(losses[1][0], losses[0][0], rtol=1e-6)
    for a, b in zip(losses[1][1], losses[0][1]):
        _close(a, b)


# -- sampling and reindexing (host numpy, line for line) ----------------------

def _csc(seed, n=60, e=400):
    rs = np.random.RandomState(seed)
    dst = np.sort(rs.randint(0, n, e))
    row = rs.randint(0, n, e).astype(np.int64)
    colptr = np.concatenate([[0], np.cumsum(np.bincount(dst, minlength=n))]
                            ).astype(np.int64)
    return row, colptr


@pytest.fixture
def fresh_rngs():
    """Both packages' module generators unseeded, the framework seeds
    equal: their first draws are the same."""
    jsampling._rng = psampling._rng = None
    jpaddle.seed(11)
    paddle.seed(11)
    yield
    jsampling._rng = psampling._rng = None


def test_sample_neighbors_draws_what_jax_draws(fresh_rngs):
    row, colptr = _csc(9)
    nodes = np.arange(0, 60, 3).astype(np.int64)
    eids = np.arange(len(row), dtype=np.int64) * 7
    for size in (-1, 2, 5, 2):       # the module generator advances
        j = JG.sample_neighbors(*(_pair(a)[0] for a in (row, colptr, nodes)),
                                sample_size=size, eids=_pair(eids)[0],
                                return_eids=True)
        p = PG.sample_neighbors(*(_pair(a)[1] for a in (row, colptr, nodes)),
                                sample_size=size, eids=_pair(eids)[1],
                                return_eids=True)
        for a, b in zip(p, j):
            _close(a, b, f"sample_size={size}")
    buf = np.array([1234], np.int64)
    j = JG.sample_neighbors(row, colptr, nodes, sample_size=3,
                            perm_buffer=buf)
    p = PG.sample_neighbors(row, colptr, nodes, sample_size=3,
                            perm_buffer=buf)
    for a, b in zip(p, j):
        _close(a, b, "perm_buffer")
    with pytest.raises(ValueError):
        PG.sample_neighbors(row, colptr, nodes, return_eids=True)


def test_reindex_graph_matches_jax():
    rs = np.random.RandomState(10)
    x = rs.choice(100, 12, replace=False).astype(np.int64)
    count = rs.randint(0, 6, 12).astype(np.int32)
    nb = rs.randint(0, 100, int(count.sum())).astype(np.int64)
    nb2 = rs.randint(0, 100, 7).astype(np.int64)
    cnt2 = np.array([3, 0, 4] + [0] * 9, np.int32)
    for a, b in zip(PG.reindex_graph(*(_pair(v)[1] for v in (x, nb, count))),
                    JG.reindex_graph(*(_pair(v)[0] for v in (x, nb, count)))):
        _close(a, b, "reindex_graph")
    for a, b in zip(PG.reindex_heter_graph(_pair(x)[1], [nb, nb2],
                                           [count, cnt2]),
                    JG.reindex_heter_graph(_pair(x)[0], [nb, nb2],
                                           [count, cnt2])):
        _close(a, b, "reindex_heter_graph")


def test_incubate_graph_ops_match_jax(fresh_rngs):
    row, colptr = _csc(12)
    nodes = np.array([0, 5, 17, 33], np.int64)
    eids = np.arange(len(row), dtype=np.int64)
    j = jops.graph_khop_sampler(*(_pair(a)[0] for a in (row, colptr, nodes)),
                                [3, 2], sorted_eids=_pair(eids)[0],
                                return_eids=True)
    p = pops.graph_khop_sampler(*(_pair(a)[1] for a in (row, colptr, nodes)),
                                [3, 2], sorted_eids=_pair(eids)[1],
                                return_eids=True)
    assert len(p) == len(j) == 5
    for a, b in zip(p, j):
        _close(a, b, "graph_khop_sampler")
    assert _np(p[3]).tolist() == [0, 1, 2, 3]
    for a, b in zip(pops.graph_sample_neighbors(row, colptr, nodes,
                                                sample_size=2),
                    jops.graph_sample_neighbors(row, colptr, nodes,
                                                sample_size=2)):
        _close(a, b, "graph_sample_neighbors")
    nb, cnt = JG.sample_neighbors(row, colptr, nodes)
    for a, b in zip(pops.graph_reindex(nodes, _np(nb), _np(cnt)),
                    jops.graph_reindex(nodes, nb, cnt)):
        _close(a, b, "graph_reindex")
    x, _, src, dst = _graph(13)
    _both(lambda *t: jops.graph_send_recv(*t, pool_type="max"),
          lambda *t: pops.graph_send_recv(*t, pool_type="max"),
          (x, src, dst))
