"""``Embedding(sparse=True)`` and ``SelectedRows`` in the port against the
JAX package, on the CPU (the spec: ``tests/test_autograd.py``'s sparse
embedding cases and ``tests/test_ops_extended.py``'s clipped negative id).

Both packages' tables start from the same numpy weights; the ids and the
upstream gradient are numpy arrays from a seed.  Rows and values are
compared after ``merged()`` (torch may concatenate or coalesce; the raw
``rows`` order is not part of the contract), values at 1e-6.
"""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from _torch_cpu_place import cpu_place  # noqa: F401
from paddle_tpu.core.selected_rows import SelectedRows as JaxRows
from paddle_tpu_torch.core.selected_rows import SelectedRows

V, D = 10, 4


def _table(seed=0):
    return np.random.RandomState(seed).standard_normal((V, D)).astype(
        np.float32)


def _emb(mod, table, sparse=True, padding_idx=None):
    e = mod.nn.Embedding(V, D, sparse=sparse, padding_idx=padding_idx)
    e.set_state_dict({"weight": table})
    return e


def _grad_of(mod, ids, table, padding_idx=None, seed=1):
    e = _emb(mod, table, padding_idx=padding_idx)
    up = np.random.RandomState(seed).standard_normal(
        ids.shape + (D,)).astype(np.float32)
    out = e(mod.to_tensor(ids))
    (out * mod.to_tensor(up)).sum().backward()
    return e, out


def _merged(g):
    m = g.merged()
    return np.asarray(m.rows).tolist(), np.asarray(m.values)


def _same_rows(pg, jg):
    assert isinstance(pg, SelectedRows) and isinstance(jg, JaxRows)
    assert pg.height == jg.height and tuple(pg.shape) == tuple(jg.shape)
    prow, pval = _merged(pg)
    jrow, jval = _merged(jg)
    assert prow == jrow
    np.testing.assert_allclose(pval, jval, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("ids", [
    np.array([[1, 3, 3], [7, 1, 0]]),
    np.array([4, 4, 4, 4]),
    np.array([[[9, 0], [2, 9]], [[5, 5], [0, 1]]]),
], ids=["dups", "one-row", "3d"])
def test_rows_and_values_match_jax_after_merge(ids):
    table = _table()
    pe, pout = _grad_of(paddle_tpu_torch, ids, table)
    je, jout = _grad_of(paddle_tpu, ids, table)
    np.testing.assert_array_equal(pout.numpy(), jout.numpy())
    _same_rows(pe.weight.grad, je.weight.grad)
    assert repr(pe.weight.grad.merged()) == repr(je.weight.grad.merged())
    # the sparse gradient densifies to the dense lookup's gradient
    dense = _emb(paddle_tpu_torch, table, sparse=False)
    up = np.random.RandomState(1).standard_normal(ids.shape + (D,)).astype(
        np.float32)
    (dense(paddle_tpu_torch.to_tensor(ids)) *
     paddle_tpu_torch.to_tensor(up)).sum().backward()
    np.testing.assert_allclose(pe.weight.grad.to_dense().numpy(),
                               dense.weight.grad.numpy(), rtol=1e-6)


def test_padding_idx_rows_stay_with_zero_values():
    table = _table()
    table[2] = 0.0
    ids = np.array([[2, 3, 2], [-8, 5, 3]])        # -8 is index 2 as well
    pe, pout = _grad_of(paddle_tpu_torch, ids, table, padding_idx=-8)
    je, jout = _grad_of(paddle_tpu, ids, table, padding_idx=-8)
    np.testing.assert_array_equal(pout.numpy(), jout.numpy())
    assert not pout.numpy()[0, [0, 2]].any()
    _same_rows(pe.weight.grad, je.weight.grad)
    rows, vals = _merged(pe.weight.grad)
    assert 2 in rows and not vals[rows.index(2)].any()


def test_negative_and_out_of_range_ids_clip_to_the_table():
    table = _table()
    ids = np.array([-1, 2, 11, -7, 9])
    pe, pout = _grad_of(paddle_tpu_torch, ids, table)
    je, jout = _grad_of(paddle_tpu, ids, table)
    np.testing.assert_array_equal(pout.numpy(), jout.numpy())
    np.testing.assert_array_equal(pout.numpy()[[0, 2]], table[[0, 9]])
    _same_rows(pe.weight.grad, je.weight.grad)
    rows, _ = _merged(pe.weight.grad)
    assert rows == [0, 2, 9]
    assert not pe.weight.grad.to_dense().numpy()[[1, 3, 4, 5]].any()


def test_two_backward_calls_concatenate():
    table = _table()
    grads = {}
    for mod in (paddle_tpu, paddle_tpu_torch):
        e = _emb(mod, table)
        for ids in (np.array([1, 3, 3]), np.array([3, 8])):
            (e(mod.to_tensor(ids)) ** 2).sum().backward()
        grads[mod] = e.weight.grad
    pg, jg = grads[paddle_tpu_torch], grads[paddle_tpu]
    # JAX concatenates; torch may coalesce the first before it adds
    assert jg.rows.shape[0] == 5 and isinstance(pg, SelectedRows)
    _same_rows(pg, jg)
    both = pg.concat(pg)
    assert both.rows.shape[0] == 2 * pg.rows.shape[0]
    np.testing.assert_allclose(both.to_dense().numpy(),
                               2 * pg.to_dense().numpy(), rtol=1e-6)
    half = pg.astype(torch.float64)
    assert half.dtype == torch.float64 and half.height == V


def test_sparse_plus_dense_densifies():
    table = _table()
    out = {}
    for mod in (paddle_tpu, paddle_tpu_torch):
        e = _emb(mod, table)
        (e(mod.to_tensor(np.array([0, 4, 4]))) ** 2).sum().backward()
        (e.weight ** 2).sum().backward()
        g = e.weight.grad
        assert not isinstance(g, (JaxRows, SelectedRows))
        out[mod] = g.numpy()
    np.testing.assert_allclose(out[paddle_tpu_torch], out[paddle_tpu],
                               rtol=1e-6)


@pytest.mark.parametrize("clip_norm", [0.5, 100.0])
def test_global_norm_clip_densifies_first(clip_norm):
    table = _table()
    ids = np.array([[1, 3, 3], [7, 1, 0]])
    res = {}
    for mod in (paddle_tpu, paddle_tpu_torch):
        for sparse in (True, False):
            e = _emb(mod, table, sparse=sparse)
            o = mod.optimizer.Momentum(
                0.1, parameters=e.parameters(),
                grad_clip=mod.nn.ClipGradByGlobalNorm(clip_norm))
            for _ in range(2):
                (e(mod.to_tensor(ids)) ** 2).sum().backward()
                o.step()
                o.clear_grad()
            res[mod, sparse] = e.weight.numpy()
    want = res[paddle_tpu, True]
    for key, got in res.items():
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                   err_msg=str(key))


def test_create_graph_through_the_lookup_raises():
    e = _emb(paddle_tpu_torch, _table())
    loss = (e(paddle_tpu_torch.to_tensor(np.array([1, 2]))) ** 2).sum()
    with pytest.raises(NotImplementedError, match="create_graph"):
        paddle_tpu_torch.grad(loss, e.weight, create_graph=True)
    je = _emb(paddle_tpu, _table())
    jloss = (je(paddle_tpu.to_tensor(np.array([1, 2]))) ** 2).sum()
    with pytest.raises(NotImplementedError, match="create_graph"):
        paddle_tpu.grad(jloss, je.weight, create_graph=True)


def test_functional_and_no_grad_lookups():
    import paddle_tpu_torch.nn.functional as F

    table = _table()
    w = paddle_tpu_torch.to_tensor(table, stop_gradient=False)
    ids = paddle_tpu_torch.to_tensor(np.array([3, 3, 12]))
    F.embedding(ids, w, sparse=True).sum().backward()
    assert isinstance(w.grad, SelectedRows)
    assert _merged(w.grad)[0] == [3, 9]
    with paddle_tpu_torch.no_grad():
        e = _emb(paddle_tpu_torch, table)
        out = e(paddle_tpu_torch.to_tensor(np.array([5, 1])))
    np.testing.assert_array_equal(out.numpy(), table[[5, 1]])
    sr = SelectedRows(torch.tensor([4, 1, 4]), torch.ones(3, D), V)
    assert _merged(sr)[0] == [1, 4]
    np.testing.assert_array_equal(sr.merged().values.numpy()[1], 2.0)


class _Net(torch.nn.Module):
    def __init__(self, sparse):
        super().__init__()
        self.emb = paddle_tpu_torch.nn.Embedding(V, D, sparse=sparse)
        self.head = paddle_tpu_torch.nn.Linear(D, 1)

    def forward(self, ids):
        return self.head(self.emb(ids).sum(1))


def test_the_train_step_sees_dense_gradients():
    from paddle_tpu_torch.distributed import make_train_step

    rng = np.random.RandomState(3)
    ids = torch.from_numpy(rng.randint(0, V, (8, 5)))
    y = torch.from_numpy(rng.standard_normal((8, 1)).astype(np.float32))
    out = {}
    for sparse in (True, False):
        paddle_tpu_torch.seed(0)
        net = _Net(sparse)
        opt = paddle_tpu_torch.optimizer.Adam(0.01, parameters=net)
        step = make_train_step(
            net, opt, loss_fn=lambda o, t: ((o - t) ** 2).mean())
        losses = [float(step(ids, y)) for _ in range(3)]
        assert not net.emb.weight.value.grad.is_sparse
        out[sparse] = losses, net.emb.weight.numpy()
    assert out[True][0] == out[False][0]
    np.testing.assert_array_equal(out[True][1], out[False][1])
    # outside the step the same net gives the sparse gradient
    net2 = _Net(True)
    net2(ids).sum().backward()
    assert isinstance(net2.emb.weight.grad, SelectedRows)
