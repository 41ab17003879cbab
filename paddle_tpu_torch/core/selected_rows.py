"""SelectedRows — row-wise sparse gradients for embedding tables
(``paddle_tpu.core.selected_rows`` counterpart).

``Embedding(sparse=True)`` gives its weight a gradient that holds only
the rows a batch read, so the optimizer touches only those rows (the lazy
row update of ``optimizer.Optimizer``).  In the port the gradient is a
torch sparse COO tensor with one sparse dimension (the rows) and the
embedding width dense: the leaf's ``.grad`` as torch's autograd
accumulates it.  ``SelectedRows`` is a thin view of it with the JAX
class's surface: ``rows`` (``indices[0]``; duplicates allowed until
merged), ``values`` ``[K, D]``, ``height``, ``merged()`` (sorted unique
rows, duplicates summed: :func:`merge_rows`), ``concat``, ``to_dense``
and ``astype``.

Accumulation is torch's, and follows ``paddle_tpu/core/autograd.py``: a
sparse gradient onto a sparse one concatenates, onto a dense one (or a
dense one onto it) makes it dense.

Scope, as in the JAX package: the eager tape carries the sparse gradient;
the train step (``distributed.make_train_step``) runs its forward under
:func:`dense_gradients`, so the tables there get dense gradients and the
step's launches do not depend on ``sparse=``.
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["SelectedRows", "merge_rows", "sparse_embedding_lookup",
           "dense_gradients", "sparse_gradients_enabled"]

_state = threading.local()


@contextlib.contextmanager
def dense_gradients():
    """Inside, ``Embedding(sparse=True)`` gives dense gradients (the
    compiled step's rule)."""
    prev = getattr(_state, "dense", False)
    _state.dense = True
    try:
        yield
    finally:
        _state.dense = prev


def sparse_gradients_enabled() -> bool:
    """Whether a sparse lookup gives a sparse gradient here: grad mode on
    and no :func:`dense_gradients` scope."""
    return torch.is_grad_enabled() and not getattr(_state, "dense", False)


def _coo(rows, values, height) -> torch.Tensor:
    return torch.sparse_coo_tensor(
        rows.reshape(1, -1), values, (int(height),) + tuple(values.shape[1:]),
        check_invariants=False)


def merge_rows(coo: torch.Tensor):
    """``(rows, values)`` of a sparse row gradient with unique rows in
    ascending order and the duplicates summed (phi ``MergeAdd``): one
    ``torch.unique`` (one host read, where torch's ``coalesce`` makes
    five) and an ``index_add``, whose atomics make the sums not
    repeatable bit for bit on the card."""
    rows, inv = torch.unique(coo._indices()[0], sorted=True,
                             return_inverse=True)
    vals = coo._values()
    out = torch.zeros((rows.shape[0],) + tuple(vals.shape[1:]),
                      dtype=vals.dtype, device=vals.device)
    return rows, out.index_add_(0, inv, vals)


class SelectedRows:
    """rows ``[K]`` int64, values ``[K, D]``, ``height`` rows in all; over
    a torch sparse COO tensor (``torch_value``)."""

    __slots__ = ("_coo",)

    def __init__(self, rows, values, height: int):
        self._coo = _coo(torch.as_tensor(rows, dtype=torch.int64,
                                         device=values.device),
                         values, height)

    @classmethod
    def of(cls, coo: torch.Tensor) -> "SelectedRows":
        """A view of a sparse COO tensor with one sparse dimension."""
        sr = object.__new__(cls)
        sr._coo = coo
        return sr

    @property
    def torch_value(self) -> torch.Tensor:
        return self._coo

    @property
    def rows(self) -> torch.Tensor:
        return self._coo._indices()[0]

    @property
    def values(self) -> torch.Tensor:
        return self._coo._values()

    @property
    def height(self) -> int:
        return int(self._coo.shape[0])

    @property
    def shape(self):
        return tuple(self._coo.shape)

    @property
    def dtype(self):
        return self._coo.dtype

    def concat(self, other: "SelectedRows") -> "SelectedRows":
        """Gradient accumulation (phi ``MergeAdd`` deferred)."""
        if other.height != self.height:
            raise ValueError("SelectedRows height mismatch")
        return SelectedRows(torch.cat([self.rows, other.rows]),
                            torch.cat([self.values, other.values]),
                            self.height)

    def merged(self) -> "SelectedRows":
        """Unique rows in ascending order with summed values
        (:func:`merge_rows`)."""
        rows, values = merge_rows(self._coo)
        return SelectedRows(rows, values, self.height)

    def to_dense(self) -> torch.Tensor:
        return self._coo.to_dense()

    def astype(self, dtype) -> "SelectedRows":
        return SelectedRows(self.rows, self.values.to(dtype), self.height)

    def __repr__(self):
        return (f"SelectedRows(height={self.height}, "
                f"nnz_rows={self.rows.shape[0]}, "
                f"dim={tuple(self.values.shape[1:])})")


class _SparseLookup(torch.autograd.Function):
    """The lookup with a sparse weight gradient: ids clipped to ``[0,
    V-1]`` in the forward and in the gradient's rows (never a wrapped
    negative id), ``padding_idx`` rows zero in the output and kept with
    zero values in the gradient (phi ``embedding_sparse_grad_kernel``)."""

    @staticmethod
    def forward(ctx, weight, ids, padding_idx):
        rows = ids.clamp(0, weight.shape[0] - 1)
        out = weight[rows]
        if padding_idx is not None:
            out = out.masked_fill((ids == padding_idx).unsqueeze(-1), 0.0)
        ctx.save_for_backward(ids)
        ctx.height, ctx.padding_idx = weight.shape[0], padding_idx
        return out

    @staticmethod
    def backward(ctx, ct):
        if torch.is_grad_enabled():
            raise NotImplementedError(
                "create_graph=True through op 'sparse_embedding_lookup' is "
                "not supported: its backward is not a pure traced closure "
                "(sparse/SelectedRows path). Express it with regular tensor "
                "ops to differentiate twice.")
        ids, = ctx.saved_tensors
        ids = ids.reshape(-1)
        vals = ct.reshape(ids.shape[0], -1)
        if ctx.padding_idx is not None:
            vals = vals.masked_fill((ids == ctx.padding_idx).unsqueeze(-1),
                                    0.0)
        return _coo(ids.clamp(0, ctx.height - 1), vals, ctx.height), None, \
            None


def sparse_embedding_lookup(weight, ids, padding_idx=None):
    """``weight[ids]`` whose weight gradient is sparse (a
    :class:`SelectedRows` on ``.grad``); surface Tensors in give a Tensor
    out.  Without grad mode, or for a weight that needs none, it is the
    plain clipped lookup."""
    from .tensor import Tensor

    wrap = isinstance(weight, Tensor) or isinstance(ids, Tensor)
    w = weight._value if isinstance(weight, Tensor) else weight
    idv = (ids._value if isinstance(ids, Tensor) else ids).long()
    out = _SparseLookup.apply(w, idv, padding_idx)
    return Tensor._wrap(out) if wrap else out
