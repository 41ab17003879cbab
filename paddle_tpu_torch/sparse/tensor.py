"""Sparse tensors of the port (``paddle_tpu.sparse``'s
``SparseCooTensor`` / ``SparseCsrTensor``, creation and conversions).

A COO tensor keeps its index structure on the device, ``[nnz, sparse_dim]``
int64 (``indices()`` returns it as ``[sparse_dim, nnz]``), and its values
as a surface ``Tensor`` ``[nnz, *dense_dims]`` (hybrid COO: the trailing
dense dimensions, as a voxel grid's channels); the values ride torch
autograd, so every value computation here backpropagates to the values
and to the dense operands, as the JAX package's taped values do.  A CSR
tensor is 2-D: ``crows`` ``[rows + 1]``, ``cols`` and values.

Coordinates are packed into one int64 key per site, row-major over the
sparse dimensions, so sorted keys are ``np.unique(axis=0)``'s
lexicographic order: ``coalesce`` is ``torch.unique`` over the keys and
an ``index_add`` of the values.  The only host reads are the sizes a
result's shape needs (``coalesce``'s site count, a dense tensor's
nonzeros, a shape inferred from the indices).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import Tensor

__all__ = ["SparseCooTensor", "SparseCsrTensor", "sparse_coo_tensor",
           "sparse_csr_tensor", "to_dense", "to_sparse_coo", "to_sparse_csr",
           "values", "coalesce", "is_same_shape"]

_KEY_LIMIT = 2 ** 63


def _value(x):
    """A torch tensor of ``x`` (a Tensor, a torch tensor, an array or a
    number)."""
    if isinstance(x, Tensor):
        return x._value
    return x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))


def _surface(x, device=None) -> Tensor:
    """``x`` as a surface Tensor (a Tensor as it is)."""
    if isinstance(x, Tensor):
        return x
    v = _value(x)
    return Tensor._wrap(v if device is None else v.to(device))


def pack_keys(idx: torch.Tensor, dims) -> torch.Tensor:
    """One int64 key per row of ``idx`` ``[n, k]``, row-major over
    ``dims``: sorted keys are the rows' lexicographic order."""
    if int(np.prod([int(d) for d in dims], dtype=object)) >= _KEY_LIMIT:
        raise ValueError(f"sparse dims {tuple(dims)} overflow an int64 key")
    key = idx[:, 0]
    for d in range(1, len(dims)):
        key = key * int(dims[d]) + idx[:, d]
    return key


def unpack_keys(key: torch.Tensor, dims) -> torch.Tensor:
    """The inverse of :func:`pack_keys`: ``[n, len(dims)]``."""
    cols = []
    for d in reversed(dims[1:]):
        cols.append(key % int(d))
        key = key // int(d)
    cols.append(key)
    return torch.stack(cols[::-1], 1)


class SparseCooTensor:
    """COO tensor: ``_idx`` ``[nnz, sparse_dim]`` int64 on the device,
    ``_vt`` the values (a surface Tensor), ``_shape`` the full shape."""

    def __init__(self, idx: torch.Tensor, values_t: Tensor, shape):
        self._idx = idx
        self._vt = values_t
        self._shape = tuple(int(s) for s in shape)

    @property
    def shape(self):
        return list(self._shape)

    @property
    def dtype(self):
        return self._vt.dtype

    @property
    def sparse_dim(self) -> int:
        return int(self._idx.shape[1])

    def indices(self) -> Tensor:
        return Tensor._wrap(self._idx.t())          # [sparse_dim, nnz]

    def values(self) -> Tensor:
        return self._vt

    def nnz(self) -> int:
        return int(self._idx.shape[0])

    def _keys(self) -> torch.Tensor:
        return pack_keys(self._idx, self._shape[:self.sparse_dim])

    def to_dense(self) -> Tensor:
        v = self._vt._value
        nsp = self.sparse_dim
        flat = torch.zeros((int(np.prod(self._shape[:nsp])),)
                           + tuple(v.shape[1:]), dtype=v.dtype,
                           device=v.device)
        flat = flat.index_add(0, self._keys(), v)
        return Tensor._wrap(flat.reshape(self._shape))

    def to_sparse_csr(self) -> "SparseCsrTensor":
        return SparseCsrTensor.from_coo(self)

    def coalesce(self) -> "SparseCooTensor":
        """Unique sites in lexicographic order, duplicates summed."""
        dims = self._shape[:self.sparse_dim]
        uniq, inv = torch.unique(self._keys(), sorted=True,
                                 return_inverse=True)
        v = self._vt._value
        out = torch.zeros((uniq.shape[0],) + tuple(v.shape[1:]),
                          dtype=v.dtype, device=v.device).index_add(0, inv, v)
        return SparseCooTensor(unpack_keys(uniq, dims), Tensor._wrap(out),
                               self._shape)

    def __repr__(self):
        return (f"SparseCooTensor(shape={self.shape}, nnz={self.nnz()}, "
                f"dtype={self.dtype})")


class SparseCsrTensor:
    """2-D CSR: ``crows`` ``[rows + 1]``, ``cols`` ``[nnz]`` (int64 on the
    values' device) and the values (a surface Tensor)."""

    def __init__(self, crows, cols, values, shape):
        self._vt = _surface(values)
        dev = self._vt._value.device
        self._crows = _value(crows).to(dev, torch.int64)
        self._cols = _value(cols).to(dev, torch.int64)
        self._shape = tuple(int(s) for s in shape)

    @classmethod
    def from_coo(cls, coo: SparseCooTensor) -> "SparseCsrTensor":
        if len(coo.shape) != 2:
            raise ValueError(
                f"CSR conversion supports 2-D tensors, got shape "
                f"{coo.shape}; keep batched sparse data in COO")
        coo = coo.coalesce()
        rows, cols = coo._idx[:, 0].contiguous(), coo._idx[:, 1]
        # crows[i] = the stored entries in rows before i (rows are sorted)
        crows = torch.searchsorted(rows, torch.arange(
            coo.shape[0] + 1, device=rows.device))
        return cls(crows, cols, coo.values(), coo.shape)

    @property
    def shape(self):
        return list(self._shape)

    @property
    def dtype(self):
        return self._vt.dtype

    def crows(self) -> Tensor:
        return Tensor._wrap(self._crows)

    def cols(self) -> Tensor:
        return Tensor._wrap(self._cols)

    def values(self) -> Tensor:
        return self._vt

    def nnz(self) -> int:
        return int(self._cols.shape[0])

    def _rows(self) -> torch.Tensor:
        """The row of each stored entry (no host read)."""
        pos = torch.arange(self.nnz(), device=self._crows.device)
        return torch.searchsorted(self._crows, pos, right=True) - 1

    def to_sparse_coo(self, sparse_dim=2) -> SparseCooTensor:
        return SparseCooTensor(torch.stack([self._rows(), self._cols], 1),
                               self._vt, self._shape)

    def to_dense(self) -> Tensor:
        return self.to_sparse_coo().to_dense()

    def __repr__(self):
        return (f"SparseCsrTensor(shape={self.shape}, nnz={self.nnz()}, "
                f"dtype={self.dtype})")


def _values_of(values, dtype, place, stop_gradient) -> Tensor:
    vals = values if isinstance(values, Tensor) else Tensor(
        values, place=place)
    if dtype is not None:
        vals = vals.astype(dtype)
    if not stop_gradient:
        vals.stop_gradient = False
    return vals


def sparse_coo_tensor(indices, values, shape=None, dtype=None, place=None,
                      stop_gradient=True):
    """A COO tensor from ``indices`` ``[sparse_dim, nnz]`` and ``values``
    ``[nnz, *dense]``; without ``shape``, each sparse extent is the
    largest index + 1 (one host read for device indices)."""
    vals = _values_of(values, dtype, place, stop_gradient)
    idx = _value(indices)
    if idx.dim() != 2:
        raise ValueError("indices must be [sparse_dim, nnz]")
    idx = idx.to(vals._value.device, torch.int64).t().contiguous()
    if shape is None:
        shape = tuple(int(i) + 1 for i in idx.max(0).values.tolist()) + \
            tuple(vals._value.shape[1:])
    return SparseCooTensor(idx, vals, shape)


def sparse_csr_tensor(crows, cols, values, shape, dtype=None, place=None,
                      stop_gradient=True):
    return SparseCsrTensor(crows, cols,
                           _values_of(values, dtype, place, stop_gradient),
                           shape)


def is_same_shape(x, y) -> bool:
    return list(x.shape) == list(y.shape)


def as_coo(x):
    """A CSR tensor as COO; anything else as it is."""
    return x.to_sparse_coo() if isinstance(x, SparseCsrTensor) else x


def to_dense(x, name=None):
    return x.to_dense()


def to_sparse_coo(x, sparse_dim=None, name=None):
    """Dense -> COO.  ``sparse_dim`` keeps the leading axes sparse and the
    trailing ones dense blocks (a site is stored where any of its block
    is nonzero); the sites come in ``np.argwhere``'s order."""
    if isinstance(x, SparseCsrTensor):
        if sparse_dim not in (None, 2):
            raise NotImplementedError(
                f"CSR -> COO is 2-sparse-dim by construction; got "
                f"sparse_dim={sparse_dim}")
        return x.to_sparse_coo()
    if isinstance(x, SparseCooTensor):
        return x
    xt = _surface(x)
    xv = xt._value
    nd = xv.dim()
    sd = nd if sparse_dim is None else int(sparse_dim)
    if not 1 <= sd <= nd:
        raise ValueError(f"sparse_dim must be in [1, {nd}], got {sd}")
    nonzero = xv != 0
    if sd < nd:
        nonzero = nonzero.flatten(sd).any(-1)
    idx = torch.nonzero(nonzero)
    return SparseCooTensor(idx, Tensor._wrap(xv[tuple(idx.t())]), xv.shape)


def to_sparse_csr(x, name=None):
    if isinstance(x, SparseCooTensor):
        return x.to_sparse_csr()
    if isinstance(x, SparseCsrTensor):
        return x
    return to_sparse_coo(x).to_sparse_csr()


def values(x, name=None):
    return x.values()


def coalesce(x, name=None):
    return as_coo(x).coalesce()
