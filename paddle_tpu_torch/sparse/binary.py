"""Binary and matrix sparse ops (``paddle_tpu.sparse``'s ``add``,
``subtract``, ``multiply``, ``divide``, ``matmul``, ``masked_matmul``,
``mv``, ``addmm``, ``softmax``, ``transpose``, ``full_like``).

Each computes on the values with torch ops over the device index
structure (``index_add`` for the sums, ``scatter_reduce`` for the row
maxima), so gradients reach the values and the dense operands.  A dense
result is a surface Tensor; a sparse one keeps the input's sites or, for
``add`` of two sparse tensors, their coalesced union.
"""
from __future__ import annotations

import torch

from ..core import dtype as dtype_mod
from ..core.tensor import Tensor
from .tensor import (SparseCooTensor, SparseCsrTensor, _surface, _value,
                     as_coo)
from .unary import scale

__all__ = ["add", "subtract", "multiply", "divide", "matmul",
           "masked_matmul", "mv", "addmm", "softmax", "transpose",
           "full_like"]

_SPARSE = (SparseCooTensor, SparseCsrTensor)


def add(x, y, name=None):
    """sparse + sparse: the coalesced union of the sites; with a dense
    operand the dense sum."""
    x, y = as_coo(x), as_coo(y)
    if isinstance(x, SparseCooTensor) and isinstance(y, SparseCooTensor):
        both = SparseCooTensor(
            torch.cat([x._idx, y._idx]),
            Tensor._wrap(torch.cat([x._vt._value, y._vt._value])), x._shape)
        return both.coalesce()
    sp = x if isinstance(x, SparseCooTensor) else y
    dense = y if sp is x else x
    return sp.to_dense() + _surface(dense, sp._vt._value.device)


def subtract(x, y, name=None):
    if isinstance(y, _SPARSE):
        return add(x, scale(as_coo(y), -1.0))
    return add(x, -_surface(y, as_coo(x)._vt._value.device))


def multiply(x, y, name=None):
    """Sparse x times y at x's sites (y dense, sparse or a scalar)."""
    x = as_coo(x)
    v = x._vt._value
    if isinstance(y, _SPARSE):
        y = as_coo(y).to_dense()
    d = _value(y).to(v.device)
    gathered = d[tuple(x._idx.t())] if d.dim() else d
    return SparseCooTensor(x._idx, Tensor._wrap(v * gathered), x._shape)


def divide(x, y, name=None):
    if isinstance(y, _SPARSE):
        raise ValueError("sparse/sparse divide is undefined off the "
                         "intersection; densify first")
    return multiply(x, 1.0 / _value(y))


def matmul(x, y, name=None):
    """Sparse ``[M, K]`` (or ``[B, M, K]``) @ dense ``[K]``, ``[K, N]`` or
    ``[B, K, N]`` -> dense."""
    x = as_coo(x)
    if x.sparse_dim != len(x._shape):
        raise NotImplementedError("sparse matmul of a hybrid COO tensor")
    v = x._vt._value
    d = _value(y).to(v.device)
    idx = x._idx
    *batch, m, _ = x._shape
    if batch:
        b, row, col = idx[:, 0], idx[:, 1], idx[:, 2]
        seg = b * m + row
        rhs = d[b, col] if d.dim() == 3 else d[col]
    else:
        seg, col = idx[:, 0], idx[:, 1]
        rhs = d[col]
    contrib = rhs * (v if rhs.dim() == 1 else v.unsqueeze(-1))
    n_seg = m * (batch[0] if batch else 1)
    out = torch.zeros((n_seg,) + tuple(contrib.shape[1:]),
                      dtype=contrib.dtype, device=v.device)
    out = out.index_add(0, seg, contrib)
    return Tensor._wrap(out.reshape(tuple(batch) + (m,)
                                    + tuple(contrib.shape[1:])))


def mv(x, vec, name=None):
    return matmul(x, vec)


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):  # noqa: A002
    """``beta * input + alpha * (x @ y)`` with x sparse."""
    prod = matmul(x, y)
    return beta * _surface(input, prod._value.device) + alpha * prod


def masked_matmul(x, y, mask, name=None):
    """``x @ y`` sampled at ``mask``'s sites (SDDMM) -> COO."""
    mask = as_coo(mask)
    rows, cols = mask._idx[:, 0], mask._idx[:, 1]
    a, b = _value(x), _value(y)
    out = (a[rows] * b.t()[cols]).sum(-1)
    return SparseCooTensor(mask._idx, Tensor._wrap(out), mask._shape)


def transpose(x, perm, name=None):
    """Permute a hybrid COO tensor's sparse dims and its dense dims,
    each among themselves; the sites keep their order."""
    x = as_coo(x)
    nsp, nd = x.sparse_dim, len(x._shape)
    perm = list(perm)
    sp_perm, dense_perm = perm[:nsp], perm[nsp:]
    if sorted(sp_perm) != list(range(nsp)) or \
            sorted(dense_perm) != list(range(nsp, nd)):
        raise NotImplementedError(
            f"hybrid COO transpose must permute sparse dims (first {nsp}) "
            f"and dense dims separately; got perm={perm}")
    vals = x._vt
    if dense_perm != list(range(nsp, nd)):
        vals = Tensor._wrap(vals._value.permute(
            [0] + [p - nsp + 1 for p in dense_perm]))
    return SparseCooTensor(x._idx[:, sp_perm], vals,
                           [x._shape[p] for p in perm])


def softmax(x, axis=-1, name=None):
    """Row softmax over the stored values only (implicit zeros take no
    part): one segment max and one segment sum over the CSR rows."""
    if axis not in (-1, 1):
        raise ValueError("sparse softmax supports the last axis only")
    csr = SparseCsrTensor.from_coo(as_coo(x)) \
        if isinstance(x, SparseCooTensor) else x
    v = csr._vt._value
    rows = csr._rows()
    n = csr._shape[0]
    row_max = torch.zeros(n, dtype=v.dtype, device=v.device).scatter_reduce(
        0, rows, v, "amax", include_self=False)
    e = torch.exp(v - row_max[rows])
    row_sum = torch.zeros(n, dtype=v.dtype, device=v.device).index_add(
        0, rows, e)
    return SparseCsrTensor(csr._crows, csr._cols,
                           Tensor._wrap(e / row_sum[rows]), csr._shape)


def full_like(x, value, dtype=None, name=None):
    """The same sites with every stored value ``value``."""
    v = x._vt._value
    vals = Tensor._wrap(torch.full_like(
        v, value, dtype=dtype_mod.convert_dtype(dtype) if dtype else None))
    if isinstance(x, SparseCsrTensor):
        return SparseCsrTensor(x._crows, x._cols, vals, x._shape)
    return SparseCooTensor(x._idx, vals, x._shape)
