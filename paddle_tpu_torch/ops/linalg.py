"""Linear algebra ops (``paddle_tpu.ops.linalg`` counterpart; reference
python/paddle/tensor/linalg.py), over ``torch`` / ``torch.linalg``."""
from __future__ import annotations

import torch

from ..core.dtype import as_inexact, half_in_single, operands
from ..core.op import apply_op, defop

__all__ = ["matmul", "dot", "bmm", "mv", "norm", "dist", "cross", "cholesky",
           "cholesky_solve", "triangular_solve", "inverse", "solve", "lstsq",
           "pinv", "matrix_power", "matrix_rank", "svd", "qr", "eig", "eigh",
           "eigvals", "eigvalsh", "slogdet", "det", "multi_dot", "histogram",
           "bincount", "einsum", "corrcoef", "cov", "cond"]

_INF = float("inf")


@defop(tensor_method=["matmul", "mm"])
def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    x, y = operands(x, y)
    if transpose_x and x.ndim > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.ndim > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


@defop(tensor_method="dot")
def dot(x, y, name=None):
    x, y = operands(x, y)
    return torch.sum(x * y, dim=-1)


@defop(tensor_method="bmm")
def bmm(x, y, name=None):
    return torch.matmul(*operands(x, y))


@defop(tensor_method="mv")
def mv(x, vec, name=None):
    return torch.matmul(*operands(x, vec))


def _pnorm(x, p, dim, keepdim):
    return torch.sum(torch.abs(x) ** p, dim=dim, keepdim=keepdim) ** (1.0 / p)


@defop(tensor_method="norm")
def norm(x, p="fro", axis=None, keepdim=False, name=None):
    x = as_inexact(x)
    if axis is None:
        x, axis = x.reshape(-1), 0
        if p == "fro" or p == 2:
            return torch.linalg.vector_norm(x, keepdim=keepdim)
    if isinstance(axis, (list, tuple)):
        return torch.linalg.norm(x, ord=p, dim=tuple(int(a) for a in axis),
                                 keepdim=keepdim)
    if p == "fro":
        p = 2
    if p in (_INF, -_INF):
        return torch.linalg.vector_norm(x, ord=p, dim=int(axis),
                                        keepdim=keepdim)
    return _pnorm(x, p, int(axis), keepdim)


@defop(tensor_method="dist")
def dist(x, y, p=2, name=None):
    x, y = operands(x, y)
    d = x - y
    if p == 0:
        return torch.sum((d != 0).to(d.dtype)) ** 1.0
    if p == _INF:
        return torch.amax(torch.abs(d))
    if p == -_INF:
        return torch.amin(torch.abs(d))
    return torch.sum(torch.abs(d) ** p) ** (1.0 / p)


@defop(tensor_method="cross")
def cross(x, y, axis=9, name=None):
    if axis == 9:  # paddle default: first axis of size 3
        axis = next(i for i, s in enumerate(x.shape) if s == 3)
    return torch.linalg.cross(*operands(x, y), dim=int(axis))


@defop(tensor_method="cholesky")
def cholesky(x, upper=False, name=None):
    return torch.linalg.cholesky(x, upper=upper)


@defop
@half_in_single
def cholesky_solve(x, y, upper=False, name=None):
    # only y's triangle is read, so only it gets a gradient (as in jax)
    return torch.cholesky_solve(x, y.triu() if upper else y.tril(),
                                upper=upper)


@defop
@half_in_single
def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    if transpose:
        x, upper = x.transpose(-1, -2), not upper
    return torch.linalg.solve_triangular(x, y, upper=upper,
                                         unitriangular=unitriangular)


@defop(tensor_method="inverse")
def inverse(x, name=None):
    return torch.linalg.inv(x)


@defop
def solve(x, y, name=None):
    return torch.linalg.solve(x, y)


@defop
def lstsq(x, y, rcond=None, driver=None, name=None):
    """jnp.linalg.lstsq's SVD solution (any rank, either device; torch's
    CUDA driver assumes full rank): (solution, full residuals, rank,
    singular values)."""
    b = y[:, None] if y.ndim == 1 else y
    m, n = x.shape
    rc = torch.finfo(x.dtype).eps * max(n, m) if rcond is None else rcond
    u, s, vt = torch.linalg.svd(x, full_matrices=False)
    mask = (s > 0) & (s >= rc * s[0])
    s_inv = torch.where(mask, 1 / torch.where(mask, s, 1), 0)[:, None]
    sol = vt.mH @ (s_inv * (u.mH @ b))
    resid = torch.linalg.vector_norm(b - x @ sol, dim=0) ** 2
    return (sol.reshape(-1) if y.ndim == 1 else sol), resid, mask.sum(), s


@defop
def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return torch.linalg.pinv(x, rtol=rcond, hermitian=hermitian)


@defop(tensor_method="matrix_power")
def matrix_power(x, n, name=None):
    return torch.linalg.matrix_power(x, int(n))


@defop
def matrix_rank(x, tol=None, hermitian=False, name=None):
    return torch.linalg.matrix_rank(x, rtol=tol, hermitian=hermitian)


@defop
def svd(x, full_matrices=False, name=None):
    return tuple(torch.linalg.svd(x, full_matrices=full_matrices))


@defop
def qr(x, mode="reduced", name=None):
    return tuple(torch.linalg.qr(x, mode=mode))


@defop
def eig(x, name=None):
    return tuple(torch.linalg.eig(x))


@defop
def eigh(x, UPLO="L", name=None):
    return tuple(torch.linalg.eigh(x, UPLO=UPLO))


@defop
def eigvals(x, name=None):
    return torch.linalg.eigvals(x)


@defop
def eigvalsh(x, UPLO="L", name=None):
    return torch.linalg.eigvalsh(x, UPLO=UPLO)


@defop
def slogdet(x, name=None):
    sign, logdet = torch.linalg.slogdet(x)
    return torch.stack([sign, logdet])


@defop
@half_in_single
def det(x, name=None):
    return torch.linalg.det(x)


def multi_dot(x, name=None):
    return apply_op(lambda *xs: torch.linalg.multi_dot(list(xs)), "multi_dot",
                    tuple(x), {})


@defop
def histogram(x, bins=100, min=0, max=0, name=None):  # noqa: A002
    x = as_inexact(x)
    lo, hi = (x.min(), x.max()) if min == 0 and max == 0 else (min, max)
    return torch.histc(x, bins=int(bins), min=float(lo), max=float(hi))


@defop(tensor_method="bincount")
def bincount(x, weights=None, minlength=0, name=None):
    out = torch.bincount(x, weights=weights, minlength=int(minlength))
    # jnp.bincount's length is exactly minlength when one is given
    return out[:int(minlength)] if minlength else out


def einsum(equation, *operands_, name=None):
    if len(operands_) == 1 and isinstance(operands_[0], (list, tuple)):
        operands_ = tuple(operands_[0])
    return apply_op(lambda *xs: torch.einsum(equation, *operands(*xs)),
                    "einsum", operands_, {})


@defop(tensor_method="corrcoef")
def corrcoef(x, rowvar=True, name=None):
    return torch.corrcoef(x if rowvar else x.transpose(-1, -2))


@defop(tensor_method="cov")
def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    return torch.cov(x if rowvar else x.transpose(-1, -2),
                     correction=1 if ddof else 0, fweights=fweights,
                     aweights=aweights)


@defop
def cond(x, p=None, name=None):
    """Condition number (linalg.cond; phi cond via SVD/norms).  p in
    {None/2, 'fro', 'nuc', 1, -1, 2, -2, inf, -inf} like the reference."""
    if p is None:
        p = 2
    if p in (2, -2):
        s = torch.linalg.svdvals(x)
        return (s[..., 0] / s[..., -1]) if p == 2 else (s[..., -1] / s[..., 0])
    inv = torch.linalg.inv(x)
    if p == "nuc":
        return torch.linalg.svdvals(x).sum(-1) * \
            torch.linalg.svdvals(inv).sum(-1)
    return torch.linalg.matrix_norm(x, p) * torch.linalg.matrix_norm(inv, p)
