"""``paddle_tpu.linalg`` counterpart: the paddle linear-algebra
namespace, bound from the port's ``ops.linalg`` and ``ops.extended``
(``inv`` is ``inverse``; ``lu`` and ``lu_unpack`` come from
``ops.extended``)."""
from .ops.extended import lu, lu_unpack  # noqa: F401
from .ops.linalg import (  # noqa: F401
    bincount,
    bmm,
    cholesky,
    cholesky_solve,
    cond,
    corrcoef,
    cov,
    cross,
    det,
    dist,
    dot,
    eig,
    eigh,
    eigvals,
    eigvalsh,
    histogram,
    inverse,
    lstsq,
    matmul,
    matrix_power,
    matrix_rank,
    multi_dot,
    mv,
    norm,
    pinv,
    qr,
    slogdet,
    solve,
    svd,
    triangular_solve,
)

inv = inverse
