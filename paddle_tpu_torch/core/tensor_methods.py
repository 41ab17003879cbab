"""Install the remaining reference Tensor methods
(``paddle_tpu.core.tensor_methods`` counterpart): the long tail whose
functions exist at the package's top level (tensor-first signatures, so
plain attribute binding gives the method form), plus the in-place ``*_``
forms through ``ops.math._make_inplace``."""
from __future__ import annotations

__all__ = ["install_tensor_methods"]

# the JAX package's list; names the port does not have yet are skipped
_BIND = [
    "add_n", "addmm", "as_complex", "as_real", "broadcast_shape",
    "broadcast_tensors", "bucketize", "cholesky_solve", "chunk", "concat",
    "cond", "diff", "eig", "eigvals", "eigvalsh", "expand_as",
    "floor_mod", "gcd", "heaviside", "histogram", "is_complex",
    "is_empty", "is_floating_point", "is_integer", "is_tensor", "lcm",
    "logcumsumexp", "logit", "lstsq", "lu", "lu_unpack", "multi_dot",
    "nanquantile", "qr", "rank", "reshape_", "reverse", "scatter_",
    "scatter_nd", "shard_index", "slice", "solve", "split", "squeeze_",
    "stack", "strided_slice", "take", "tensordot", "triangular_solve",
    "unbind", "unsqueeze_", "unstack", "vsplit", "where",
]

_INPLACE = {  # method name -> out-of-place function
    "erfinv_": "erfinv",
    "flatten_": "flatten",
    "lerp_": "lerp",
    "put_along_axis_": "put_along_axis",
}


def install_tensor_methods():
    import paddle_tpu_torch as paddle
    from ..ops.math import _make_inplace
    from .tensor import Tensor

    for name in _BIND:
        fn = getattr(paddle, name, None)
        if fn is not None and not hasattr(Tensor, name):
            setattr(Tensor, name, fn)
    for mname, base in _INPLACE.items():
        if not hasattr(Tensor, mname):
            _make_inplace(getattr(paddle, base), mname)
