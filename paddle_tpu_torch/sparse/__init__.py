"""``paddle.sparse`` of the port (``paddle_tpu.sparse`` counterpart).

* ``tensor``: ``SparseCooTensor`` (hybrid: sparse dims plus dense
  trailing dims) and ``SparseCsrTensor``, creation, conversions and
  ``coalesce``; the index structure lives on the device, the values are a
  surface Tensor on torch autograd;
* ``unary``: the value-wise ops, ``cast``, ``scale``, ``pow``;
* ``binary``: ``add``, ``subtract``, ``multiply``, ``divide``,
  ``matmul``, ``masked_matmul``, ``mv``, ``addmm``, ``softmax``,
  ``transpose``, ``full_like``;
* ``conv``: ``conv3d``, ``subm_conv3d``, ``max_pool3d`` over a rulebook
  built on the device;
* ``attention``: ``fused_attention``;
* ``nn``: the sparse Layers and ``nn.functional``.
"""
from . import attention, binary, conv, nn, tensor, unary  # noqa: F401
from .attention import fused_attention  # noqa: F401
from .binary import (add, addmm, divide, full_like,  # noqa: F401
                     masked_matmul, matmul, multiply, mv, softmax,
                     subtract, transpose)
from .conv import conv3d, max_pool3d, subm_conv3d  # noqa: F401
from .nn import Conv3D, MaxPool3D, SubmConv3D  # noqa: F401
from .tensor import (SparseCooTensor, SparseCsrTensor, coalesce,  # noqa: F401
                     is_same_shape, sparse_coo_tensor, sparse_csr_tensor,
                     to_dense, to_sparse_coo, to_sparse_csr, values)
from .unary import (abs, acos, acosh, asin, asinh, atan, atanh,  # noqa: F401
                    cast, divide_scalar, expm1, leaky_relu, log1p, pow,
                    relu, relu6, scale, sin, sinh, sqrt, square, tan, tanh)

__all__ = ["sparse_coo_tensor", "sparse_csr_tensor", "SparseCooTensor",
           "SparseCsrTensor", "add", "multiply", "matmul", "masked_matmul",
           "relu", "transpose", "is_same_shape",
           "conv3d", "subm_conv3d", "max_pool3d", "fused_attention",
           "to_dense", "to_sparse_coo", "to_sparse_csr", "values",
           "coalesce", "full_like", "acos", "acosh"]
