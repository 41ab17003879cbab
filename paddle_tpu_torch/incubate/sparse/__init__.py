"""``paddle.incubate.sparse``: the port's ``sparse`` under the incubating
namespace, with the reference's submodule layout (``creation``,
``unary``, ``binary``, ``multiary``, ``nn``)."""
from ...sparse import *  # noqa: F401,F403
from ...sparse import (SparseCooTensor, SparseCsrTensor,  # noqa: F401
                       sparse_coo_tensor, sparse_csr_tensor)
from . import binary, creation, multiary, nn, unary  # noqa: F401
