"""``paddle.sparse.nn.functional`` (the JAX package's table)."""
from ..attention import fused_attention as attention  # noqa: F401
from ..binary import softmax  # noqa: F401
from ..conv import conv3d, max_pool3d, subm_conv3d  # noqa: F401
from ..unary import relu  # noqa: F401

__all__ = ["relu", "conv3d", "subm_conv3d", "max_pool3d", "attention",
           "softmax"]
