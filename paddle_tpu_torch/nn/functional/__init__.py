"""Functionals of the port (``paddle_tpu.nn.functional`` counterparts)."""
from .activation import relu
from .attention import (fused_ln_linear, fused_qkv_attention,
                        scaled_dot_product_attention)
from .conv import conv2d, pointwise_as_dot
from .loss import cross_entropy, fused_nll_loss
from .norm import batch_norm, layer_norm
from .pooling import adaptive_avg_pool2d, max_pool2d

__all__ = ["scaled_dot_product_attention", "fused_qkv_attention",
           "fused_ln_linear", "layer_norm", "batch_norm", "fused_nll_loss",
           "cross_entropy", "conv2d", "pointwise_as_dot", "max_pool2d",
           "adaptive_avg_pool2d", "relu"]
