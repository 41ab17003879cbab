"""Functionals of the port (``paddle_tpu.nn.functional`` counterparts)."""
from .activation import (ACTIVATIONS, celu, elu, gelu, hardshrink,
                         hardsigmoid, hardswish, hardtanh, leaky_relu,
                         log_sigmoid, mish, relu, relu6, selu, sigmoid, silu,
                         softplus, softshrink, softsign, swish, tanh,
                         tanhshrink)
from .attention import (fused_ln_linear, fused_qkv_attention,
                        scaled_dot_product_attention)
from .common import interpolate, one_hot, upsample
from .conv import conv2d, pointwise_as_dot
from .loss import (binary_cross_entropy_with_logits, cross_entropy,
                   ctc_loss, fused_linear_nll_loss, fused_nll_loss)
from .norm import batch_norm, layer_norm
from .pooling import adaptive_avg_pool2d, max_pool2d

__all__ = ["scaled_dot_product_attention", "fused_qkv_attention",
           "fused_ln_linear", "layer_norm", "batch_norm", "fused_nll_loss",
           "fused_linear_nll_loss",
           "cross_entropy", "binary_cross_entropy_with_logits", "ctc_loss",
           "one_hot", "interpolate", "upsample", "conv2d",
           "pointwise_as_dot", "max_pool2d", "adaptive_avg_pool2d",
           "ACTIVATIONS", "relu", "relu6", "elu",
           "selu", "celu", "gelu", "sigmoid", "log_sigmoid", "hardsigmoid",
           "hardswish", "hardtanh", "hardshrink", "softshrink", "tanhshrink",
           "leaky_relu", "softplus", "softsign", "silu", "swish", "mish",
           "tanh"]
