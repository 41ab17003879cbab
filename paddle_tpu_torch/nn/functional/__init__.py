"""Functionals of the port (``paddle_tpu.nn.functional`` counterparts)."""
from .attention import (fused_ln_linear, fused_qkv_attention,
                        scaled_dot_product_attention)
from .loss import cross_entropy, fused_nll_loss
from .norm import layer_norm

__all__ = ["scaled_dot_product_attention", "fused_qkv_attention",
           "fused_ln_linear", "layer_norm", "fused_nll_loss",
           "cross_entropy"]
