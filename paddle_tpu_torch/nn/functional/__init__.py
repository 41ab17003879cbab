"""Functionals of the port (``paddle_tpu.nn.functional`` counterparts)."""
from .attention import scaled_dot_product_attention

__all__ = ["scaled_dot_product_attention"]
