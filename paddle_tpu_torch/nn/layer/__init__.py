"""Layers of the port (``paddle_tpu.nn.layer`` counterparts)."""
from .norm import LayerNorm

__all__ = ["LayerNorm"]
