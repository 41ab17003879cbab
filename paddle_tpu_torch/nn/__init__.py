"""The nn subset the port's models need."""
from . import functional
from .layer import LayerNorm

__all__ = ["functional", "LayerNorm"]
