"""The nn subset the port's models need."""
from . import functional

__all__ = ["functional"]
