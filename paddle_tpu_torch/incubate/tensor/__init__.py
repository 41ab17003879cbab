from . import math  # noqa: F401
from .math import (segment_max, segment_mean, segment_min,  # noqa: F401
                   segment_sum)

__all__ = ["segment_sum", "segment_mean", "segment_max", "segment_min"]
