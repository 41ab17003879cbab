"""``paddle_tpu.incubate.tensor.math`` counterpart: the segment
reductions, under ``paddle.geometric``'s names."""
from ...geometric import (segment_max, segment_mean,  # noqa: F401
                          segment_min, segment_sum)

__all__ = ["segment_sum", "segment_mean", "segment_max", "segment_min"]
