"""``Sequential`` (``paddle_tpu.nn.layer.container.Sequential``): torch's
``nn.Sequential``, which names its children ``"0"``, ``"1"``, ... as
paddle does (or by the keys of an ``OrderedDict``)."""
from __future__ import annotations

from torch.nn import Sequential

__all__ = ["Sequential"]
