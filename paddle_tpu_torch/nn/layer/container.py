"""Containers (``paddle_tpu.nn.layer.container`` counterparts):
``Sequential`` is torch's ``nn.Sequential``, which names its children
``"0"``, ``"1"``, ... as paddle does (or by the keys of an
``OrderedDict``); ``LayerList`` is an ``nn.ModuleList`` under paddle's
constructor, whose children are ``"0"``, ``"1"``, ... too, so the state
dicts of both carry the JAX layer's names."""
from __future__ import annotations

from torch.nn import ModuleList, Sequential

__all__ = ["Sequential", "LayerList"]


class LayerList(ModuleList):
    def __init__(self, sublayers=None):
        super().__init__(sublayers)
