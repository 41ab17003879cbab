"""``paddle_tpu.incubate.passes`` counterpart: the graph-pass namespace.
The port runs eagerly and has no program to rewrite, so
``fuse_resnet_unit()`` records the request, as the JAX package's does;
``incubate.operators.ResNetUnit`` is the fused layer itself."""
from __future__ import annotations

_requested = False


def fuse_resnet_unit():
    """Record the request (read back by ``fuse_resnet_unit_requested``)."""
    global _requested
    _requested = True


def fuse_resnet_unit_requested() -> bool:
    return _requested
