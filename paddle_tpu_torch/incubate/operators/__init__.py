"""``paddle_tpu.incubate.operators`` counterpart: the graph operators
under their older names (over ``geometric``), the softmax-mask fusions in
torch ops, and ``ResNetUnit`` (conv + BN (+ add) + relu)."""
from .graph_ops import (graph_khop_sampler, graph_reindex,  # noqa: F401
                        graph_sample_neighbors, graph_send_recv)
from .resnet_unit import ResNetUnit, resnet_unit  # noqa: F401
from .softmax_mask_fuse import softmax_mask_fuse  # noqa: F401
from .softmax_mask_fuse_upper_triangle import (  # noqa: F401
    softmax_mask_fuse_upper_triangle)

__all__ = ["graph_send_recv", "graph_sample_neighbors", "graph_reindex",
           "graph_khop_sampler", "softmax_mask_fuse",
           "softmax_mask_fuse_upper_triangle", "ResNetUnit", "resnet_unit"]
