"""Detection ops (``paddle_tpu.vision.ops`` counterparts): ``nms``.

``nms`` is the JAX package's greedy hard NMS: boxes are visited in the
order of a stable descending sort of their scores (``jnp.argsort(-s)``
is stable, so ``torch.argsort(-s, stable=True)``); a box is kept unless
a kept box before it overlaps it by more than ``iou_threshold`` (IoU by
``_iou_matrix``, areas unclipped, the union floored at 1e-9); with
``category_idxs`` only boxes of one category suppress each other
(``categories`` is accepted and not read, as there).  The kept indices
come back in that order, cut to ``top_k``.

The IoU test runs on the boxes' device as one ``[n, n]`` boolean matrix
in visiting order; the greedy pass is sequential, as the JAX
``fori_loop`` is, and runs on the host over that matrix (one copy, then
a numpy loop over the kept boxes only).  The elementwise float32 ops are
the JAX function's in its order, so the same boxes give the same kept
indices.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["nms"]


def _iou_matrix(boxes):
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    lt = torch.maximum(boxes[:, None, :2], boxes[None, :, :2])
    rb = torch.minimum(boxes[:, None, 2:], boxes[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = areas[:, None] + areas[None, :] - inter
    return inter / union.clamp(min=1e-9)


def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None, name=None):
    """Kept indices (int64, on ``boxes``' device) in descending score
    order."""
    n = boxes.shape[0]
    if scores is None:
        scores = torch.ones(n, dtype=boxes.dtype, device=boxes.device)
    order = torch.argsort(-scores, stable=True)
    iou = _iou_matrix(boxes)
    if category_idxs is not None:
        same = category_idxs[:, None] == category_idxs[None, :]
        iou = torch.where(same, iou, torch.zeros_like(iou))
    # over[i, j]: the i-th visited box overlaps the j-th (iou[order[i],
    # order[j]], the JAX loop's row for box i)
    over = (iou[order][:, order] > iou_threshold).cpu().numpy()
    removed = np.zeros(n, bool)
    keep = []
    for i in range(n):
        if removed[i]:
            continue
        keep.append(i)
        removed |= over[:, i]
    kept = order[torch.as_tensor(keep, dtype=torch.int64,
                                 device=order.device)]
    return kept if top_k is None else kept[:top_k]
