"""YOLOv3 (``paddle_tpu.vision.models.yolo`` counterpart): the compact
detector of the JAX package and its losses.

The layers, their names and the state dict are the JAX model's:
``ConvBNLayer`` (bias-free conv, ``BatchNorm2D``, LeakyReLU(0.1) or
Swish), ``CSPBlock`` (a stride-2 conv, two 1x1 halves, residual pairs on
one, a 1x1 fuse), ``CSPBackbone`` (stem and four stages: C3, C4, C5 at
strides 8, 16, 32), ``FPNNeck`` (top-down with ``UpsamplingNearest2D``,
the JAX values, ROADMAP section 3 item 4) and per scale a ``YOLOHead``
conv emitting ``[N, A * (5 + C), H, W]``.

* ``YOLOv3.decode`` runs ``vision.ops.yolo_box`` a scale; ``predict``
  (eval mode, restored after) copies boxes and scores to the host once,
  keeps each image's boxes whose best class score passes ``conf_thresh``
  and runs ``vision.ops.nms`` with ``category_idxs`` and ``categories=``
  on the model's device: rows (x0, y0, x1, y1, score, class) a numpy
  array an image.  Host syncs: one copy down, then ``nms``'s two an
  image (the candidates go up in one pinned, non-blocking copy).
* ``YOLOv3Loss(model)(heads, gt)`` is the JAX loss: ``gt`` a list of
  ``(boxes_xyxy_pixels [M, 4], class_ids [M])`` an image, as there, or
  padded ``gt_boxes [N, M, 4]`` and ``gt_labels [N, M]`` (rows with a
  negative label are padding), the form ``make_train_step(...,
  num_labels=2)`` passes.  The target assignment (best anchor by wh-IoU
  at the centre cell) is host numpy over the ground truth, as in JAX:
  one device-to-host copy of it a call (none for host inputs), the
  targets back in one pinned, non-blocking upload.  The heads are
  upcast to f32 first, so a bf16 step computes its loss in f32.
* ``yolo_head_loss`` (``vision.ops.yolo_loss``) is one head's loss with
  the ``yolo_loss`` op's contract, ``[N]``: the same assignment from
  normalised (cx, cy, w, h) boxes, and the ``ignore_thresh`` pass over
  the detached, decoded predictions, host numpy as in JAX: one copy of
  the head (``p.numpy()`` in JAX) and one of the ground truth a call,
  the targets back in one pinned, non-blocking upload.

The convolutions run through ``F.conv2d`` (cuDNN on the card), as the
JAX model's run through XLA; no TPU kernel is on this path.  ``YOLOv3``
and ``yolov3`` take ``device=`` (``"cuda"`` unless given; raises without
a card) and start in training mode.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn as tnn

from ... import nn
from ...device import resolve_device
from ...nn import functional as F
from .. import ops as vops
from ._common import no_pretrained

__all__ = ["ConvBNLayer", "CSPBlock", "CSPBackbone", "FPNNeck", "YOLOHead",
           "YOLOv3", "YOLOv3Loss", "yolov3", "yolo_head_loss"]

_DEFAULT_ANCHORS = [[10, 13, 16, 30, 33, 23],
                    [30, 61, 62, 45, 59, 119],
                    [116, 90, 156, 198, 373, 326]]


class ConvBNLayer(tnn.Module):
    def __init__(self, cin, cout, k=3, stride=1, act="leaky_relu"):
        super().__init__()
        self.conv = nn.Conv2D(cin, cout, k, stride=stride,
                              padding=(k - 1) // 2, bias_attr=False)
        self.bn = nn.BatchNorm2D(cout)
        self.act = nn.LeakyReLU(0.1) if act == "leaky_relu" else nn.Swish()

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class CSPBlock(tnn.Module):
    """Cross-stage-partial residual stage."""

    def __init__(self, cin, cout, n_blocks, stride=2):
        super().__init__()
        self.down = ConvBNLayer(cin, cout, 3, stride=stride)
        half = cout // 2
        self.split1 = ConvBNLayer(cout, half, 1)
        self.split2 = ConvBNLayer(cout, half, 1)
        self.blocks = nn.LayerList([
            nn.Sequential(ConvBNLayer(half, half, 1),
                          ConvBNLayer(half, half, 3))
            for _ in range(n_blocks)])
        self.fuse = ConvBNLayer(cout, cout, 1)

    def forward(self, x):
        x = self.down(x)
        a = self.split1(x)
        b = self.split2(x)
        for blk in self.blocks:
            b = b + blk(b)
        return self.fuse(torch.cat([a, b], dim=1))


class CSPBackbone(tnn.Module):
    """Returns C3, C4, C5 feature maps (strides 8/16/32)."""

    def __init__(self, width=32, depths=(1, 2, 2, 1)):
        super().__init__()
        w = width
        self.stem = ConvBNLayer(3, w, 3, stride=2)
        self.stage1 = CSPBlock(w, w * 2, depths[0])       # /4
        self.stage2 = CSPBlock(w * 2, w * 4, depths[1])   # /8  -> C3
        self.stage3 = CSPBlock(w * 4, w * 8, depths[2])   # /16 -> C4
        self.stage4 = CSPBlock(w * 8, w * 16, depths[3])  # /32 -> C5
        self.out_channels = (w * 4, w * 8, w * 16)

    def forward(self, x):
        x = self.stem(x)
        x = self.stage1(x)
        c3 = self.stage2(x)
        c4 = self.stage3(c3)
        c5 = self.stage4(c4)
        return c3, c4, c5


class FPNNeck(tnn.Module):
    """Top-down upsample fusion producing one feature per scale."""

    def __init__(self, in_channels, out_channel=128):
        super().__init__()
        c3, c4, c5 = in_channels
        self.lat5 = ConvBNLayer(c5, out_channel, 1)
        self.lat4 = ConvBNLayer(c4, out_channel, 1)
        self.lat3 = ConvBNLayer(c3, out_channel, 1)
        self.up = nn.UpsamplingNearest2D(scale_factor=2)
        self.out5 = ConvBNLayer(out_channel, out_channel, 3)
        self.out4 = ConvBNLayer(out_channel, out_channel, 3)
        self.out3 = ConvBNLayer(out_channel, out_channel, 3)

    def forward(self, feats):
        c3, c4, c5 = feats
        p5 = self.lat5(c5)
        p4 = self.lat4(c4) + self.up(p5)
        p3 = self.lat3(c3) + self.up(p4)
        return self.out3(p3), self.out4(p4), self.out5(p5)


class YOLOHead(tnn.Module):
    def __init__(self, in_channel, num_anchors, num_classes):
        super().__init__()
        self.pred = nn.Conv2D(in_channel, num_anchors * (5 + num_classes), 1)

    def forward(self, x):
        return self.pred(x)


class YOLOv3(tnn.Module):
    """Detector: the forward returns the raw heads of the three scales;
    ``decode`` gives boxes and scores through ``ops.yolo_box``;
    ``predict`` adds per-image NMS."""

    def __init__(self, num_classes=80, anchors=None, width=32,
                 neck_channel=128, conf_thresh=0.05, nms_thresh=0.45,
                 device=None):
        super().__init__()
        dev = resolve_device(device)
        self.num_classes = num_classes
        self.anchors = anchors or _DEFAULT_ANCHORS
        self.strides = (8, 16, 32)
        self.conf_thresh = conf_thresh
        self.nms_thresh = nms_thresh
        with dev:
            self.backbone = CSPBackbone(width=width)
            self.neck = FPNNeck(self.backbone.out_channels, neck_channel)
            na = len(self.anchors[0]) // 2
            self.heads = nn.LayerList([
                YOLOHead(neck_channel, na, num_classes) for _ in range(3)])
        self.to(dev)

    def forward(self, x):
        feats = self.neck(self.backbone(x))
        return [head(f) for head, f in zip(self.heads, feats)]

    def decode(self, heads, img_size):
        """heads -> (boxes [N, M, 4], scores [N, M, C]) across scales."""
        boxes, scores = [], []
        for head, anchors, stride in zip(heads, self.anchors, self.strides):
            b, s = vops.yolo_box(head, img_size, anchors, self.num_classes,
                                 self.conf_thresh, stride)
            boxes.append(b)
            scores.append(s)
        return torch.cat(boxes, dim=1), torch.cat(scores, dim=1)

    def predict(self, x, img_size, top_k=100):
        """Per-image float32 arrays of (x0, y0, x1, y1, score, class)
        rows."""
        was_training = self.training
        self.eval()
        try:
            with torch.no_grad():
                heads = self.forward(x)
                boxes, scores = self.decode(heads, img_size)
            boxes_np, scores_np = vops._host_pair(boxes, scores)
        finally:
            if was_training:
                self.train()
        dev = boxes.device
        results = []
        for i in range(boxes_np.shape[0]):
            b_np = boxes_np[i]
            cls_score = scores_np[i].max(axis=-1)
            cls_id = scores_np[i].argmax(axis=-1)
            idxs = np.nonzero(cls_score > self.conf_thresh)[0]
            if idxs.size == 0:
                results.append(np.zeros((0, 6), "float32"))
                continue
            b_t, s_t, c_t = _upload(dev, b_np[idxs], cls_score[idxs],
                                    cls_id[idxs])
            kept = vops.nms(
                b_t, self.nms_thresh, scores=s_t, category_idxs=c_t.long(),
                categories=list(range(self.num_classes)),
                top_k=top_k).cpu().numpy()
            rows = np.concatenate([
                b_np[idxs][kept],
                cls_score[idxs][kept, None].astype("float32"),
                cls_id[idxs][kept, None].astype("float32")], axis=1)
            results.append(rows.astype("float32"))
        return results


def _upload(dev, *arrays):
    """Host arrays on ``dev`` as f32 tensors of their shapes, through one
    pinned, non-blocking copy (an upload from pageable memory would wait
    for the device first); integer targets (class ids) are exact in f32."""
    flat = torch.from_numpy(np.concatenate(
        [np.asarray(a, np.float32).reshape(-1) for a in arrays]))
    if dev.type == "cuda":
        flat = flat.pin_memory()
    flat = flat.to(dev, non_blocking=True)
    out, i = [], 0
    for a in arrays:
        out.append(flat[i:i + a.size].reshape(a.shape))
        i += a.size
    return out


def _gt_on_host(gt_boxes, gt_labels):
    """Padded ground truth as the JAX list of (boxes, classes) an image:
    one device-to-host copy; rows with a negative label are padding."""
    boxes, labels = vops._host_pair(gt_boxes, gt_labels)
    labels = labels.astype(np.int64)
    return [(b[lab >= 0], lab[lab >= 0]) for b, lab in zip(boxes, labels)]


class YOLOv3Loss(tnn.Module):
    """Classic YOLOv3 loss over the raw heads with grid-assigned targets
    (objectness BCE, cell-offset BCE, log-wh L2 and class BCE on the
    assigned anchors); see the module docstring for the targets' forms."""

    def __init__(self, model: YOLOv3):
        super().__init__()
        self.model = model

    def build_targets(self, heads, gt_list):
        model = self.model
        na = len(model.anchors[0]) // 2
        targets = []
        for head, anchors, stride in zip(heads, model.anchors, model.strides):
            n, _, h, w = head.shape
            anc = np.asarray(anchors, "float32").reshape(-1, 2)
            tobj = np.zeros((n, na, h, w), "float32")
            tbox = np.zeros((n, na, h, w, 4), "float32")
            tcls = np.zeros((n, na, h, w), "int64")
            for i, (boxes, classes) in enumerate(gt_list):
                for bx, cl in zip(np.asarray(boxes, "float32"),
                                  np.asarray(classes)):
                    cx = (bx[0] + bx[2]) / 2
                    cy = (bx[1] + bx[3]) / 2
                    bw = max(bx[2] - bx[0], 1e-3)
                    bh = max(bx[3] - bx[1], 1e-3)
                    gx, gy = int(cx / stride), int(cy / stride)
                    if not (0 <= gx < w and 0 <= gy < h):
                        continue
                    inter = np.minimum(anc[:, 0], bw) * \
                        np.minimum(anc[:, 1], bh)
                    union = anc[:, 0] * anc[:, 1] + bw * bh - inter
                    a = int((inter / union).argmax())
                    tobj[i, a, gy, gx] = 1.0
                    tbox[i, a, gy, gx] = [cx / stride - gx, cy / stride - gy,
                                          np.log(bw / anc[a, 0]),
                                          np.log(bh / anc[a, 1])]
                    tcls[i, a, gy, gx] = int(cl)
            targets.append((tobj, tbox, tcls))
        return targets

    def forward(self, heads, gt, gt_labels=None):
        gt_list = gt if gt_labels is None else _gt_on_host(gt, gt_labels)
        heads = [hd.float() for hd in heads]
        targets = self.build_targets(heads, gt_list)
        total = None
        nc = self.model.num_classes
        na = len(self.model.anchors[0]) // 2
        up = _upload(heads[0].device, *[a for t in targets for a in t])
        for k, head in enumerate(heads):
            n, _, h, w = head.shape
            p = head.reshape(n, na, 5 + nc, h, w)
            pxy = p[:, :, 0:2]
            pwh = p[:, :, 2:4]
            pobj = p[:, :, 4]
            pcls = p[:, :, 5:]
            obj_t, box_t, cls_t = up[3 * k:3 * k + 3]
            cls_t = cls_t.long()

            loss_obj = F.binary_cross_entropy_with_logits(
                pobj, obj_t, reduction="mean")
            mask = obj_t.unsqueeze(2)
            # xy: sigmoid-BCE against the cell offsets; wh: L2 in log
            # space; tbox [n, na, h, w, 4] -> [n, na, 4, h, w]
            box_nchw = box_t.permute(0, 1, 4, 2, 3)
            xy_t = box_nchw[:, :, 0:2]
            wh_t = box_nchw[:, :, 2:4]
            den = mask.sum().clamp(min=1.0)
            loss_xy = (F.binary_cross_entropy_with_logits(
                pxy, xy_t, reduction="none") * mask).sum() / den / 2
            loss_wh = (((pwh - wh_t) ** 2) * mask).sum() / den / 2
            cls_oh = F.one_hot(cls_t, nc).permute(0, 1, 4, 2, 3)
            loss_cls = (F.binary_cross_entropy_with_logits(
                pcls, cls_oh.float(), reduction="none") *
                mask).sum() / den / nc
            part = loss_obj + loss_xy + loss_wh + loss_cls
            total = part if total is None else total + part
        return total


def yolov3(num_classes=80, pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return YOLOv3(num_classes=num_classes, **kwargs)


def yolo_head_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
                   ignore_thresh, downsample_ratio, gt_score=None,
                   use_label_smooth=True, scale_x_y=1.0):
    """One head's YOLOv3 loss with the ``yolo_loss`` op's contract: x
    ``[N, A*(5+C), H, W]``, gt_box ``[N, B, 4]`` normalized (cx, cy, w,
    h), anchors a flat pixel list, anchor_mask the indices this head
    owns; ``[N]`` (a ``Tensor`` when x is one)."""
    xv = vops._t(x)
    dev = xv.device
    n, _, h, w = xv.shape
    stride = downsample_ratio
    in_h, in_w = h * stride, w * stride
    anc_all = np.asarray(anchors, "float32").reshape(-1, 2)
    anc = anc_all[np.asarray(anchor_mask, int)]
    na = anc.shape[0]
    gb, gl = vops._host_pair(gt_box, gt_label)
    gb = gb.astype("float32")
    tobj = np.zeros((n, na, h, w), "float32")
    tbox = np.zeros((n, na, h, w, 4), "float32")
    tcls = np.zeros((n, na, h, w), "int64")
    for i in range(n):
        for bx, cl in zip(gb[i], gl[i]):
            cx, cy, bw, bh = bx
            if bw <= 0 or bh <= 0:
                continue
            bw_p, bh_p = bw * in_w, bh * in_h
            gx, gy = int(cx * w), int(cy * h)
            if not (0 <= gx < w and 0 <= gy < h):
                continue
            inter = np.minimum(anc_all[:, 0], bw_p) * \
                np.minimum(anc_all[:, 1], bh_p)
            union = anc_all[:, 0] * anc_all[:, 1] + bw_p * bh_p - inter
            best = int((inter / union).argmax())
            if best not in list(anchor_mask):
                continue
            a = list(anchor_mask).index(best)
            tobj[i, a, gy, gx] = 1.0
            tbox[i, a, gy, gx] = [cx * w - gx, cy * h - gy,
                                  np.log(max(bw_p, 1e-3) / anc[a, 0]),
                                  np.log(max(bh_p, 1e-3) / anc[a, 1])]
            tcls[i, a, gy, gx] = int(cl)
    p = xv.reshape(n, na, 5 + class_num, h, w)
    pxy, pwh = p[:, :, 0:2], p[:, :, 2:4]
    pobj, pcls = p[:, :, 4], p[:, :, 5:]
    # ignore_thresh: decode the detached predictions and leave unassigned
    # anchors whose best IoU with any GT passes the threshold out of the
    # no-object loss (host numpy, as the assignment above)
    pv = vops._host(p).astype("float32")
    sig = 1.0 / (1.0 + np.exp(-pv[:, :, 0:2]))
    gyx = np.stack(np.meshgrid(np.arange(h), np.arange(w),
                               indexing="ij"))          # [2, h, w]
    pcx = (sig[:, :, 0] + gyx[1][None, None]) / w
    pcy = (sig[:, :, 1] + gyx[0][None, None]) / h
    pw_ = np.exp(np.clip(pv[:, :, 2], -10, 10)) \
        * anc[:, 0][None, :, None, None] / in_w
    ph_ = np.exp(np.clip(pv[:, :, 3], -10, 10)) \
        * anc[:, 1][None, :, None, None] / in_h
    ignore = np.zeros((n, na, h, w), "float32")
    for i in range(n):
        valid = [(bx, ) for bx in gb[i] if bx[2] > 0 and bx[3] > 0]
        if not valid:
            continue
        gtb = np.asarray([bx for (bx,) in valid], "float32")  # [M, 4]
        px1 = pcx[i] - pw_[i] / 2
        py1 = pcy[i] - ph_[i] / 2
        px2 = pcx[i] + pw_[i] / 2
        py2 = pcy[i] + ph_[i] / 2
        gx1 = gtb[:, 0] - gtb[:, 2] / 2
        gy1 = gtb[:, 1] - gtb[:, 3] / 2
        gx2 = gtb[:, 0] + gtb[:, 2] / 2
        gy2 = gtb[:, 1] + gtb[:, 3] / 2
        best = np.zeros((na, h, w), "float32")
        for m in range(gtb.shape[0]):
            iw = np.clip(np.minimum(px2, gx2[m])
                         - np.maximum(px1, gx1[m]), 0, None)
            ih = np.clip(np.minimum(py2, gy2[m])
                         - np.maximum(py1, gy1[m]), 0, None)
            inter = iw * ih
            union = pw_[i] * ph_[i] + gtb[m, 2] * gtb[m, 3] - inter
            best = np.maximum(best, inter / np.maximum(union, 1e-10))
        ignore[i] = (best > ignore_thresh).astype("float32")
    # positives always count; negatives only where not ignored
    obj_w = tobj + (1.0 - tobj) * (1.0 - ignore)
    if gt_score is not None:
        # per-box confidence weights scale the positive cells
        gs = vops._host(gt_score).astype("float32")
        wpos = np.ones_like(tobj)
        for i in range(n):
            for bx, sc_, cl in zip(gb[i], gs[i], gl[i]):
                cx, cy, bw, bh = bx
                if bw <= 0 or bh <= 0:
                    continue
                gx, gy = int(cx * w), int(cy * h)
                if 0 <= gx < w and 0 <= gy < h:
                    wpos[i, :, gy, gx] = np.where(
                        tobj[i, :, gy, gx] > 0, sc_, 1.0)
        obj_w = obj_w * wpos
    obj_t, obj_w, tbox, tcls = _upload(dev, tobj, obj_w, tbox, tcls)
    box_nchw = tbox.permute(0, 1, 4, 2, 3)
    mask = obj_t.unsqueeze(2)
    loss_obj = (F.binary_cross_entropy_with_logits(
        pobj, obj_t, reduction="none") * obj_w).sum(dim=(1, 2, 3))
    loss_xy = (F.binary_cross_entropy_with_logits(
        pxy, box_nchw[:, :, 0:2], reduction="none") * mask
    ).sum(dim=(1, 2, 3, 4))
    loss_wh = (((pwh - box_nchw[:, :, 2:4]) ** 2) * mask
               ).sum(dim=(1, 2, 3, 4))
    smooth = 1.0 / class_num if use_label_smooth else 0.0
    cls_oh = F.one_hot(tcls.long(), class_num).permute(0, 1, 4, 2, 3)
    cls_t = cls_oh * (1.0 - smooth) + smooth * (1.0 / class_num)
    loss_cls = (F.binary_cross_entropy_with_logits(
        pcls, cls_t, reduction="none") * mask).sum(dim=(1, 2, 3, 4))
    return vops._like(x, loss_obj + loss_xy + loss_wh + loss_cls)
