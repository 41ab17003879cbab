"""PP-YOLOE (``paddle_tpu.vision.models.ppyoloe`` counterpart): the
anchor-free detector of BASELINE.md row 6 and its task-aligned loss.

The layers, their names and the state dict are the JAX model's:

* ``ConvBN`` (bias-free conv, ``BatchNorm2D``, Swish), ``RepConvBlock``
  (parallel 3x3 and 1x1 ``ConvBN`` branches; ``fuse()`` folds both batch
  norms, eps 1e-5, into one 3x3 conv with a bias, kept as ``_fused``),
  ``ESEAttn`` (a 1x1 conv on the spatial mean, a sigmoid gate),
  ``CSPRepStage``, ``CSPRepResNet`` (stem and four stages; strides 8, 16,
  32 out), ``CSPPAN`` (top-down with 2x nearest upsampling, then
  bottom-up) and ``PPYOLOEHead`` (per level an ESE-attended stem, class
  logits ``[N, C, H, W]`` with the prior-probability bias
  ``-log(0.99 / 0.01)``, and distribution-focal regression bins ``[N,
  4 (reg_max + 1), H, W]``).
* ``PPYOLOE.decode`` gives boxes ``[N, P, 4]`` (xyxy, image coordinates:
  each point's centre minus / plus the expected l, t, r, b bin times its
  stride) and sigmoid scores ``[N, P, C]``, in f32.
* ``PPYOLOE.predict`` keeps what the JAX method evidently intends (its
  call passes ``score_threshold=`` to ``nms``, which takes no such
  argument and raises there): per image, each point's best class score,
  the points scoring above ``score_threshold``, then
  ``vision.ops.nms(iou_threshold=nms_threshold, top_k=max_dets)``.
* ``PPYOLOELoss`` is the JAX loss: task-aligned assignment (metric
  ``cls^alpha * iou^beta`` on the detached predictions, points inside a
  valid gt box, the top ``topk`` per gt, each point to its best gt), a
  varifocal-weighted BCE against the IoU-normalised alignment target,
  GIoU and DFL on the positives, over the positives' target sum.  The
  JAX function loops over the images (unrolled under ``jit``); here the
  whole batch is one pass of batched tensor ops, the same function.
  The assignment (:meth:`PPYOLOELoss.assign`) is discrete:
  ``topk``'s k-th value stands for ``jnp.sort(...)[-k]`` and both
  ``argmax``s return the first maximum.  Head outputs are upcast to f32
  first, so a bf16 step computes its loss in f32.  Clips that carry a
  gradient are ``minimum(maximum(x, lo), hi)``, as ``jnp.clip`` is, so a
  tie splits its gradient as JAX's does.  A step waits for the device
  nowhere: the grid points are made on the device once a shape, and no
  value crosses from the host.

Convolutions run through ``F.conv2d`` (cuDNN on the card), as the JAX
model's run through XLA; no TPU kernel is on this path.  ``PPYOLOE``
takes ``device=`` (``"cuda"`` unless given; raises without a card) and
starts in training mode.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch import nn as tnn

from ... import nn
from ...device import resolve_device
from .. import ops as vops

__all__ = ["ConvBN", "RepConvBlock", "ESEAttn", "CSPRepStage",
           "CSPRepResNet", "CSPPAN", "PPYOLOEHead", "PPYOLOE",
           "PPYOLOELoss", "ppyoloe_s", "ppyoloe_crn_s"]


class ConvBN(tnn.Module):
    def __init__(self, cin, cout, k=3, stride=1, groups=1, act=True):
        super().__init__()
        self.conv = nn.Conv2D(cin, cout, k, stride=stride,
                              padding=(k - 1) // 2, groups=groups,
                              bias_attr=False)
        self.bn = nn.BatchNorm2D(cout)
        self.act = nn.Swish() if act else None

    def forward(self, x):
        x = self.bn(self.conv(x))
        return self.act(x) if self.act is not None else x


def _bn_fold(conv, bn):
    """The conv's weight and a bias with the batch norm's running
    statistics folded in (eps 1e-5), in f32."""
    p, b = bn._parameters, bn._buffers
    std = torch.sqrt(b["_variance"].float() + 1e-5)
    scale = p["weight"].float() / std
    return (conv._parameters["weight"].float() * scale[:, None, None, None],
            p["bias"].float() - b["_mean"].float() * scale)


class RepConvBlock(tnn.Module):
    """RepVGG block: parallel 3x3 and 1x1 ``ConvBN`` branches, Swish;
    ``fuse()`` re-parameterises them into one 3x3 conv (deploy mode)."""

    def __init__(self, ch):
        super().__init__()
        self.conv3 = ConvBN(ch, ch, 3, act=False)
        self.conv1 = ConvBN(ch, ch, 1, act=False)
        self.act = nn.Swish()
        self._fused = None

    def forward(self, x):
        if self._fused is not None:
            return self.act(self._fused(x))
        return self.act(self.conv3(x) + self.conv1(x))

    @torch.no_grad()
    def fuse(self):
        w3, b3 = _bn_fold(self.conv3.conv, self.conv3.bn)
        w1, b1 = _bn_fold(self.conv1.conv, self.conv1.bn)
        w1 = torch.nn.functional.pad(w1, (1, 1, 1, 1))
        ref = self.conv3.conv._parameters["weight"]
        with ref.device:
            fused = nn.Conv2D(w3.shape[1], w3.shape[0], 3, padding=1)
        fused.to(dtype=ref.dtype)
        fused._parameters["weight"].copy_(w3 + w1)
        fused._parameters["bias"].copy_(b3 + b1)
        self._fused = fused
        return self


class ESEAttn(tnn.Module):
    """Effective squeeze-excitation: one 1x1 conv on the spatial mean."""

    def __init__(self, ch):
        super().__init__()
        self.fc = nn.Conv2D(ch, ch, 1)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        return x * torch.sigmoid(self.fc(s))


class CSPRepStage(tnn.Module):
    def __init__(self, cin, cout, n_blocks, stride=2):
        super().__init__()
        self.down = ConvBN(cin, cout, 3, stride=stride)
        half = cout // 2
        self.a = ConvBN(cout, half, 1)
        self.b = ConvBN(cout, half, 1)
        self.blocks = nn.Sequential(*[RepConvBlock(half)
                                      for _ in range(n_blocks)])
        self.attn = ESEAttn(cout)
        self.fuse = ConvBN(cout, cout, 1)

    def forward(self, x):
        x = self.down(x)
        y = torch.cat([self.a(x), self.blocks(self.b(x))], dim=1)
        return self.fuse(self.attn(y))


class CSPRepResNet(tnn.Module):
    """Stem and four CSP-Rep stages; returns the stride 8, 16 and 32
    feature maps."""

    def __init__(self, width=(32, 64, 128, 256, 512), depth=(1, 2, 2, 1),
                 in_channels=3):
        super().__init__()
        self.stem = nn.Sequential(ConvBN(in_channels, width[0], 3, stride=2),
                                  ConvBN(width[0], width[0], 3))
        self.stages = nn.LayerList([
            CSPRepStage(width[i], width[i + 1], depth[i]) for i in range(4)])
        self.out_channels = tuple(width[2:])

    def forward(self, x):
        x = self.stem(x)
        feats = []
        for stage in self.stages:
            x = stage(x)
            feats.append(x)
        return feats[1:]


class CSPPAN(tnn.Module):
    """Top-down fusion with 2x nearest upsampling, then bottom-up
    re-aggregation."""

    def __init__(self, in_channels, out_ch=None):
        super().__init__()
        c3, c4, c5 = in_channels
        o3, o4, o5 = out_ch or in_channels
        self.reduce5 = ConvBN(c5, o5, 1)
        self.reduce4 = ConvBN(c4, o4, 1)
        self.reduce3 = ConvBN(c3, o3, 1)
        self.lat4 = ConvBN(o5, o4, 1)
        self.lat3 = ConvBN(o4, o3, 1)
        self.td4 = nn.Sequential(RepConvBlock(o4), ESEAttn(o4))
        self.td3 = nn.Sequential(RepConvBlock(o3), ESEAttn(o3))
        self.down3 = ConvBN(o3, o3, 3, stride=2)
        self.bu4 = ConvBN(o3 + o4, o4, 1)
        self.down4 = ConvBN(o4, o4, 3, stride=2)
        self.bu5 = ConvBN(o4 + o5, o5, 1)
        self.out_channels = (o3, o4, o5)

    def forward(self, feats):
        p3, p4, p5 = feats
        up = nn.functional.interpolate
        p5 = self.reduce5(p5)
        p4 = self.td4(self.reduce4(p4) + up(self.lat4(p5), scale_factor=2))
        p3 = self.td3(self.reduce3(p3) + up(self.lat3(p4), scale_factor=2))
        n4 = self.bu4(torch.cat([self.down3(p3), p4], dim=1))
        n5 = self.bu5(torch.cat([self.down4(n4), p5], dim=1))
        return [p3, n4, n5]


class PPYOLOEHead(tnn.Module):
    """Per level: ESE-attended stems, class logits and DFL bins."""

    def __init__(self, in_channels, num_classes=80, reg_max=16):
        super().__init__()
        self.num_classes = num_classes
        self.reg_max = reg_max
        self.stems_cls = nn.LayerList([ESEAttn(c) for c in in_channels])
        self.stems_reg = nn.LayerList([ESEAttn(c) for c in in_channels])
        self.cls_heads = nn.LayerList([
            nn.Conv2D(c, num_classes, 3, padding=1) for c in in_channels])
        self.reg_heads = nn.LayerList([
            nn.Conv2D(c, 4 * (reg_max + 1), 3, padding=1)
            for c in in_channels])
        prior = float(-math.log((1 - 0.01) / 0.01))
        with torch.no_grad():
            for h in self.cls_heads:
                h._parameters["bias"].fill_(prior)

    def forward(self, feats):
        cls_list, reg_list = [], []
        for i, f in enumerate(feats):
            cls_list.append(self.cls_heads[i](self.stems_cls[i](f) + f))
            reg_list.append(self.reg_heads[i](self.stems_reg[i](f) + f))
        return cls_list, reg_list


def _grid_points(shapes, strides):
    """Point centres ``[sum HW, 2]`` (x, y) in image coordinates and each
    point's stride ``[sum HW]``, f32 numpy (the JAX function)."""
    pts, sts = [], []
    for (h, w), s in zip(shapes, strides):
        yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        ctr = (np.stack([xx, yy], -1).reshape(-1, 2) + 0.5) * s
        pts.append(ctr)
        sts.append(np.full((h * w,), s, np.float32))
    return (np.concatenate(pts).astype(np.float32),
            np.concatenate(sts))


@functools.lru_cache(maxsize=16)
def _grid_on(shapes, device):
    """:func:`_grid_points` as tensors on ``device``, made once a shape (a
    copy from the host waits for the device, so it stays out of steps)."""
    pts, sts = _grid_points(shapes, PPYOLOE.STRIDES)
    return (torch.from_numpy(pts).to(device),
            torch.from_numpy(sts).to(device))


def _flat(outputs, num_classes, reg_max):
    """Head outputs -> (class logits ``[N, P, C]``, DFL logits ``[N, P, 4,
    reg_max + 1]``) in f32, and the grid points and strides on their
    device."""
    cls_list, reg_list = outputs
    b = cls_list[0].shape[0]
    cls = torch.cat([c.reshape(b, num_classes, -1) for c in cls_list],
                    -1).transpose(1, 2).float()
    reg = torch.cat([r.reshape(b, 4 * (reg_max + 1), -1) for r in reg_list],
                    -1).transpose(1, 2).reshape(b, -1, 4, reg_max + 1).float()
    pts, sts = _grid_on(tuple(tuple(c.shape[2:]) for c in cls_list),
                        cls.device)
    return cls, reg, pts, sts


def _boxes(reg, p, s):
    """Expected l, t, r, b over the bins, as xyxy boxes ``[N, P, 4]``."""
    bins = torch.arange(reg.shape[-1], dtype=torch.float32, device=reg.device)
    ltrb = (torch.softmax(reg, -1) * bins).sum(-1)
    sc = s[None, :, None]
    return torch.cat([p[None] - ltrb[..., :2] * sc,
                      p[None] + ltrb[..., 2:] * sc], -1)


class PPYOLOE(tnn.Module):
    """``forward(images)`` returns the per-level raw head outputs
    ``(cls_list, reg_list)``; ``decode()`` turns them into boxes and
    scores, ``predict()`` adds NMS."""

    STRIDES = (8, 16, 32)

    def __init__(self, num_classes=80, width=(32, 64, 128, 256, 512),
                 depth=(1, 2, 2, 1), reg_max=16, in_channels=3, device=None):
        super().__init__()
        dev = resolve_device(device)
        with dev:   # the Layers create their parameters there
            self.backbone = CSPRepResNet(width, depth, in_channels)
            self.neck = CSPPAN(self.backbone.out_channels)
            self.head = PPYOLOEHead(self.neck.out_channels, num_classes,
                                    reg_max)
            self.num_classes = num_classes
            self.reg_max = reg_max
        self.to(dev)

    def forward(self, x):
        return self.head(self.neck(self.backbone(x)))

    def fuse(self):
        """Re-parameterise every ``RepConvBlock`` for deployment."""
        for layer in self.modules():
            if isinstance(layer, RepConvBlock):
                layer.fuse()
        return self

    def decode(self, outputs):
        """Head outputs -> (boxes ``[N, P, 4]`` xyxy, scores ``[N, P,
        C]``), f32."""
        cls, reg, p, s = _flat(outputs, self.num_classes, self.reg_max)
        return _boxes(reg, p, s), torch.sigmoid(cls)

    @torch.no_grad()
    def predict(self, x, score_threshold=0.4, nms_threshold=0.5,
                max_dets=100):
        """Per image ``(boxes [K, 4], scores [K, C])`` as numpy arrays,
        the detections NMS keeps in descending score order."""
        boxes, scores = self.decode(self(x))
        out = []
        for i in range(boxes.shape[0]):
            best = scores[i].max(dim=-1).values
            idx = torch.nonzero(best > score_threshold).reshape(-1)
            keep = idx[vops.nms(boxes[i][idx], iou_threshold=nms_threshold,
                                scores=best[idx], top_k=max_dets)]
            out.append((boxes[i][keep].cpu().numpy(),
                        scores[i][keep].cpu().numpy()))
        return out


def _clip(x, lo=None, hi=None):
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)`` (a tie splits the
    gradient)."""
    if lo is not None:
        x = torch.maximum(x, x.new_full((), lo))
    if hi is not None:
        x = torch.minimum(x, x.new_full((), hi))
    return x


def _iou(a, g):
    """Pairwise IoU of ``a`` ``[N, P, 4]`` and ``g`` ``[N, M, 4]``: ``[N,
    P, M]``."""
    lt = torch.maximum(a[:, :, None, :2], g[:, None, :, :2])
    rb = torch.minimum(a[:, :, None, 2:], g[:, None, :, 2:])
    wh = _clip(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    ea = _clip(a[..., 2:] - a[..., :2], 0.0)
    eg = _clip(g[..., 2:] - g[..., :2], 0.0)
    aa, ga = ea[..., 0] * ea[..., 1], eg[..., 0] * eg[..., 1]
    return inter / _clip(aa[:, :, None] + ga[:, None, :] - inter, 1e-9)


class PPYOLOELoss(tnn.Module):
    """Task-aligned assignment, varifocal-weighted BCE, GIoU and DFL.
    ``forward(outputs, gt_boxes [N, M, 4] xyxy, gt_labels [N, M])``; a
    label of -1 pads."""

    def __init__(self, model: PPYOLOE, topk=9, alpha=1.0, beta=6.0,
                 cls_weight=1.0, iou_weight=2.5, dfl_weight=0.5):
        super().__init__()
        self.m = model
        self.topk = topk
        self.alpha, self.beta = alpha, beta
        self.w = (cls_weight, iou_weight, dfl_weight)

    @torch.no_grad()
    def assign(self, cls, pred, p, gt_boxes, gt_labels):
        """The TAL assignment over the batch: ``is_pos`` and ``best_gt``
        ``[N, P]``, the alignment target ``tgt_score`` ``[N, P]`` and the
        assigned class ``[N, P]``, from the class logits ``cls`` ``[N, P,
        C]``, the predicted boxes ``[N, P, 4]`` and the points ``p``."""
        nc = self.m.num_classes
        g, gl = gt_boxes, gt_labels
        valid = gl >= 0
        scores = torch.sigmoid(cls)
        ious = _iou(pred, g)                                 # [N, P, M]
        safe = gl.clamp(0, nc - 1)
        cls_g = scores.gather(2, safe[:, None, :].expand(-1, cls.shape[1],
                                                         -1))
        metric = cls_g ** self.alpha * ious ** self.beta
        px, py = p[None, :, None, 0], p[None, :, None, 1]
        inside = ((px >= g[:, None, :, 0]) & (px <= g[:, None, :, 2])
                  & (py >= g[:, None, :, 1]) & (py <= g[:, None, :, 3]))
        metric = torch.where(inside & valid[:, None, :], metric,
                             torch.full_like(metric, -1.0))
        k = min(self.topk, metric.shape[1])
        thresh = metric.topk(k, dim=1).values[:, k - 1:k, :]  # [N, 1, M]
        cand = (metric >= thresh.clamp(min=0)) & (metric > 0)
        best_gt = torch.where(cand, metric,
                              torch.full_like(metric, -1.0)).argmax(2)
        is_pos = cand.any(2)
        pos_iou = ious.gather(2, best_gt[..., None])[..., 0]
        pos_metric = metric.gather(2, best_gt[..., None])[..., 0]
        top = pos_metric.max(dim=1, keepdim=True).values.clamp(min=1e-9)
        norm = pos_metric * (pos_iou / top)
        tgt_score = torch.where(is_pos, norm, torch.zeros_like(norm))
        return dict(is_pos=is_pos, best_gt=best_gt, tgt_score=tgt_score,
                    label=safe.gather(1, best_gt))

    def forward(self, outputs, gt_boxes, gt_labels):
        m = self.m
        nc, rmax = m.num_classes, m.reg_max
        cls, reg, p, s = _flat(outputs, nc, rmax)
        g = torch.as_tensor(gt_boxes, device=cls.device).float()
        gl = torch.as_tensor(gt_labels, device=cls.device).long()
        pred = _boxes(reg, p, s)                             # [N, P, 4]
        t = self.assign(cls, pred.detach(), p, g, gl)
        is_pos, tgt_score = t["is_pos"], t["tgt_score"]
        tgt_cls = nn.functional.one_hot(t["label"], nc) * tgt_score[..., None]

        pr = torch.sigmoid(cls)
        wgt = torch.where(tgt_cls > 0, tgt_cls, 0.75 * pr ** 2.0)
        bce = -(tgt_cls * torch.log(_clip(pr, 1e-9, 1.0))
                + (1 - tgt_cls) * torch.log(_clip(1 - pr, 1e-9, 1.0)))
        total_cls = (wgt * bce).sum()

        gsel = g.gather(1, t["best_gt"][..., None].expand(-1, -1, 4))
        lt = torch.maximum(pred[..., :2], gsel[..., :2])
        rb = torch.minimum(pred[..., 2:], gsel[..., 2:])
        wh = _clip(rb - lt, 0.0)
        inter = wh[..., 0] * wh[..., 1]
        ea = _clip(pred[..., 2:] - pred[..., :2], 0.0)
        eg = _clip(gsel[..., 2:] - gsel[..., :2], 0.0)
        union = _clip(ea[..., 0] * ea[..., 1] + eg[..., 0] * eg[..., 1]
                      - inter, 1e-9)
        ec = _clip(torch.maximum(pred[..., 2:], gsel[..., 2:])
                   - torch.minimum(pred[..., :2], gsel[..., :2]), 0.0)
        area_c = _clip(ec[..., 0] * ec[..., 1], 1e-9)
        giou = inter / union - (area_c - union) / area_c
        zero = torch.zeros_like(tgt_score)
        total_iou = torch.where(is_pos, (1 - giou) * tgt_score, zero).sum()

        sc = s[None, :, None]
        d_tgt = torch.cat([(p[None] - gsel[..., :2]) / sc,
                           (gsel[..., 2:] - p[None]) / sc], -1)
        d_tgt = _clip(d_tgt, 0.0, rmax - 0.01)
        dl = torch.floor(d_tgt)
        wr = d_tgt - dl
        logp = torch.log_softmax(reg, -1)
        li = dl.long()[..., None]
        lp_l = logp.gather(-1, li)[..., 0]
        lp_r = logp.gather(-1, li + 1)[..., 0]
        dfl = -(lp_l * (1 - wr) + lp_r * wr).mean(-1)
        total_dfl = torch.where(is_pos, dfl * tgt_score, zero).sum()
        total_pos = tgt_score.sum(1).clamp(min=1.0).sum()

        wc, wi, wd = self.w
        return (wc * total_cls + wi * total_iou + wd * total_dfl) / total_pos


def ppyoloe_s(num_classes=80, **kw):
    """PP-YOLOE-s width and depth."""
    return PPYOLOE(num_classes, width=(32, 64, 128, 256, 512),
                   depth=(1, 2, 2, 1), **kw)


def ppyoloe_crn_s(num_classes=80, **kw):  # PaddleDetection naming alias
    return ppyoloe_s(num_classes, **kw)

