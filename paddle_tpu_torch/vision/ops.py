"""Detection ops (``paddle_tpu.vision.ops`` counterparts): the YOLO decode
and loss, the box coder and prior boxes, the NMS family, the RoI pools,
the FPN routing, RPN proposals, deformable convolution and the file /
JPEG readers.

Each function takes torch tensors or the port's ``Tensor`` (numpy arrays
where the JAX one reads them on the host) and gives back the kind its
first input was: torch in, torch out; a ``Tensor`` in, a ``Tensor`` out.
The work runs on the first input's device with the JAX function's
elementwise float32 ops in its order, and autograd gives the gradients
where JAX has them (``box_coder``, ``roi_align``, ``psroi_pool``,
``deform_conv2d``; the port's ``yolo_box`` and ``roi_pool`` also carry
them, the JAX ones record none).

Host syncs a call on the card: device-to-host reads, and uploads from
pageable host memory, which wait for the stream too (counted by
``chip_smoke.py`` phase 52 on the H100):

* ``box_coder``, ``psroi_pool``, ``deform_conv2d``: none; ``yolo_box``
  and ``prior_box``: none but the upload of a host ``img_size`` / of the
  boxes made on the host.
* ``roi_align``: none with ``sampling_ratio > 0``; one (the boxes, for
  the per-RoI adaptive ratios of the JAX function) with
  ``sampling_ratio <= 0``.
* ``nms``: two (the ``[n, n]`` overlap matrix down, the kept positions
  up; the greedy pass runs on the host, as the JAX ``fori_loop`` is
  sequential).
* ``multiclass_nms``, ``matrix_nms``: four (boxes and scores in one copy
  down, the three results up; the JAX functions are host numpy, and so
  is the rest here).
* ``distribute_fpn_proposals``: one, and one upload a level.
* ``roi_pool``: two (the boxes and ``boxes_num``; the bins are sliced on
  the host, as in JAX, and each bin's max is a device op).
* ``generate_proposals``: eight for two images (an image's size filter
  and ``nms``'s two, and the image sizes when they are on the card).
* ``yolo_loss``: see ``models.yolo.yolo_head_loss``.

The sampling follows the JAX functions, not torchvision's: RoI Align's
grid, its ``aligned`` half-pixel shift and ``sampling_ratio`` handling,
and ``_bilinear_gather``'s rule (a sample within one pixel outside the
map reads the clamped edge, beyond that it is zero), which
``deform_conv2d`` shares (ROADMAP section 3 item 4).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import Tensor
from ..nn import initializer as _init
from ..nn.layer_base import Layer, param

__all__ = ["yolo_box", "roi_align", "psroi_pool", "box_coder", "nms",
           "deform_conv2d", "DeformConv2D", "RoIAlign", "PSRoIPool",
           "prior_box", "multiclass_nms", "roi_pool", "RoIPool",
           "matrix_nms", "distribute_fpn_proposals", "generate_proposals",
           "read_file", "decode_jpeg", "yolo_loss"]


def _t(x, device=None):
    """The torch value of ``x`` (a Tensor, a torch tensor or array-like),
    on ``device`` when given."""
    if isinstance(x, Tensor):
        x = x._value
    elif not torch.is_tensor(x):
        x = torch.as_tensor(np.asarray(x))
    return x if device is None else x.to(device)


def _host(x):
    """A numpy copy of ``x`` (one device-to-host read for a card tensor)."""
    if isinstance(x, Tensor):
        x = x._value
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _like(first, *outs):
    """``outs`` as Tensors when ``first`` is one, else as they are."""
    if isinstance(first, Tensor):
        outs = tuple(Tensor._wrap(o) if torch.is_tensor(o) else o
                     for o in outs)
    return outs[0] if len(outs) == 1 else outs


def _device(x):
    return x._value.device if isinstance(x, Tensor) else (
        x.device if torch.is_tensor(x) else torch.device("cpu"))


# -- yolo_box ----------------------------------------------------------------

def yolo_box(x, img_size, anchors, class_num, conf_thresh,
             downsample_ratio, clip_bbox=True, name=None, scale_x_y=1.0,
             iou_aware=False, iou_aware_factor=0.5):
    """Decode a YOLOv3 head ``[N, A*(5+C), H, W]`` into boxes
    ``[N, A*H*W, 4]`` and scores ``[N, A*H*W, C]``."""
    anchors_np = np.asarray(anchors, np.float32).reshape(-1, 2)
    na = anchors_np.shape[0]
    xv = _t(x)
    img = _t(img_size, xv.device).to(torch.float32)
    n, _, h, w = xv.shape
    if iou_aware:
        # iou-aware head (PP-YOLO): the leading na channels are the
        # predicted IoU; objectness becomes conf^(1-f) * iou^f
        iou_pred = torch.sigmoid(xv[:, :na].reshape(n, na, h, w))
        xv = xv[:, na:]
    pred = xv.reshape(n, na, 5 + class_num, h, w)
    gx = torch.arange(w, dtype=xv.dtype, device=xv.device)
    gy = torch.arange(h, dtype=xv.dtype, device=xv.device)
    bx = (torch.sigmoid(pred[:, :, 0]) * scale_x_y -
          (scale_x_y - 1) / 2 + gx[None, None, None, :]) / w
    by = (torch.sigmoid(pred[:, :, 1]) * scale_x_y -
          (scale_x_y - 1) / 2 + gy[None, None, :, None]) / h
    anc = torch.as_tensor(anchors_np, dtype=xv.dtype, device=xv.device)
    bw = torch.exp(pred[:, :, 2]) * anc[None, :, 0, None, None] / \
        (w * downsample_ratio)
    bh = torch.exp(pred[:, :, 3]) * anc[None, :, 1, None, None] / \
        (h * downsample_ratio)
    conf = torch.sigmoid(pred[:, :, 4])
    if iou_aware:
        conf = conf ** (1.0 - iou_aware_factor) * \
            iou_pred ** iou_aware_factor
    probs = torch.sigmoid(pred[:, :, 5:])
    scores = conf[:, :, None] * probs
    keep = (conf >= conf_thresh)[:, :, None]
    img_h = img[:, 0].reshape(n, 1, 1, 1)
    img_w = img[:, 1].reshape(n, 1, 1, 1)
    x0 = (bx - bw / 2) * img_w
    y0 = (by - bh / 2) * img_h
    x1 = (bx + bw / 2) * img_w
    y1 = (by + bh / 2) * img_h
    if clip_bbox:
        # jnp.clip(v, 0, hi) = minimum(maximum(v, 0), hi)
        x0 = torch.minimum(x0.clamp(min=0), img_w - 1)
        y0 = torch.minimum(y0.clamp(min=0), img_h - 1)
        x1 = torch.minimum(x1.clamp(min=0), img_w - 1)
        y1 = torch.minimum(y1.clamp(min=0), img_h - 1)
    boxes = torch.stack([x0, y0, x1, y1], dim=2)
    boxes = boxes * (conf >= conf_thresh)[:, :, None]
    boxes = boxes.permute(0, 1, 3, 4, 2).reshape(n, na * h * w, 4)
    scores = (scores * keep).permute(0, 1, 3, 4, 2).reshape(
        n, na * h * w, class_num)
    return _like(x, boxes, scores)


# -- roi_align ---------------------------------------------------------------

def _bilinear(read, ys, xs, h, w, weight=lambda t: t):
    """Bilinear samples at ``(ys, xs)`` by the JAX rule: each corner's
    index clamped into the ``h x w`` map, samples outside ``[-1, h] x
    [-1, w]`` zero.  ``read(yi, xi)`` gives the values at integer
    corners; ``weight(t)`` shapes a per-sample weight to broadcast
    against them."""
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy1 = ys - y0
    wx1 = xs - x0
    wy0, wx0 = 1 - wy1, 1 - wx1

    def at(yi, xi):
        return read(yi.to(torch.int32).clamp(0, h - 1).long(),
                    xi.to(torch.int32).clamp(0, w - 1).long())

    valid = (ys >= -1) & (ys <= h) & (xs >= -1) & (xs <= w)
    out = (at(y0, x0) * weight(wy0 * wx0) +
           at(y0, x0 + 1) * weight(wy0 * wx1) +
           at(y0 + 1, x0) * weight(wy1 * wx0) +
           at(y0 + 1, x0 + 1) * weight(wy1 * wx1))
    return out * weight(valid.to(out.dtype))


def _bilinear_gather(feat, ys, xs):
    """feat ``[C, H, W]``; ys / xs of any one shape -> ``[C, *shape]``
    bilinear samples (the JAX function of this name)."""
    return _bilinear(lambda yi, xi: feat[:, yi, xi], ys, xs,
                     feat.shape[-2], feat.shape[-1])


def _roi_images(bn, r, device):
    """Each RoI's image index from the per-image counts (on the device)."""
    bn = bn.to(device=device, dtype=torch.int64)
    starts = torch.cumsum(bn, 0) - bn
    return (torch.arange(r, device=device)[:, None] >=
            starts[None, :]).sum(1) - 1


def _roi_align_rois(xv, roi_img, x0, y0, bin_h, bin_w, ph, pw, sr_h, sr_w):
    """RoI Align of RoIs that share one sampling ratio: ``[R, C, ph,
    pw]``, every RoI's ``ph * sr_h`` by ``pw * sr_w`` samples gathered in
    one indexing op."""
    dev = xv.device
    c, h, w = xv.shape[1:]
    iy = (torch.arange(ph, device=dev)[:, None] +
          (torch.arange(sr_h, device=dev)[None, :] + 0.5) / sr_h)
    ix = (torch.arange(pw, device=dev)[:, None] +
          (torch.arange(sr_w, device=dev)[None, :] + 0.5) / sr_w)
    ys = (y0[:, None, None] + iy[None] * bin_h[:, None, None]).reshape(
        len(roi_img), -1)[:, :, None]               # [R, ph*sr_h, 1]
    xs = (x0[:, None, None] + ix[None] * bin_w[:, None, None]).reshape(
        len(roi_img), -1)[:, None, :]               # [R, 1, pw*sr_w]
    b = roi_img[:, None, None]
    vals = _bilinear(lambda yi, xi: xv[b, :, yi, xi], ys, xs, h, w,
                     lambda t: t[..., None])        # [R, Y, X, C]
    vals = vals.permute(0, 3, 1, 2).reshape(len(roi_img), c, ph, sr_h, pw,
                                            sr_w)
    return vals.mean(dim=(3, 5))


def roi_align(x, boxes, boxes_num, output_size, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True, name=None):
    """RoI Align: boxes ``[R, 4]`` (x0, y0, x1, y1) in image coordinates,
    ``boxes_num`` the RoIs of each image; ``[R, C, ph, pw]``.

    ``sampling_ratio <= 0`` takes ``ceil(bin size)`` samples a bin, per
    RoI, from the boxes read on the host (one sync), as the JAX function
    does on concrete boxes; RoIs that share a ratio go through one
    gather."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    ph, pw = output_size
    xv = _t(x)
    bv = _t(boxes, xv.device)
    r = bv.shape[0]
    roi_img = _roi_images(_t(boxes_num), r, xv.device)
    off = 0.5 if aligned else 0.0
    x0 = bv[:, 0] * spatial_scale - off
    y0 = bv[:, 1] * spatial_scale - off
    x1 = bv[:, 2] * spatial_scale - off
    y1 = bv[:, 3] * spatial_scale - off
    rw = x1 - x0
    rh = y1 - y0
    if not aligned:
        rw = rw.clamp(min=1.0)
        rh = rh.clamp(min=1.0)
    bin_h = rh / ph
    bin_w = rw / pw
    if r == 0:
        out = xv.new_zeros((0, xv.shape[1], ph, pw))
    elif sampling_ratio > 0:
        out = _roi_align_rois(xv, roi_img, x0, y0, bin_h, bin_w, ph, pw,
                              sampling_ratio, sampling_ratio)
    else:
        b_np = _host(bv)
        rh_np = (b_np[:, 3] - b_np[:, 1]) * spatial_scale
        rw_np = (b_np[:, 2] - b_np[:, 0]) * spatial_scale
        if not aligned:
            rh_np = np.maximum(rh_np, 1.0)
            rw_np = np.maximum(rw_np, 1.0)
        ratios = np.stack([np.maximum(1, np.ceil(rh_np / ph)),
                           np.maximum(1, np.ceil(rw_np / pw))],
                          1).astype(np.int64)
        parts, order = [], []
        for sr_h, sr_w in np.unique(ratios, axis=0):
            sel_np = np.nonzero((ratios[:, 0] == sr_h) &
                                (ratios[:, 1] == sr_w))[0]
            sel = torch.as_tensor(sel_np, device=xv.device)
            parts.append(_roi_align_rois(
                xv, roi_img[sel], x0[sel], y0[sel], bin_h[sel], bin_w[sel],
                ph, pw, int(sr_h), int(sr_w)))
            order.append(sel_np)
        inv = torch.as_tensor(np.argsort(np.concatenate(order)),
                              device=xv.device)
        out = torch.cat(parts)[inv]
    return _like(x, out)


def psroi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0,
               name=None):
    """Position-sensitive RoI average pooling: input channels ``C =
    out_c * ph * pw``; bin (i, j) averages its own channel slice over the
    pixels its floor / ceil edges cover (at least one)."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    ph, pw = output_size
    xv = _t(x)
    bv = _t(boxes, xv.device)
    n, c, h, w = xv.shape
    out_c = c // (ph * pw)
    r = bv.shape[0]
    roi_img = _roi_images(_t(boxes_num), r, xv.device)
    x0 = bv[:, 0] * spatial_scale
    y0 = bv[:, 1] * spatial_scale
    x1 = bv[:, 2] * spatial_scale
    y1 = bv[:, 3] * spatial_scale
    rw = (x1 - x0).clamp(min=0.1)
    rh = (y1 - y0).clamp(min=0.1)
    bin_h = rh / ph
    bin_w = rw / pw
    yy = torch.arange(h, dtype=xv.dtype, device=xv.device)
    xx = torch.arange(w, dtype=xv.dtype, device=xv.device)
    ys = y0[:, None] + torch.arange(ph, dtype=xv.dtype,
                                    device=xv.device) * bin_h[:, None]
    ye = ys + bin_h[:, None]
    xs = x0[:, None] + torch.arange(pw, dtype=xv.dtype,
                                    device=xv.device) * bin_w[:, None]
    xe = xs + bin_w[:, None]
    my = ((yy >= torch.floor(ys)[..., None]) &
          (yy < torch.ceil(ye)[..., None])).to(xv.dtype)     # [R, ph, H]
    mx = ((xx >= torch.floor(xs)[..., None]) &
          (xx < torch.ceil(xe)[..., None])).to(xv.dtype)     # [R, pw, W]
    area = (my.sum(2)[:, :, None] * mx.sum(2)[:, None, :]).clamp(min=1.0)
    feat = xv.reshape(n, out_c, ph, pw, h, w)
    out = xv.new_zeros((r, out_c, ph, pw))
    for b in range(n):          # each image's RoIs, masked (no sync)
        mine = (roi_img == b).to(xv.dtype)[:, None, None, None]
        out = out + torch.einsum("opqhw,rph,rqw->ropq", feat[b], my,
                                 mx) * mine
    return _like(x, out / area[:, None])


# -- box_coder ---------------------------------------------------------------

def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True, axis=0,
              name=None):
    """Encode / decode center-size boxes (the R-CNN delta transform).  For
    decode, ``axis`` picks the dim of the ``[row, col, 4]`` target the
    priors broadcast over: 0 a prior per column, 1 a prior per row;
    encode ignores ``axis``."""
    if axis not in (0, 1):
        raise ValueError(f"box_coder axis must be 0 or 1, got {axis}")
    pb = _t(prior_box)
    tb = _t(target_box, pb.device)
    pbv = None if prior_box_var is None else (
        torch.as_tensor(prior_box_var, dtype=torch.float32, device=pb.device)
        if isinstance(prior_box_var, (list, tuple))
        else _t(prior_box_var, pb.device))
    px0, py0, px1, py1 = pb[:, 0], pb[:, 1], pb[:, 2], pb[:, 3]
    norm = 0.0 if box_normalized else 1.0
    pw = px1 - px0 + norm
    ph = py1 - py0 + norm
    pcx = px0 + pw * 0.5
    pcy = py0 + ph * 0.5
    var = torch.ones((4,), dtype=tb.dtype, device=tb.device) \
        if pbv is None else pbv
    if code_type == "encode_center_size":
        tx0, ty0, tx1, ty1 = tb[:, 0], tb[:, 1], tb[:, 2], tb[:, 3]
        tw = tx1 - tx0 + norm
        th = ty1 - ty0 + norm
        tcx = tx0 + tw * 0.5
        tcy = ty0 + th * 0.5
        if pbv is not None and pbv.ndim == 2:
            vx, vy, vw, vh = var[:, 0], var[:, 1], var[:, 2], var[:, 3]
        else:
            vx, vy, vw, vh = var[0], var[1], var[2], var[3]
        out = torch.stack([
            (tcx[:, None] - pcx[None, :]) / pw[None, :] / vx,
            (tcy[:, None] - pcy[None, :]) / ph[None, :] / vy,
            torch.log(tw[:, None] / pw[None, :]) / vw,
            torch.log(th[:, None] / ph[None, :]) / vh,
        ], dim=-1)  # [T, P, 4]
        return _like(prior_box, out)
    if code_type == "decode_center_size":
        d = tb if tb.ndim == 3 else (tb[:, None, :] if axis == 0
                                     else tb[None, :, :])

        def bc(t):
            return t[None, :] if axis == 0 else t[:, None]

        if pbv is not None and pbv.ndim == 2:
            v = pbv[None, :, :] if axis == 0 else pbv[:, None, :]
        else:
            v = var.reshape(1, 1, 4)
        cx = d[..., 0] * v[..., 0] * bc(pw) + bc(pcx)
        cy = d[..., 1] * v[..., 1] * bc(ph) + bc(pcy)
        w = torch.exp(d[..., 2] * v[..., 2]) * bc(pw)
        h = torch.exp(d[..., 3] * v[..., 3]) * bc(ph)
        return _like(prior_box, torch.stack(
            [cx - w * 0.5, cy - h * 0.5, cx + w * 0.5 - norm,
             cy + h * 0.5 - norm], dim=-1))
    raise ValueError(f"unknown code_type {code_type!r}")


# -- nms ---------------------------------------------------------------------

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
    """Greedy hard NMS; the kept indices (int64, on ``boxes``' device) in
    descending score order.

    Boxes are visited in the order of a stable descending sort of their
    scores (``jnp.argsort(-s)`` is stable, so ``torch.argsort(-s,
    stable=True)``); a box is kept unless a kept box before it overlaps
    it by more than ``iou_threshold`` (IoU by ``_iou_matrix``, areas
    unclipped, the union floored at 1e-9); with ``category_idxs`` only
    boxes of one category suppress each other (``categories`` is
    accepted and not read, as there).  The IoU test runs on the boxes'
    device as one ``[n, n]`` boolean matrix in visiting order; the
    greedy pass is sequential, as the JAX ``fori_loop`` is, and runs on
    the host over that matrix (one copy, then a numpy loop over the kept
    boxes only)."""
    bv = _t(boxes)
    n = bv.shape[0]
    sv = torch.ones(n, dtype=bv.dtype, device=bv.device) if scores is None \
        else _t(scores, bv.device)
    order = torch.argsort(-sv, stable=True)
    iou = _iou_matrix(bv)
    if category_idxs is not None:
        cv = _t(category_idxs, bv.device)
        same = cv[:, None] == cv[None, :]
        iou = torch.where(same, iou, torch.zeros_like(iou))
    # over[i, j]: the i-th visited box overlaps the j-th (iou[order[i],
    # order[j]], the JAX loop's row for box i); the matrix is exactly
    # symmetric (max, min and the sums commute), so a kept box's row is
    # read, contiguous in memory, where its column would be strided
    over = (iou[order][:, order] > iou_threshold).cpu().numpy()
    removed = np.zeros(n, bool)
    keep = []
    for i in range(n):
        if removed[i]:
            continue
        keep.append(i)
        removed |= over[i]
    kept = order[torch.as_tensor(keep, dtype=torch.int64,
                                 device=order.device)]
    return _like(boxes, kept if top_k is None else kept[:top_k])


# -- deform_conv2d -----------------------------------------------------------

def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None,
                  name=None):
    """Deformable convolution (DCNv1 without ``mask``, DCNv2 with): the
    zero-padded input sampled bilinearly at each kernel tap's offset
    position (offsets ``[N, dg * 2 * kh * kw, oh, ow]``, y then x a tap),
    scaled by the mask, then one GEMM a group (``torch.matmul``, as the
    JAX function's einsum).  The samples of a whole batch come from one
    ``gather`` of each corner; autograd gives the gradients of x,
    offset, mask and weight."""
    stride, padding, dilation = _pair(stride), _pair(padding), \
        _pair(dilation)
    xv = _t(x)
    ov = _t(offset, xv.device)
    wv = _t(weight, xv.device)
    n, c, h, w = xv.shape
    oc, cpg, kh, kw = wv.shape
    sh, sw = stride
    ph_, pw_ = padding
    dh, dw = dilation
    dg = deformable_groups
    out_h = (h + 2 * ph_ - (dh * (kh - 1) + 1)) // sh + 1
    out_w = (w + 2 * pw_ - (dw * (kw - 1) + 1)) // sw + 1
    xp = torch.nn.functional.pad(xv, (pw_, pw_, ph_, ph_))
    hp, wp = xp.shape[2], xp.shape[3]
    ov_r = ov.reshape(n, dg, 2, kh, kw, out_h, out_w)
    dev = xv.device
    gy = (torch.arange(out_h, device=dev)[None, None, :, None] * sh +
          torch.arange(kh, device=dev)[:, None, None, None] * dh +
          ov_r[:, :, 0])                     # [N, dg, kh, kw, oh, ow]
    gx = (torch.arange(out_w, device=dev)[None, None, None, :] * sw +
          torch.arange(kw, device=dev)[None, :, None, None] * dw +
          ov_r[:, :, 1])
    cg = c // dg
    feat = xp.reshape(n, dg, cg, hp * wp)
    taps = kh * kw * out_h * out_w

    def wt(t):
        return t.reshape(n, dg, 1, taps)

    def read(yi, xi):
        idx = (yi * wp + xi).reshape(n, dg, 1, taps).expand(n, dg, cg, taps)
        return torch.gather(feat, 3, idx)    # [N, dg, cg, taps]

    cols = _bilinear(read, gy, gx, hp, wp, wt)
    if mask is not None:
        cols = cols * wt(_t(mask, dev))
    # [N, C, kh*kw*oh*ow] -> [N, groups, cpg*kh*kw, oh*ow]
    cols = cols.reshape(n, groups, (c // groups) * kh * kw, out_h * out_w)
    w_g = wv.reshape(groups, oc // groups, cpg * kh * kw)
    out = torch.matmul(w_g, cols).reshape(n, oc, out_h, out_w)
    if bias is not None:
        out = out + _t(bias, dev)[None, :, None, None]
    return _like(x, out)


class DeformConv2D(Layer):
    """The layer form of ``deform_conv2d``: weight ``[out, in / groups,
    kh, kw]`` and bias drawn from ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, deformable_groups=1, groups=1,
                 weight_attr=None, bias_attr=None):
        super().__init__()
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size, kernel_size)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._deformable_groups = deformable_groups
        self._groups = groups
        fan_in = in_channels // groups * kernel_size[0] * kernel_size[1]
        bound = 1.0 / np.sqrt(fan_in)
        self.weight = self.create_parameter(
            (out_channels, in_channels // groups) + tuple(kernel_size),
            attr=weight_attr, default_initializer=_init.Uniform(-bound, bound))
        self.bias = self.create_parameter(
            (out_channels,), attr=bias_attr, is_bias=True,
            default_initializer=_init.Uniform(-bound, bound))

    def forward(self, x, offset, mask=None):
        return deform_conv2d(x, offset, param(self, "weight"),
                             param(self, "bias"), self._stride,
                             self._padding, self._dilation,
                             self._deformable_groups, self._groups, mask)


class RoIAlign(Layer):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self._output_size = output_size
        self._spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num, aligned=True):
        return roi_align(x, boxes, boxes_num, self._output_size,
                         self._spatial_scale, aligned=aligned)


class PSRoIPool(Layer):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self._output_size = output_size
        self._spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return psroi_pool(x, boxes, boxes_num, self._output_size,
                          self._spatial_scale)


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),  # noqa: A002
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, min_max_aspect_ratios_order=False,
              name=None):
    """SSD anchor generator: (boxes ``[H, W, P, 4]`` normalized xyxy,
    variances ``[H, W, P, 4]``), made on the host from the shapes alone
    and placed on ``input``'s device.  ``min_max_aspect_ratios_order=
    False`` emits [min, ar..., max] a min size; True [min, max, ar...]."""
    fh, fw = (input.shape[2], input.shape[3])
    ih, iw = (image.shape[2], image.shape[3])
    step_w = steps[0] or iw / fw
    step_h = steps[1] or ih / fh

    ars = [1.0]
    for ar in aspect_ratios:
        if not any(abs(ar - a) < 1e-6 for a in ars):
            ars.append(float(ar))
            if flip:
                ars.append(1.0 / float(ar))
    ar_tail = [a for a in ars if abs(a - 1.0) >= 1e-6]

    whs = []
    for i, ms in enumerate(min_sizes):
        ar_boxes = [(ms * np.sqrt(a), ms / np.sqrt(a)) for a in ar_tail]
        max_box = []
        if max_sizes:
            sq = np.sqrt(ms * max_sizes[i])
            max_box = [(sq, sq)]
        if min_max_aspect_ratios_order:
            whs += [(ms, ms)] + max_box + ar_boxes
        else:
            whs += [(ms, ms)] + ar_boxes + max_box

    p = len(whs)
    cx = (np.arange(fw) + offset) * step_w
    cy = (np.arange(fh) + offset) * step_h
    gx, gy = np.meshgrid(cx, cy)               # [H, W]
    w = np.asarray([wh[0] for wh in whs])      # [P]
    h = np.asarray([wh[1] for wh in whs])
    boxes = np.stack([
        (gx[..., None] - w * 0.5) / iw,
        (gy[..., None] - h * 0.5) / ih,
        (gx[..., None] + w * 0.5) / iw,
        (gy[..., None] + h * 0.5) / ih,
    ], axis=-1).astype(np.float32)             # [H, W, P, 4]
    if clip:
        boxes = np.clip(boxes, 0.0, 1.0)
    vars_ = np.broadcast_to(np.asarray(variance, np.float32),
                            (fh, fw, p, 4)).copy()
    dev = _device(input)
    return _like(input, torch.from_numpy(boxes).to(dev),
                 torch.from_numpy(vars_).to(dev))


def _host_pair(a, b):
    """Numpy copies of two float tensors in one device-to-host read."""
    av, bv = _t(a), _t(b)
    if av.device.type == "cpu" or bv.device != av.device:
        return _host(av), _host(bv)
    dt = torch.promote_types(av.dtype, bv.dtype)
    if dt == torch.bfloat16:
        dt = torch.float32
    flat = torch.cat([av.reshape(-1).to(dt), bv.reshape(-1).to(dt)]).cpu()
    na = av.numel()
    return (flat[:na].numpy().reshape(av.shape),
            flat[na:].numpy().reshape(bv.shape))


def multiclass_nms(bboxes, scores, score_threshold=0.05, nms_top_k=400,
                   keep_top_k=100, nms_threshold=0.3, normalized=True,
                   nms_eta=1.0, background_label=0, rois_num=None,
                   name=None):
    """Per-class NMS (host post-processing in the JAX package and in the
    reference; here too, after one copy of boxes and scores).

    bboxes ``[M, 4]`` or ``[N, M, 4]``; scores ``[C, M]`` or ``[N, C,
    M]``.  Returns (dets ``[K, 6]`` rows [label, score, x1, y1, x2, y2],
    index ``[K]``, nms_rois_num ``[N]``) on the boxes' device.
    ``keep_top_k`` / ``nms_top_k`` of -1 mean unlimited; ``normalized=
    False`` uses the pixel (+1 extent) IoU; ``nms_eta < 1`` decays the
    threshold."""
    b, s = _host_pair(bboxes, scores)
    batched = b.ndim == 3
    if not batched:
        b = b[None]
        s = s[None]
    norm = 0.0 if normalized else 1.0

    def _np_nms(boxes, cscores):
        order = np.argsort(-cscores)
        if nms_top_k > -1:
            order = order[:nms_top_k]
        keep = []
        thresh = nms_threshold
        areas = (boxes[:, 2] - boxes[:, 0] + norm) * \
            (boxes[:, 3] - boxes[:, 1] + norm)
        while order.size:
            i = order[0]
            keep.append(int(i))
            if order.size == 1:
                break
            rest = order[1:]
            lt = np.maximum(boxes[i, :2], boxes[rest, :2])
            rb = np.minimum(boxes[i, 2:], boxes[rest, 2:])
            wh = np.clip(rb - lt + norm, 0, None)
            inter = wh[:, 0] * wh[:, 1]
            iou = inter / np.maximum(areas[i] + areas[rest] - inter, 1e-10)
            order = rest[iou <= thresh]
            if nms_eta < 1.0 and thresh > 0.5:
                thresh *= nms_eta
        return keep

    all_dets, all_picks, per_img = [], [], []
    base = 0
    for n in range(b.shape[0]):
        dets, picks = [], []
        for c in range(s.shape[1]):
            if c == background_label:
                continue
            cs = s[n, c]
            cand = np.where(cs > score_threshold)[0]
            if cand.size == 0:
                continue
            for k in _np_nms(b[n][cand], cs[cand]):
                gi = int(cand[k])
                dets.append([float(c), float(cs[gi])] + b[n, gi].tolist())
                picks.append(base + gi)
        if dets:
            order = np.argsort(-np.asarray([d[1] for d in dets]))
            if keep_top_k > -1:
                order = order[:keep_top_k]
            dets = np.asarray(dets, np.float32)[order]
            picks = np.asarray(picks, np.int64)[order]
        else:
            dets = np.zeros((0, 6), np.float32)
            picks = np.zeros((0,), np.int64)
        all_dets.append(dets)
        all_picks.append(picks)
        per_img.append(len(dets))
        base += b.shape[1]
    dets = np.concatenate(all_dets) if all_dets else \
        np.zeros((0, 6), np.float32)
    picks = np.concatenate(all_picks) if all_picks else \
        np.zeros((0,), np.int64)
    dev = _device(bboxes)
    return _like(bboxes, torch.from_numpy(dets).to(dev),
                 torch.from_numpy(picks).to(dev),
                 torch.as_tensor(per_img, dtype=torch.int32).to(dev))


def roi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0, name=None):
    """RoI max pooling over quantized bins (the pre-RoIAlign head).  The
    bins' edges are computed on the host from the boxes (one copy), as
    in the JAX function, and each bin's max is a device op; an empty bin
    is 0."""
    xv = _t(x)
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    ph, pw = output_size
    n, c, h, w = xv.shape
    bn = _host(boxes_num)
    img_of_box = np.repeat(np.arange(len(bn)), bn)
    bx_np = _host(boxes)
    outs = []
    for bi in range(bx_np.shape[0]):
        img = int(img_of_box[bi]) if len(img_of_box) else 0
        x1, y1, x2, y2 = [v * spatial_scale for v in bx_np[bi]]
        x1, y1 = int(np.round(x1)), int(np.round(y1))
        x2, y2 = int(np.round(x2)), int(np.round(y2))
        rh = max(y2 - y1 + 1, 1)
        rw = max(x2 - x1 + 1, 1)
        bins = []
        for i in range(ph):
            for j in range(pw):
                ys = y1 + int(np.floor(i * rh / ph))
                ye = y1 + int(np.ceil((i + 1) * rh / ph))
                xs = x1 + int(np.floor(j * rw / pw))
                xe = x1 + int(np.ceil((j + 1) * rw / pw))
                ys, ye = np.clip([ys, ye], 0, h)
                xs, xe = np.clip([xs, xe], 0, w)
                if ye <= ys or xe <= xs:
                    bins.append(xv.new_zeros((c,)))
                else:
                    bins.append(xv[img, :, ys:ye, xs:xe].amax(dim=(1, 2)))
        outs.append(torch.stack(bins, dim=1).reshape(c, ph, pw))
    out = torch.stack(outs) if outs else xv.new_zeros((0, c, ph, pw))
    return _like(x, out)


class RoIPool(Layer):
    """The layer form of ``roi_pool``."""

    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self._output_size = output_size
        self._spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return roi_pool(x, boxes, boxes_num, self._output_size,
                        self._spatial_scale)


def matrix_nms(bboxes, scores, score_threshold, post_threshold=0.0,
               nms_top_k=400, keep_top_k=200, use_gaussian=False,
               gaussian_sigma=2.0, background_label=0, normalized=True,
               return_index=False, return_rois_num=True, name=None):
    """Matrix NMS (SOLOv2): soft suppression by the decay matrix, the JAX
    function's host numpy after one copy of boxes ``[N, M, 4]`` and
    scores ``[N, C, M]``; results on the boxes' device."""
    bx, sc = _host_pair(bboxes, scores)
    all_out, all_idx, rois_num = [], [], []
    n, cnum, m = sc.shape
    for b in range(n):
        dets, idxs = [], []
        for c in range(cnum):
            if c == background_label:
                continue
            s = sc[b, c]
            keep = np.where(s > score_threshold)[0]
            if keep.size == 0:
                continue
            order = keep[np.argsort(-s[keep])][:nms_top_k]
            boxes_c = bx[b, order]
            scores_c = s[order]
            x1 = np.maximum(boxes_c[:, None, 0], boxes_c[None, :, 0])
            y1 = np.maximum(boxes_c[:, None, 1], boxes_c[None, :, 1])
            x2 = np.minimum(boxes_c[:, None, 2], boxes_c[None, :, 2])
            y2 = np.minimum(boxes_c[:, None, 3], boxes_c[None, :, 3])
            ext = 0.0 if normalized else 1.0
            iw = np.clip(x2 - x1 + ext, 0, None)
            ih = np.clip(y2 - y1 + ext, 0, None)
            inter = iw * ih
            area = ((boxes_c[:, 2] - boxes_c[:, 0] + ext)
                    * (boxes_c[:, 3] - boxes_c[:, 1] + ext))
            iou = inter / np.maximum(area[:, None] + area[None, :] - inter,
                                     1e-10)
            iou = np.triu(iou, k=1)
            comp = iou.max(axis=0)
            # decay_ij = f(iou_ij) / f(comp_i)
            if use_gaussian:
                decay = np.exp(-(iou ** 2 - comp[:, None] ** 2)
                               / gaussian_sigma)
            else:
                decay = (1 - iou) / np.maximum(1 - comp[:, None], 1e-10)
            decay = np.where(np.triu(np.ones_like(iou), k=1) > 0, decay,
                             np.inf).min(axis=0)
            decay[0] = 1.0
            new_scores = scores_c * decay
            ok = new_scores > post_threshold
            for t in np.where(ok)[0]:
                dets.append([c, new_scores[t], *boxes_c[t]])
                idxs.append(b * m + order[t])
        dets = np.asarray(dets, np.float32).reshape(-1, 6)
        idxs = np.asarray(idxs, np.int64)
        if dets.shape[0] > keep_top_k:
            top = np.argsort(-dets[:, 1])[:keep_top_k]
            dets, idxs = dets[top], idxs[top]
        all_out.append(dets)
        all_idx.append(idxs)
        rois_num.append(dets.shape[0])
    dev = _device(bboxes)
    out = torch.from_numpy(np.concatenate(all_out) if all_out else
                           np.zeros((0, 6), np.float32)).to(dev)
    ret = [out]
    if return_rois_num:
        ret.append(torch.as_tensor(rois_num, dtype=torch.int32).to(dev))
    if return_index:
        ret.append(torch.from_numpy(np.concatenate(all_idx) if all_idx else
                                    np.zeros((0,), np.int64)).to(dev))
    return _like(bboxes, *ret)


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, pixel_offset=False,
                             rois_num=None, name=None):
    """Route each RoI to its FPN level by ``sqrt(area) / refer_scale``:
    (per-level RoIs, the restore index[, per-level per-image counts]).
    The levels are computed on the device and read once."""
    rois = _t(fpn_rois)
    off = 1.0 if pixel_offset else 0.0
    ws = rois[:, 2] - rois[:, 0] + off
    hs = rois[:, 3] - rois[:, 1] + off
    scale = torch.sqrt((ws * hs).clamp(min=0))
    lvl = torch.floor(torch.log2(scale / refer_scale + 1e-8)) + refer_level
    lvl = _host(lvl.clamp(min_level, max_level)).astype(np.int64)
    n_levels = max_level - min_level + 1
    dev = rois.device
    outs, out_nums, order = [], [], []
    rn = None if rois_num is None else _host(rois_num)
    for L in range(min_level, min_level + n_levels):
        idx = np.where(lvl == L)[0]
        outs.append(_like(fpn_rois, rois[torch.as_tensor(idx, device=dev)]))
        order.append(idx)
        if rn is not None:
            img_of = np.repeat(np.arange(len(rn)), rn)
            out_nums.append(_like(fpn_rois, torch.from_numpy(np.bincount(
                img_of[idx], minlength=len(rn)).astype(np.int32)).to(dev)))
    restore = np.argsort(np.concatenate(order)) if order else \
        np.zeros((0,), np.int64)
    restore = _like(fpn_rois, torch.from_numpy(
        restore.astype(np.int32)).to(dev))
    if rois_num is not None:
        return outs, restore, out_nums
    return outs, restore


def generate_proposals(scores, bbox_deltas, img_size, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0,
                       pixel_offset=False, return_rois_num=False,
                       name=None):
    """RPN proposals: per image, the ``pre_nms_top_n`` best anchors
    decoded with their deltas, clipped to the image, filtered by
    ``min_size`` and NMS'd (``nms``) to ``post_nms_top_n``, on the
    scores' device.  The JAX function's sort is numpy's (not stable):
    inputs with tied scores may order them otherwise."""
    sc = _t(scores)
    dev = sc.device
    bd = _t(bbox_deltas, dev)
    im = _host(img_size)
    an = _t(anchors, dev).reshape(-1, 4)
    va = _t(variances, dev).reshape(-1, 4)
    n, a, h, w = sc.shape
    off = 1.0 if pixel_offset else 0.0
    rois_out, num_out, scores_out = [], [], []
    for i in range(n):
        s = sc[i].permute(1, 2, 0).reshape(-1)
        d = bd[i].reshape(a, 4, h, w).permute(2, 3, 0, 1).reshape(-1, 4)
        order = torch.argsort(-s, stable=True)[:pre_nms_top_n]
        s, d, anc, var = s[order], d[order], an[order], va[order]
        aw = anc[:, 2] - anc[:, 0] + off
        ah = anc[:, 3] - anc[:, 1] + off
        acx = anc[:, 0] + aw * 0.5
        acy = anc[:, 1] + ah * 0.5
        cx = var[:, 0] * d[:, 0] * aw + acx
        cy = var[:, 1] * d[:, 1] * ah + acy
        bw = aw * torch.exp(torch.clamp(var[:, 2] * d[:, 2], max=10.0))
        bh = ah * torch.exp(torch.clamp(var[:, 3] * d[:, 3], max=10.0))
        H, W = float(im[i][0]), float(im[i][1])
        props = torch.stack([
            (cx - bw * 0.5).clamp(0, W - off),
            (cy - bh * 0.5).clamp(0, H - off),
            (cx + bw * 0.5 - off).clamp(0, W - off),
            (cy + bh * 0.5 - off).clamp(0, H - off)], 1)
        keep = torch.nonzero((props[:, 2] - props[:, 0] + off >= min_size)
                             & (props[:, 3] - props[:, 1] + off >= min_size)
                             )[:, 0]
        props, s = props[keep], s[keep]
        sel = nms(props.float(), iou_threshold=nms_thresh,
                  scores=s.float(), top_k=post_nms_top_n)
        rois_out.append(props[sel])
        scores_out.append(s[sel].reshape(-1, 1))
        num_out.append(len(sel))
    rois = torch.cat(rois_out).float()
    rscores = torch.cat(scores_out).float()
    if return_rois_num:
        return _like(scores, rois, rscores,
                     torch.as_tensor(num_out, dtype=torch.int32).to(dev))
    return _like(scores, rois, rscores)


def read_file(filename, name=None):
    """A file's bytes as a uint8 Tensor (on the current place)."""
    with open(filename, "rb") as f:
        data = f.read()
    return Tensor(np.frombuffer(data, np.uint8).copy())


def decode_jpeg(x, mode="unchanged", name=None):
    """Decode a JPEG byte tensor to CHW uint8 with PIL or cv2 (an
    ``ImportError`` when neither is installed — no silent wrong pixels)."""
    data = bytes(_host(x).astype(np.uint8).tobytes())
    import io as _io
    try:
        from PIL import Image
        img = Image.open(_io.BytesIO(data))
        if mode == "gray":
            img = img.convert("L")
        elif mode in ("rgb", "unchanged"):
            img = img.convert("RGB") if mode == "rgb" else img
        arr = np.asarray(img)
    except ImportError:
        try:
            import cv2
            flag = {"gray": cv2.IMREAD_GRAYSCALE,
                    "rgb": cv2.IMREAD_COLOR}.get(mode, cv2.IMREAD_UNCHANGED)
            arr = cv2.imdecode(np.frombuffer(data, np.uint8), flag)
            if arr.ndim == 3:
                arr = arr[..., ::-1]   # cv2 decodes BGR; match PIL's RGB
        except ImportError as e:
            raise ImportError(
                "decode_jpeg needs PIL or cv2 installed") from e
    if arr.ndim == 2:
        arr = arr[None]
    else:
        arr = arr.transpose(2, 0, 1)
    return Tensor(np.ascontiguousarray(arr))


def yolo_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
              ignore_thresh, downsample_ratio, gt_score=None,
              use_label_smooth=True, name=None, scale_x_y=1.0):
    """The YOLOv3 loss of ONE head (``models.yolo.yolo_head_loss``):
    ``[N]``."""
    from .models.yolo import yolo_head_loss
    return yolo_head_loss(x, gt_box, gt_label, anchors, anchor_mask,
                          class_num, ignore_thresh, downsample_ratio,
                          gt_score, use_label_smooth, scale_x_y)
