"""Image transforms as functions (``paddle_tpu.vision.transforms.functional``
counterpart): host-side numpy, the JAX module's lines op for op, so that
the same array gives the same bytes.

An image is an HWC numpy array, a PIL image (read through ``np.asarray``)
or, for ``to_tensor``'s output, the port's ``Tensor``.  ``to_tensor``
returns a ``Tensor`` over a CPU torch tensor: a ``DataLoader``'s collate
and the pinned prefetcher (``io/prefetch.py``) move it to the card.
``normalize`` keeps a ``Tensor`` a ``Tensor``; ``erase`` writes into a
CHW ``Tensor`` on its own device.  Nothing here needs PIL."""
from __future__ import annotations

import numbers

import numpy as np
import torch

from ...core.tensor import Tensor


def _to_numpy(img):
    if isinstance(img, Tensor):
        return img.numpy()
    if isinstance(img, np.ndarray):
        return img
    # PIL image
    return np.asarray(img)


def _is_pil(img):
    return not isinstance(img, (np.ndarray, Tensor))


def to_tensor(pic, data_format="CHW"):
    arr = _to_numpy(pic)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.dtype == np.uint8:
        arr = arr.astype("float32") / 255.0
    else:
        arr = arr.astype("float32")
    if data_format == "CHW":
        arr = arr.transpose(2, 0, 1)
    return Tensor._wrap(torch.from_numpy(np.ascontiguousarray(arr)))


def resize(img, size, interpolation="bilinear"):
    arr = _to_numpy(img)
    squeeze = arr.ndim == 2
    if squeeze:
        arr = arr[:, :, None]
    h, w = arr.shape[:2]
    if isinstance(size, int):
        if h < w:
            nh, nw = size, int(size * w / h)
        else:
            nh, nw = int(size * h / w), size
    else:
        nh, nw = size
    ys = np.clip((np.arange(nh) + 0.5) * h / nh - 0.5, 0, h - 1)
    xs = np.clip((np.arange(nw) + 0.5) * w / nw - 0.5, 0, w - 1)
    if interpolation == "nearest":
        out = arr[np.round(ys).astype(int)][:, np.round(xs).astype(int)]
    else:  # bilinear
        y0 = np.floor(ys).astype(int)
        x0 = np.floor(xs).astype(int)
        y1 = np.minimum(y0 + 1, h - 1)
        x1 = np.minimum(x0 + 1, w - 1)
        wy = (ys - y0)[:, None, None]
        wx = (xs - x0)[None, :, None]
        a = arr.astype("float64")
        out = (a[y0][:, x0] * (1 - wy) * (1 - wx) + a[y0][:, x1] * (1 - wy) * wx +
               a[y1][:, x0] * wy * (1 - wx) + a[y1][:, x1] * wy * wx)
        if arr.dtype == np.uint8:
            out = np.clip(np.round(out), 0, 255)
        out = out.astype(arr.dtype)
    return out[:, :, 0] if squeeze else out


def crop(img, top, left, height, width):
    arr = _to_numpy(img)
    return arr[top:top + height, left:left + width]


def center_crop(img, output_size):
    arr = _to_numpy(img)
    if isinstance(output_size, numbers.Number):
        output_size = (int(output_size), int(output_size))
    h, w = arr.shape[:2]
    th, tw = output_size
    top = int(round((h - th) / 2.0))
    left = int(round((w - tw) / 2.0))
    return crop(arr, top, left, th, tw)


def hflip(img):
    return _to_numpy(img)[:, ::-1]


def vflip(img):
    return _to_numpy(img)[::-1]


def pad(img, padding, fill=0, padding_mode="constant"):
    arr = _to_numpy(img)
    if isinstance(padding, int):
        padding = (padding, padding, padding, padding)
    if len(padding) == 2:
        padding = (padding[0], padding[1], padding[0], padding[1])
    left, top, right, bottom = padding
    pads = [(top, bottom), (left, right)] + [(0, 0)] * (arr.ndim - 2)
    if padding_mode == "constant":
        return np.pad(arr, pads, mode="constant", constant_values=fill)
    return np.pad(arr, pads, mode={"edge": "edge", "reflect": "reflect",
                                   "symmetric": "symmetric"}[padding_mode])


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    arr = _to_numpy(img).astype("float32")
    mean = np.asarray(mean, "float32")
    std = np.asarray(std, "float32")
    if data_format == "CHW":
        arr = (arr - mean[:, None, None]) / std[:, None, None]
    else:
        arr = (arr - mean) / std
    if isinstance(img, Tensor):  # keep the ToTensor → Normalize chain tensor
        return Tensor._wrap(torch.from_numpy(np.ascontiguousarray(arr)))
    return arr


def rotate(img, angle, interpolation="nearest", expand=False, center=None,
           fill=0):
    arr = _to_numpy(img)
    squeeze = arr.ndim == 2
    if squeeze:
        arr = arr[:, :, None]
    h, w = arr.shape[:2]
    cy, cx = ((h - 1) / 2.0, (w - 1) / 2.0) if center is None else \
        (center[1], center[0])
    rad = np.deg2rad(angle)
    cos, sin = np.cos(rad), np.sin(rad)
    if expand:
        # canvas that contains the rotated corners (PIL expand semantics)
        oh = int(np.ceil(abs(h * cos) + abs(w * sin) - 1e-7))
        ow = int(np.ceil(abs(w * cos) + abs(h * sin) - 1e-7))
        ocy, ocx = (oh - 1) / 2.0, (ow - 1) / 2.0
    else:
        oh, ow, ocy, ocx = h, w, cy, cx
    yy, xx = np.meshgrid(np.arange(oh), np.arange(ow), indexing="ij")
    ys = cos * (yy - ocy) - sin * (xx - ocx) + cy
    xs = sin * (yy - ocy) + cos * (xx - ocx) + cx
    out = np.full((oh, ow, arr.shape[2]), fill, dtype=arr.dtype)
    if interpolation == "bilinear":
        y0 = np.floor(ys).astype(int)
        x0 = np.floor(xs).astype(int)
        wy = (ys - y0)[..., None]
        wx = (xs - x0)[..., None]

        def at(yi, xi):
            inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            v = arr[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)].astype(
                "float64")
            return np.where(inb[..., None], v, float(fill))

        res = (at(y0, x0) * (1 - wy) * (1 - wx) + at(y0, x0 + 1) * (1 - wy) * wx +
               at(y0 + 1, x0) * wy * (1 - wx) + at(y0 + 1, x0 + 1) * wy * wx)
        if arr.dtype == np.uint8:
            res = np.clip(np.round(res), 0, 255)
        out = res.astype(arr.dtype)
    else:
        yi = np.round(ys).astype(int)
        xi = np.round(xs).astype(int)
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        out[valid] = arr[yi[valid], xi[valid]]
    return out[:, :, 0] if squeeze else out


def to_grayscale(img, num_output_channels=1):
    arr = _to_numpy(img).astype("float32")
    gray = arr[..., 0] * 0.299 + arr[..., 1] * 0.587 + arr[..., 2] * 0.114
    gray = gray.astype(_to_numpy(img).dtype)
    if num_output_channels == 3:
        return np.stack([gray] * 3, axis=-1)
    return gray[..., None]


def adjust_brightness(img, brightness_factor):
    arr = _to_numpy(img).astype("float32") * brightness_factor
    return np.clip(arr, 0, 255).astype(_to_numpy(img).dtype)


def adjust_contrast(img, contrast_factor):
    arr = _to_numpy(img).astype("float32")
    mean = to_grayscale(arr).mean()
    out = (arr - mean) * contrast_factor + mean
    return np.clip(out, 0, 255).astype(_to_numpy(img).dtype)


def adjust_hue(img, hue_factor):
    if not -0.5 <= hue_factor <= 0.5:
        raise ValueError("hue_factor must be in [-0.5, 0.5]")
    arr = _to_numpy(img).astype("float32") / 255.0
    r, g, b = arr[..., 0], arr[..., 1], arr[..., 2]
    maxc = arr[..., :3].max(-1)
    minc = arr[..., :3].min(-1)
    v = maxc
    d = maxc - minc
    s = np.where(maxc > 0, d / np.maximum(maxc, 1e-9), 0)
    dn = np.maximum(d, 1e-9)
    h = np.where(maxc == r, (g - b) / dn % 6,
                 np.where(maxc == g, (b - r) / dn + 2, (r - g) / dn + 4)) / 6.0
    h = (h + hue_factor) % 1.0
    i = np.floor(h * 6)
    f = h * 6 - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    i = i.astype(int) % 6
    rgb = np.stack([
        np.choose(i, [v, q, p, p, t, v]),
        np.choose(i, [t, v, v, q, p, p]),
        np.choose(i, [p, p, t, v, v, q])], axis=-1)
    return np.clip(rgb * 255.0, 0, 255).astype(_to_numpy(img).dtype)


def _inverse_warp(arr, inv_fn, oh, ow, interpolation, fill):
    """Sample arr (HWC numpy) at source coords given by inv_fn(yy, xx) ->
    (ys, xs) — the shared inverse-mapping core of rotate/affine/
    perspective."""
    h, w = arr.shape[:2]
    yy, xx = np.meshgrid(np.arange(oh), np.arange(ow), indexing="ij")
    ys, xs = inv_fn(yy.astype("float64"), xx.astype("float64"))
    out = np.full((oh, ow, arr.shape[2]), fill, dtype=arr.dtype)
    if interpolation == "bilinear":
        y0 = np.floor(ys).astype(int)
        x0 = np.floor(xs).astype(int)
        wy = (ys - y0)[..., None]
        wx = (xs - x0)[..., None]

        def at(yi, xi):
            inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            v = arr[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)].astype(
                "float64")
            return np.where(inb[..., None], v, float(fill))

        res = (at(y0, x0) * (1 - wy) * (1 - wx)
               + at(y0, x0 + 1) * (1 - wy) * wx
               + at(y0 + 1, x0) * wy * (1 - wx)
               + at(y0 + 1, x0 + 1) * wy * wx)
        if arr.dtype == np.uint8:
            res = np.clip(np.round(res), 0, 255)
        out = res.astype(arr.dtype)
    else:
        yi = np.round(ys).astype(int)
        xi = np.round(xs).astype(int)
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        out[valid] = arr[yi[valid], xi[valid]]
    return out


def affine(img, angle, translate, scale, shear, interpolation="nearest",
           fill=0, center=None):
    """transforms.functional.affine: rotation+translate+scale+shear about
    `center` (default image center), inverse-warp sampled."""
    arr = _to_numpy(img)
    squeeze = arr.ndim == 2
    if squeeze:
        arr = arr[:, :, None]
    h, w = arr.shape[:2]
    cy, cx = ((h - 1) / 2.0, (w - 1) / 2.0) if center is None else \
        (center[1], center[0])
    rot = np.deg2rad(angle)
    sx, sy = [np.deg2rad(s) for s in
              (shear if isinstance(shear, (list, tuple)) else (shear, 0.0))]
    # forward matrix M = T(center+translate) R(rot) Shear S(scale) T(-center)
    a = np.cos(rot - sy) / np.cos(sy)
    b = -np.cos(rot - sy) * np.tan(sx) / np.cos(sy) - np.sin(rot)
    c = np.sin(rot - sy) / np.cos(sy)
    d = -np.sin(rot - sy) * np.tan(sx) / np.cos(sy) + np.cos(rot)
    M = np.array([[d, -b], [-c, a]]) / (a * d - b * c) / scale  # inverse
    ty, tx = translate[1], translate[0]

    def inv(yy, xx):
        dy = yy - cy - ty
        dx = xx - cx - tx
        ys = M[0, 0] * dy + M[0, 1] * dx + cy
        xs = M[1, 0] * dy + M[1, 1] * dx + cx
        return ys, xs

    out = _inverse_warp(arr, inv, h, w, interpolation, fill)
    return out[:, :, 0] if squeeze else out


def perspective(img, startpoints, endpoints, interpolation="nearest",
                fill=0):
    """transforms.functional.perspective: maps the quad `startpoints` to
    `endpoints` (4 [x, y] pairs) and warps accordingly."""
    arr = _to_numpy(img)
    squeeze = arr.ndim == 2
    if squeeze:
        arr = arr[:, :, None]
    h, w = arr.shape[:2]
    # solve the 8-dof homography taking endpoints -> startpoints (inverse
    # map, so output pixels sample from the source quad)
    A, bvec = [], []
    for (dx, dy), (sx_, sy_) in zip(endpoints, startpoints):
        A.append([dx, dy, 1, 0, 0, 0, -sx_ * dx, -sx_ * dy])
        bvec.append(sx_)
        A.append([0, 0, 0, dx, dy, 1, -sy_ * dx, -sy_ * dy])
        bvec.append(sy_)
    coef = np.linalg.solve(np.asarray(A, "float64"),
                           np.asarray(bvec, "float64"))
    Hm = np.append(coef, 1.0).reshape(3, 3)

    def inv(yy, xx):
        den = Hm[2, 0] * xx + Hm[2, 1] * yy + Hm[2, 2]
        xs = (Hm[0, 0] * xx + Hm[0, 1] * yy + Hm[0, 2]) / den
        ys = (Hm[1, 0] * xx + Hm[1, 1] * yy + Hm[1, 2]) / den
        return ys, xs

    out = _inverse_warp(arr, inv, h, w, interpolation, fill)
    return out[:, :, 0] if squeeze else out


def erase(img, i, j, h, w, v, inplace=False):
    """transforms.functional.erase: overwrite the [i:i+h, j:j+w] patch
    with value(s) v.  Accepts HWC numpy/PIL or CHW Tensor like the
    reference."""
    if isinstance(img, Tensor):
        val = img._value
        v_t = torch.as_tensor(np.asarray(v), dtype=val.dtype,
                              device=val.device)
        if v_t.ndim == 1:      # per-channel fill on the CHW layout
            v_t = v_t.reshape(-1, 1, 1)
        patch = torch.broadcast_to(v_t, (val.shape[0], h, w))
        out = val.clone()
        out[:, i:i + h, j:j + w] = patch
        if inplace:
            img._rebind(out)
            return img
        return Tensor._wrap(out)
    arr = _to_numpy(img).copy()
    v_arr = np.asarray(v, arr.dtype)
    if v_arr.ndim == 1:       # per-channel fill
        v_arr = v_arr.reshape(1, 1, -1)
    arr[i:i + h, j:j + w] = v_arr   # scalar / [C] / [h, w, C] all broadcast
    return arr
