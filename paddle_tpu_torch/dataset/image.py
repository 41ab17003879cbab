"""paddle.dataset.image — array-level image helpers (reference
python/paddle/dataset/image.py: resize_short:201, to_chw:229,
center_crop:253, random_crop:281, left_right_flip:309,
simple_transform:331).  The reference shells out to cv2 for decode +
resize; here decode (load_image*) requires an installed cv2/PIL and the
ARRAY transforms are numpy-native so the usual pipeline works without
either when samples are already arrays."""
from __future__ import annotations

import numpy as np

__all__ = ["resize_short", "to_chw", "center_crop", "random_crop",
           "left_right_flip", "simple_transform", "load_image",
           "load_and_transform"]


def _resize(im, h, w):
    """Nearest-neighbour resize (numpy): the reference delegates to
    cv2.resize; nearest keeps this dependency-free and is exact for the
    common no-op case."""
    sh, sw = im.shape[:2]
    if (sh, sw) == (h, w):
        return im
    ri = (np.arange(h) * sh / h).astype(np.int64).clip(0, sh - 1)
    ci = (np.arange(w) * sw / w).astype(np.int64).clip(0, sw - 1)
    return im[ri][:, ci]


def resize_short(im, size):
    """Scale so the SHORTER edge equals `size` (image.py:201)."""
    h, w = im.shape[:2]
    if h > w:
        h_new, w_new = size * h // w, size
    else:
        h_new, w_new = size, size * w // h
    return _resize(im, h_new, w_new)


def to_chw(im, order=(2, 0, 1)):
    assert len(im.shape) == len(order)
    return im.transpose(order)


def center_crop(im, size, is_color=True):
    h, w = im.shape[:2]
    h_start = (h - size) // 2
    w_start = (w - size) // 2
    return im[h_start:h_start + size, w_start:w_start + size]


def random_crop(im, size, is_color=True):
    h, w = im.shape[:2]
    h_start = np.random.randint(0, h - size + 1)
    w_start = np.random.randint(0, w - size + 1)
    return im[h_start:h_start + size, w_start:w_start + size]


def left_right_flip(im, is_color=True):
    return im[:, ::-1, :] if len(im.shape) == 3 and is_color \
        else im[:, ::-1]


def simple_transform(im, resize_size, crop_size, is_train, is_color=True,
                     mean=None):
    """resize_short -> (random crop + flip | center crop) -> CHW -> float
    -> optional mean subtraction (image.py:331)."""
    im = resize_short(im, resize_size)
    if is_train:
        im = random_crop(im, crop_size, is_color=is_color)
        if np.random.randint(2) == 0:
            im = left_right_flip(im, is_color)
    else:
        im = center_crop(im, crop_size, is_color=is_color)
    if len(im.shape) == 3:
        im = to_chw(im)
    im = im.astype("float32")
    if mean is not None:
        mean = np.array(mean, dtype=np.float32)
        if mean.ndim == 1 and is_color:
            mean = mean[:, np.newaxis, np.newaxis]
        im -= mean
    return im


def load_image(file, is_color=True):
    """Decode via cv2 or PIL when available (reference requires cv2)."""
    try:
        import cv2
        flag = cv2.IMREAD_COLOR if is_color else cv2.IMREAD_GRAYSCALE
        return cv2.imread(file, flag)
    except ImportError:
        pass
    try:
        from PIL import Image
        im = Image.open(file)
        im = im.convert("RGB" if is_color else "L")
        return np.asarray(im)[..., ::-1] if is_color else np.asarray(im)
    except ImportError as e:
        raise ImportError(
            "load_image needs cv2 or PIL; neither is installed — pass "
            "decoded arrays to the transform helpers instead") from e


def load_and_transform(filename, resize_size, crop_size, is_train,
                       is_color=True, mean=None):
    return simple_transform(load_image(filename, is_color), resize_size,
                            crop_size, is_train, is_color, mean)
