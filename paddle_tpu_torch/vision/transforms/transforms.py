"""Composable image transforms (``paddle_tpu.vision.transforms.transforms``
counterpart) over numpy / PIL inputs, the JAX module's classes line for
line.  The random ones draw from Python's ``random`` (the crops, flips,
rotations and colour jitter) and from ``np.random`` (``RandomAffine``,
``RandomPerspective``, ``RandomErasing``), as the JAX ones do: with the
same seeds both packages give the same draws and the same bytes."""
from __future__ import annotations

import numbers
import random

import numpy as np

from . import functional as F


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


class BaseTransform:
    """Reference BaseTransform: keys select which inputs are transformed; the
    simple single-image form is what the zoo uses."""

    def __init__(self, keys=None):
        self.keys = keys

    def __call__(self, inputs):
        return self._apply_image(inputs)

    def _apply_image(self, img):
        raise NotImplementedError


class ToTensor(BaseTransform):
    def __init__(self, data_format="CHW", keys=None):
        super().__init__(keys)
        self.data_format = data_format

    def _apply_image(self, img):
        return F.to_tensor(img, self.data_format)


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear", keys=None):
        super().__init__(keys)
        self.size = size
        self.interpolation = interpolation

    def _apply_image(self, img):
        return F.resize(img, self.size, self.interpolation)


class RandomResizedCrop(BaseTransform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3. / 4, 4. / 3),
                 interpolation="bilinear", keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, int) else size
        self.scale = scale
        self.ratio = ratio
        self.interpolation = interpolation

    def _apply_image(self, img):
        arr = img if isinstance(img, np.ndarray) else np.asarray(img)
        h, w = arr.shape[:2]
        area = h * w
        for _ in range(10):
            target_area = random.uniform(*self.scale) * area
            aspect = np.exp(random.uniform(np.log(self.ratio[0]),
                                           np.log(self.ratio[1])))
            cw = int(round(np.sqrt(target_area * aspect)))
            ch = int(round(np.sqrt(target_area / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                top = random.randint(0, h - ch)
                left = random.randint(0, w - cw)
                patch = F.crop(arr, top, left, ch, cw)
                return F.resize(patch, self.size, self.interpolation)
        return F.resize(F.center_crop(arr, min(h, w)), self.size,
                        self.interpolation)


class CenterCrop(BaseTransform):
    def __init__(self, size, keys=None):
        super().__init__(keys)
        self.size = size

    def _apply_image(self, img):
        return F.center_crop(img, self.size)


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, pad_if_needed=False, fill=0,
                 padding_mode="constant", keys=None):
        super().__init__(keys)
        if isinstance(size, numbers.Number):
            size = (int(size), int(size))
        self.size = size
        self.padding = padding
        self.pad_if_needed = pad_if_needed
        self.fill = fill
        self.padding_mode = padding_mode

    def _apply_image(self, img):
        arr = img if isinstance(img, np.ndarray) else np.asarray(img)
        if self.padding is not None:
            arr = F.pad(arr, self.padding, self.fill, self.padding_mode)
        h, w = arr.shape[:2]
        th, tw = self.size
        if self.pad_if_needed and (h < th or w < tw):
            arr = F.pad(arr, (max(tw - w, 0), max(th - h, 0)), self.fill,
                        self.padding_mode)
            h, w = arr.shape[:2]
        top = random.randint(0, h - th)
        left = random.randint(0, w - tw)
        return F.crop(arr, top, left, th, tw)


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def _apply_image(self, img):
        if random.random() < self.prob:
            return F.hflip(img)
        return img if isinstance(img, np.ndarray) else np.asarray(img)


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def _apply_image(self, img):
        if random.random() < self.prob:
            return F.vflip(img)
        return img if isinstance(img, np.ndarray) else np.asarray(img)


class RandomRotation(BaseTransform):
    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0, keys=None):
        super().__init__(keys)
        if isinstance(degrees, numbers.Number):
            degrees = (-degrees, degrees)
        self.degrees = degrees
        self.interpolation = interpolation
        self.expand = expand
        self.center = center
        self.fill = fill

    def _apply_image(self, img):
        angle = random.uniform(*self.degrees)
        return F.rotate(img, angle, self.interpolation, self.expand,
                        self.center, self.fill)


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False,
                 keys=None):
        super().__init__(keys)
        if isinstance(mean, numbers.Number):
            mean = [mean, mean, mean]
        if isinstance(std, numbers.Number):
            std = [std, std, std]
        self.mean = mean
        self.std = std
        self.data_format = data_format
        self.to_rgb = to_rgb

    def _apply_image(self, img):
        return F.normalize(img, self.mean, self.std, self.data_format,
                           self.to_rgb)


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1), keys=None):
        super().__init__(keys)
        self.order = order

    def _apply_image(self, img):
        arr = img if isinstance(img, np.ndarray) else np.asarray(img)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return arr.transpose(self.order)


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode="constant", keys=None):
        super().__init__(keys)
        self.padding = padding
        self.fill = fill
        self.padding_mode = padding_mode

    def _apply_image(self, img):
        return F.pad(img, self.padding, self.fill, self.padding_mode)


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1, keys=None):
        super().__init__(keys)
        self.num_output_channels = num_output_channels

    def _apply_image(self, img):
        return F.to_grayscale(img, self.num_output_channels)


class BrightnessTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img if isinstance(img, np.ndarray) else np.asarray(img)
        factor = random.uniform(max(0, 1 - self.value), 1 + self.value)
        return F.adjust_brightness(img, factor)


class ContrastTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        if value < 0:
            raise ValueError("contrast value should be non-negative")
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img if isinstance(img, np.ndarray) else np.asarray(img)
        factor = random.uniform(max(0, 1 - self.value), 1 + self.value)
        return F.adjust_contrast(img, factor)


class SaturationTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img if isinstance(img, np.ndarray) else np.asarray(img)
        factor = random.uniform(max(0, 1 - self.value), 1 + self.value)
        arr = np.asarray(img).astype("float32")
        gray = F.to_grayscale(arr, 3).astype("float32")
        out = arr * factor + gray * (1 - factor)
        return np.clip(out, 0, 255).astype(np.asarray(img).dtype)


class HueTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        if not 0 <= value <= 0.5:
            raise ValueError("hue value should be in [0, 0.5]")
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img if isinstance(img, np.ndarray) else np.asarray(img)
        factor = random.uniform(-self.value, self.value)
        return F.adjust_hue(img, factor)


class ColorJitter(BaseTransform):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0,
                 keys=None):
        super().__init__(keys)
        self.transforms = []
        if brightness:
            self.transforms.append(BrightnessTransform(brightness))
        if contrast:
            self.transforms.append(ContrastTransform(contrast))
        if saturation:
            self.transforms.append(SaturationTransform(saturation))
        if hue:
            self.transforms.append(HueTransform(hue))

    def _apply_image(self, img):
        order = list(self.transforms)
        random.shuffle(order)
        for t in order:
            img = t(img)
        return img


class RandomAffine(BaseTransform):
    """transforms.RandomAffine: random rotation/translate/scale/shear
    drawn per call, applied via functional.affine."""

    def __init__(self, degrees, translate=None, scale=None, shear=None,
                 interpolation="nearest", fill=0, center=None, keys=None):
        super().__init__(keys)
        self.degrees = (-degrees, degrees) if np.isscalar(degrees) \
            else tuple(degrees)
        self.translate = translate
        self.scale = scale
        self.shear = shear
        self.interpolation = interpolation
        self.fill = fill
        self.center = center

    def _apply_image(self, img):
        angle = np.random.uniform(*self.degrees)
        h, w = F._to_numpy(img).shape[:2]
        if self.translate is not None:
            tx = np.random.uniform(-self.translate[0], self.translate[0]) * w
            ty = np.random.uniform(-self.translate[1], self.translate[1]) * h
        else:
            tx = ty = 0.0
        scale = np.random.uniform(*self.scale) if self.scale else 1.0
        if self.shear is None:
            shear = (0.0, 0.0)
        elif np.isscalar(self.shear):
            shear = (np.random.uniform(-self.shear, self.shear), 0.0)
        else:
            sh = list(self.shear) + [0.0] * (4 - len(list(self.shear)))
            shear = (np.random.uniform(sh[0], sh[1]),
                     np.random.uniform(sh[2], sh[3]))
        return F.affine(img, angle, (tx, ty), scale, shear,
                         self.interpolation, self.fill, self.center)


class RandomPerspective(BaseTransform):
    """transforms.RandomPerspective: with probability `prob`, move each
    corner inward by up to distortion_scale of the half-extent."""

    def __init__(self, prob=0.5, distortion_scale=0.5,
                 interpolation="nearest", fill=0, keys=None):
        super().__init__(keys)
        self.prob = prob
        self.distortion_scale = distortion_scale
        self.interpolation = interpolation
        self.fill = fill

    def _apply_image(self, img):
        if np.random.rand() >= self.prob:
            return img
        h, w = F._to_numpy(img).shape[:2]
        dx = int(self.distortion_scale * w / 2)
        dy = int(self.distortion_scale * h / 2)
        start = [[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]]
        rnd = lambda a: int(np.random.randint(0, a + 1)) if a > 0 else 0
        end = [[rnd(dx), rnd(dy)],
               [w - 1 - rnd(dx), rnd(dy)],
               [w - 1 - rnd(dx), h - 1 - rnd(dy)],
               [rnd(dx), h - 1 - rnd(dy)]]
        return F.perspective(img, start, end, self.interpolation,
                              self.fill)


class RandomErasing(BaseTransform):
    """transforms.RandomErasing: erase a random patch with `value` (or
    random noise when value == "random")."""

    def __init__(self, prob=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3),
                 value=0, inplace=False, keys=None):
        super().__init__(keys)
        if not (0 <= prob <= 1):
            raise ValueError("prob should be in [0, 1]")
        self.prob = prob
        self.scale = scale
        self.ratio = ratio
        self.value = value
        self.inplace = inplace

    def _apply_image(self, img):
        if np.random.rand() >= self.prob:
            return img
        arr_like = F._to_numpy(img) if not hasattr(img, "_value") else None
        if arr_like is not None:
            h, w, c = arr_like.shape if arr_like.ndim == 3 else (
                *arr_like.shape, 1)
        else:
            c, h, w = img.shape
        area = h * w
        for _ in range(10):
            target = np.random.uniform(*self.scale) * area
            aspect = np.exp(np.random.uniform(np.log(self.ratio[0]),
                                              np.log(self.ratio[1])))
            eh = int(round(np.sqrt(target * aspect)))
            ew = int(round(np.sqrt(target / aspect)))
            if eh < h and ew < w:
                i = np.random.randint(0, h - eh + 1)
                j = np.random.randint(0, w - ew + 1)
                if self.value == "random":
                    v = np.random.standard_normal((eh, ew, c) if
                                                  arr_like is not None
                                                  else (c, eh, ew))
                    if arr_like is not None and arr_like.dtype == np.uint8:
                        v = np.clip(v * 64 + 128, 0, 255)
                else:
                    v = self.value
                return F.erase(img, i, j, eh, ew, v, self.inplace)
        return img
