"""Image transforms of the port (``paddle_tpu.vision.transforms``
counterpart): host-side numpy, see ``functional`` and ``transforms``."""
from .functional import (  # noqa: F401
    adjust_brightness, adjust_contrast, adjust_hue, affine, center_crop,
    crop, erase, hflip, normalize, pad, perspective, resize, rotate,
    to_grayscale, to_tensor, vflip,
)
from .transforms import (  # noqa: F401
    BaseTransform, BrightnessTransform, CenterCrop, ColorJitter, Compose,
    ContrastTransform, Grayscale, HueTransform, Normalize, Pad, RandomCrop,
    RandomHorizontalFlip, RandomResizedCrop, RandomRotation, RandomVerticalFlip,
    RandomAffine, RandomErasing, RandomPerspective, Resize,
    SaturationTransform, ToTensor, Transpose,
)
