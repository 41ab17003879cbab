"""Vision of the port (``paddle_tpu.vision`` counterpart): the models,
the detection ops, the datasets (``vision/datasets``, the JAX modules'
copies over the port's ``io.Dataset``) and the image backend switch."""
from . import datasets, models, ops  # noqa: F401
from .datasets import *  # noqa: F401,F403

__all__ = ["models", "ops", "datasets", "set_image_backend",
           "get_image_backend", "image_load", "DatasetFolder", "ImageFolder",
           "MNIST", "FashionMNIST", "Cifar10", "Cifar100", "FakeData",
           "Flowers", "VOC2012"]


def set_image_backend(backend):
    if backend not in ("pil", "cv2", "tensor"):
        raise ValueError(f"unknown image backend {backend!r}")
    global _image_backend
    _image_backend = backend


def get_image_backend():
    return _image_backend


_image_backend = "pil"


def image_load(path, backend=None):
    """vision/image.py image_load: decode via the configured backend."""
    from .datasets.folder import default_loader
    try:
        return default_loader(path)
    except Exception:
        from ..dataset.image import load_image
        return load_image(path)
