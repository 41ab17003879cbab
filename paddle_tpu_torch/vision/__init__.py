"""Vision of the port (``paddle_tpu.vision`` counterpart): the model zoo
(``vision/models``), the detection ops (``vision/ops``), the transforms
(``vision/transforms``, host-side numpy), the datasets (``vision/datasets``,
the JAX modules' copies over the port's ``io.Dataset``) and the image
backend switch.  As in the JAX package, the models', datasets' and
transforms' public names are also bound here."""
from . import datasets  # noqa: F401
from . import models  # noqa: F401
from . import ops  # noqa: F401
from . import transforms  # noqa: F401
from .models import *  # noqa: F401,F403
from .datasets import *  # noqa: F401,F403
from .transforms import *  # noqa: F401,F403
# the star imports above bind the inner ``transforms/transforms.py`` over
# the package of that name; rebind the packages from sys.modules
import sys as _sys  # noqa: E402

datasets = _sys.modules[__name__ + ".datasets"]
models = _sys.modules[__name__ + ".models"]
transforms = _sys.modules[__name__ + ".transforms"]


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
