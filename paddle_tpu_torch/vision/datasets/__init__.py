"""paddle.vision.datasets of the port: the JAX package's
``paddle_tpu/vision/datasets`` modules, copied over the port's
``io.Dataset`` (parity with python/paddle/vision/datasets/).

No-egress build: datasets load from LOCAL files (pass `image_path`/
`data_file`); the download=True default of the reference raises with a clear
message instead of fetching.  `FakeData` provides synthetic samples for
tests/smoke-training (the reference's fake reader pattern).
"""
from .folder import DatasetFolder, ImageFolder  # noqa: F401
from .mnist import MNIST, FashionMNIST  # noqa: F401
from .cifar import Cifar10, Cifar100  # noqa: F401
from .fake import FakeData  # noqa: F401
from .flowers import Flowers  # noqa: F401
from .voc2012 import VOC2012  # noqa: F401
