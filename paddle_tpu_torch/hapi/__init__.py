"""hapi — the Keras-like high-level API (reference: python/paddle/hapi/,
`Model` at hapi/model.py:915, callbacks at hapi/callbacks.py; the port's
copy of ``paddle_tpu/hapi``)."""
from . import callbacks  # noqa: F401
from .model import DeviceLossList, Model  # noqa: F401
from .summary import summary  # noqa: F401
