"""Vision of the port (``paddle_tpu.vision`` counterpart): the models and
the detection ops."""
from . import models, ops

__all__ = ["models", "ops"]
