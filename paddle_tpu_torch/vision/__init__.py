"""Vision models of the port (``paddle_tpu.vision`` counterpart)."""
from . import models

__all__ = ["models"]
