"""paddle.callbacks namespace parity (re-exports the hapi callbacks)."""
from .hapi.callbacks import (  # noqa: F401
    Callback, CheckpointCallback, EarlyStopping, LRScheduler,
    ModelCheckpoint, ProgBarLogger, ReduceLROnPlateau, TelemetryCallback,
    VisualDL,
)
