from .auto_checkpoint import TrainEpochRange, train_epoch_range  # noqa: F401
