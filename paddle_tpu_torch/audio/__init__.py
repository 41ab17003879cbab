"""``paddle_tpu.audio`` counterpart: spectral features (``Spectrogram``,
``MelSpectrogram``, ``LogMelSpectrogram``, ``MFCC``) over ``torch.fft``
on the input's device, and ``functional``'s windows, mel scales,
filterbanks and DCT matrices."""
from . import functional  # noqa: F401
from .features import (  # noqa: F401
    LogMelSpectrogram,
    MFCC,
    MelSpectrogram,
    Spectrogram,
)
