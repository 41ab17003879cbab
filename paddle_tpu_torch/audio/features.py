"""``paddle_tpu.audio.features`` counterparts: ``Spectrogram``,
``MelSpectrogram``, ``LogMelSpectrogram`` and ``MFCC``, on the input's
device.

The spectrogram follows the JAX package's framing, not ``signal.stft``'s
and not ``torch.stft``'s: with ``center`` the clip is padded by
``n_fft // 2`` on each side (``pad_mode`` a numpy name: ``"reflect"``,
``"constant"``, ``"edge"`` or ``"wrap"``), cut into ``1 + (T - n_fft) //
hop_length`` frames (a strided view), each multiplied by the window
(centre-padded to ``n_fft``), ``rfft``'d, ``|.| ** power`` taken with no
normalisation, and the last two axes swapped: ``[..., 1 + n_fft // 2,
frames]``.  The window, filterbank and DCT matrix are the layers'
buffers, in the layer's ``dtype`` (not in its ``state_dict``, as the JAX
layers keep none); a call moves them to the input's device.
"""
from __future__ import annotations

import torch
from torch.nn import functional as tF

from ..core import dtype as dtype_mod
from ..nn.layer_base import Layer
from ..signal import _PAD_MODES
from . import functional as AF

__all__ = ["Spectrogram", "MelSpectrogram", "LogMelSpectrogram", "MFCC"]


def _frame_stft(x, n_fft, hop_length, win, center, pad_mode, power):
    """``x`` ``[..., T]`` -> power spectrogram ``[..., 1 + n_fft // 2,
    frames]``."""
    if center:
        if pad_mode not in _PAD_MODES:
            raise ValueError(f"pad_mode {pad_mode!r} is not one of "
                             f"{sorted(_PAD_MODES)}")
        p = n_fft // 2
        lead = x.shape[:-1]
        x = tF.pad(x.reshape(-1, 1, x.shape[-1]), (p, p),
                   mode=_PAD_MODES[pad_mode]).reshape(lead + (-1,))
    frames = x.unfold(-1, n_fft, hop_length) * win   # [..., frames, n_fft]
    mag = torch.abs(torch.fft.rfft(frames, n=n_fft, dim=-1))
    if power is not None:
        mag = mag ** power
    return mag.transpose(-1, -2)


class Spectrogram(Layer):
    def __init__(self, n_fft=512, hop_length=None, win_length=None,
                 window="hann", power=2.0, center=True, pad_mode="reflect",
                 dtype="float32"):
        super().__init__()
        self.n_fft = n_fft
        self.hop_length = hop_length or n_fft // 4
        self.win_length = win_length or n_fft
        self.power = power
        self.center = center
        self.pad_mode = pad_mode
        w = AF.get_window(window, self.win_length, dtype=dtype)._value
        if self.win_length < n_fft:  # centre-pad the window to n_fft
            lpad = (n_fft - self.win_length) // 2
            w = tF.pad(w, (lpad, n_fft - self.win_length - lpad))
        self.register_buffer("_window", w.to(dtype_mod.convert_dtype(dtype)),
                             persistable=False)

    def forward(self, x):
        win = self._buffers["_window"].to(x.device)
        return _frame_stft(x, self.n_fft, self.hop_length, win, self.center,
                           self.pad_mode, self.power).to(x.dtype)


class MelSpectrogram(Layer):
    def __init__(self, sr=22050, n_fft=512, hop_length=None, win_length=None,
                 window="hann", power=2.0, center=True, pad_mode="reflect",
                 n_mels=64, f_min=50.0, f_max=None, htk=False, norm="slaney",
                 dtype="float32"):
        super().__init__()
        self._spectrogram = Spectrogram(n_fft, hop_length, win_length,
                                        window, power, center, pad_mode,
                                        dtype)
        fb = AF.compute_fbank_matrix(sr, n_fft, n_mels, f_min, f_max, htk,
                                     norm, dtype)._value
        self.register_buffer("_fbank", fb, persistable=False)

    def forward(self, x):
        spec = self._spectrogram(x)
        fb = self._buffers["_fbank"].to(spec.device, spec.dtype)
        return torch.einsum("mf,...ft->...mt", fb, spec)


class LogMelSpectrogram(Layer):
    def __init__(self, sr=22050, n_fft=512, hop_length=None, win_length=None,
                 window="hann", power=2.0, center=True, pad_mode="reflect",
                 n_mels=64, f_min=50.0, f_max=None, htk=False, norm="slaney",
                 ref_value=1.0, amin=1e-10, top_db=None, dtype="float32"):
        super().__init__()
        self._melspectrogram = MelSpectrogram(
            sr, n_fft, hop_length, win_length, window, power, center,
            pad_mode, n_mels, f_min, f_max, htk, norm, dtype)
        self.ref_value = ref_value
        self.amin = amin
        self.top_db = top_db

    def forward(self, x):
        mel = self._melspectrogram(x)
        return AF.power_to_db(mel, self.ref_value, self.amin, self.top_db)


class MFCC(Layer):
    def __init__(self, sr=22050, n_mfcc=40, n_fft=512, hop_length=None,
                 win_length=None, window="hann", power=2.0, center=True,
                 pad_mode="reflect", n_mels=64, f_min=50.0, f_max=None,
                 htk=False, norm="slaney", ref_value=1.0, amin=1e-10,
                 top_db=None, dtype="float32"):
        super().__init__()
        self._log_melspectrogram = LogMelSpectrogram(
            sr, n_fft, hop_length, win_length, window, power, center,
            pad_mode, n_mels, f_min, f_max, htk, norm, ref_value, amin,
            top_db, dtype)
        dct = AF.create_dct(n_mfcc, n_mels, dtype=dtype)._value
        self.register_buffer("_dct", dct, persistable=False)

    def forward(self, x):
        logmel = self._log_melspectrogram(x)
        dct = self._buffers["_dct"].to(logmel.device, logmel.dtype)
        return torch.einsum("mk,...mt->...kt", dct, logmel)
