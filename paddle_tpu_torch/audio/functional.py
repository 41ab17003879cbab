"""``paddle_tpu.audio.functional`` counterparts: windows, mel scales,
filterbanks, DCT matrices and ``power_to_db``.

The windows, filterbanks and DCT matrices are built in numpy in float64
(their default ``dtype``) and returned as Tensors of that dtype on the
current place: the JAX package returns them in float64 too, since it
turns ``jax_enable_x64`` on at import.  ``hz_to_mel`` and ``mel_to_hz``
return numpy, as there.  ``power_to_db``'s ``top_db`` floor is the
largest value of the whole input less ``top_db``, the whole batch's, not
each clip's, as in the JAX package.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import place as place_mod
from ..core.op import apply_op
from ..core.tensor import Tensor

__all__ = ["get_window", "hz_to_mel", "mel_to_hz", "mel_frequencies",
           "fft_frequencies", "compute_fbank_matrix", "create_dct",
           "power_to_db"]


def _tensor(arr, dtype):
    return Tensor._wrap(torch.as_tensor(
        np.ascontiguousarray(arr.astype(dtype)),
        device=place_mod.current_device()))


def get_window(window, win_length, fftbins=True, dtype="float64"):
    """hann / hamming / blackman / bohman / rect (boxcar) / gaussian /
    triang, ``win_length`` samples (periodic with ``fftbins``)."""
    if isinstance(window, tuple):
        name, *args = window
    else:
        name, args = window, []
    n = win_length
    m = n if fftbins else n - 1
    x = np.arange(n)
    if name in ("hann", "hanning"):
        w = 0.5 - 0.5 * np.cos(2 * np.pi * x / m)
    elif name == "hamming":
        w = 0.54 - 0.46 * np.cos(2 * np.pi * x / m)
    elif name == "blackman":
        w = (0.42 - 0.5 * np.cos(2 * np.pi * x / m) +
             0.08 * np.cos(4 * np.pi * x / m))
    elif name == "bohman":
        fac = np.abs(2 * x / m - 1)
        w = (1 - fac) * np.cos(np.pi * fac) + np.sin(np.pi * fac) / np.pi
    elif name == "rect" or name == "boxcar":
        w = np.ones(n)
    elif name == "gaussian":
        std = args[0] if args else 0.4 * n
        w = np.exp(-0.5 * ((x - m / 2) / std) ** 2)
    elif name == "triang":
        w = 1 - np.abs(2 * x / m - 1)
    else:
        raise ValueError(f"unknown window {name!r}")
    return _tensor(w, dtype)


def hz_to_mel(freq, htk=False):
    if htk:
        return 2595.0 * np.log10(1.0 + np.asarray(freq) / 700.0)
    f = np.asarray(freq, dtype="float64")
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) /
                                         min_log_hz) / logstep, mels)


def mel_to_hz(mel, htk=False):
    if htk:
        return 700.0 * (10.0 ** (np.asarray(mel) / 2595.0) - 1.0)
    m = np.asarray(mel, dtype="float64")
    f_sp = 200.0 / 3
    freqs = m * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


def mel_frequencies(n_mels=64, f_min=0.0, f_max=11025.0, htk=False,
                    dtype="float64"):
    mels = np.linspace(hz_to_mel(f_min, htk), hz_to_mel(f_max, htk), n_mels)
    return _tensor(mel_to_hz(mels, htk), dtype)


def fft_frequencies(sr, n_fft, dtype="float64"):
    return _tensor(np.linspace(0, sr / 2, 1 + n_fft // 2), dtype)


def compute_fbank_matrix(sr, n_fft, n_mels=64, f_min=0.0, f_max=None,
                         htk=False, norm="slaney", dtype="float64"):
    """Triangular mel filterbank ``[n_mels, 1 + n_fft // 2]``."""
    f_max = f_max or sr / 2.0
    fftfreqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    melpts = mel_to_hz(np.linspace(hz_to_mel(f_min, htk),
                                   hz_to_mel(f_max, htk), n_mels + 2), htk)
    fdiff = np.diff(melpts)
    ramps = melpts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    if norm == "slaney":
        enorm = 2.0 / (melpts[2:n_mels + 2] - melpts[:n_mels])
        weights *= enorm[:, None]
    return _tensor(weights, dtype)


def create_dct(n_mfcc, n_mels, norm="ortho", dtype="float64"):
    """DCT-II matrix ``[n_mels, n_mfcc]``."""
    n = np.arange(n_mels)
    k = np.arange(n_mfcc)[None, :]
    dct = np.cos(np.pi / n_mels * (n[:, None] + 0.5) * k)
    if norm == "ortho":
        dct[:, 0] *= 1.0 / math.sqrt(2)
        dct *= math.sqrt(2.0 / n_mels)
    else:
        dct *= 2.0
    return _tensor(dct, dtype)


def power_to_db(magnitude, ref_value=1.0, amin=1e-10, top_db=80.0):
    def raw(x):
        log_spec = 10.0 * (torch.log10(torch.clamp(x, min=amin)) -
                           math.log10(max(ref_value, amin)))
        if top_db is not None:
            # the whole input's maximum, the batch's included
            log_spec = torch.maximum(log_spec, log_spec.max() - top_db)
        return log_spec

    return apply_op(raw, "power_to_db", (magnitude,), {})
