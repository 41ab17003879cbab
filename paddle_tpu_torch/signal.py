"""``paddle_tpu.signal`` counterpart: ``stft`` and ``istft`` over the
port's ``fft`` family, on the input's device, with the JAX package's
conventions (not ``torch.stft``'s):

* the window (``win_length`` ones when None) is zero-padded on both
  sides to ``n_fft``, the left pad ``(n_fft - win_length) // 2``, and
  taken in f32;
* with ``center``, the signal is padded by ``n_fft // 2`` on each side
  (``pad_mode``: ``"reflect"``, ``"constant"``, ``"edge"`` or
  ``"wrap"``), then cut into ``1 + (T - n_fft) // hop_length`` frames of
  ``n_fft`` samples (a strided view, no copy), each multiplied by the
  window and transformed (``rfft`` one-sided, else ``fft``);
  ``normalized`` divides by ``sqrt(n_fft)``; the result is ``[B, F,
  frames]`` (``[F, frames]`` for a 1-D signal);
* ``istft`` inverts each frame, multiplies it by the window, adds the
  frames at their hops (``fold``) and divides by the sum of the squared
  window there, floored at 1e-8, then cuts the centre padding and, with
  ``length``, the tail.  It returns the real signal whatever
  ``return_complex`` says, as the JAX function does.

Surface Tensors in give Tensors out; bare torch tensors give torch
tensors.
"""
from __future__ import annotations

import math

import torch
from torch.nn import functional as tF

from .core.op import apply_op
from .core.tensor import Tensor
from .ops.compat_surface import is_complex  # noqa: F401
from .ops.extended import frame, overlap_add  # noqa: F401

__all__ = ["stft", "istft"]

_PAD_MODES = {"reflect": "reflect", "constant": "constant",
              "edge": "replicate", "wrap": "circular"}


def _window(window, n_fft, win_length, device):
    """The window as f32 on ``device``, centre-padded to ``n_fft``."""
    if window is None:
        w = torch.ones(win_length, dtype=torch.float32, device=device)
    else:
        w = window._value if isinstance(window, Tensor) else window
        w = torch.as_tensor(w, device=device)
    if w.shape[0] != n_fft:
        lpad = (n_fft - w.shape[0]) // 2
        w = tF.pad(w, (lpad, n_fft - w.shape[0] - lpad))
    return w.float()


def stft(x, n_fft, hop_length=None, win_length=None, window=None,
         center=True, pad_mode="reflect", normalized=False, onesided=True,
         name=None):
    """``x`` ``[B, T]`` (or ``[T]``) -> complex ``[B, F, frames]``."""
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft
    if center and pad_mode not in _PAD_MODES:
        raise ValueError(f"pad_mode {pad_mode!r} is not one of "
                         f"{sorted(_PAD_MODES)}")

    def raw(v):
        win = _window(window, n_fft, win_length, v.device)
        squeeze = v.dim() == 1
        if squeeze:
            v = v[None]
        if center:
            p = n_fft // 2
            v = tF.pad(v[:, None], (p, p), mode=_PAD_MODES[pad_mode])[:, 0]
        frames = v.unfold(-1, n_fft, hop_length) * win.to(v.dtype)
        if onesided:
            spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
        else:
            spec = torch.fft.fft(frames, n=n_fft, dim=-1)
        if normalized:
            spec = spec / math.sqrt(n_fft)
        spec = spec.transpose(-1, -2)          # [B, F, frames]
        return spec[0] if squeeze else spec

    return apply_op(raw, "stft", (x,), {})


def istft(x, n_fft, hop_length=None, win_length=None, window=None,
          center=True, normalized=False, onesided=True, length=None,
          return_complex=False, name=None):
    """Complex ``[B, F, frames]`` (or ``[F, frames]``) -> ``[B, T]`` by a
    window-weighted overlap-add."""
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft

    def raw(v):
        win = _window(window, n_fft, win_length, v.device)
        squeeze = v.dim() == 2
        if squeeze:
            v = v[None]
        spec = v.transpose(-1, -2)             # [B, frames, F]
        if normalized:
            spec = spec * math.sqrt(n_fft)
        if onesided:
            frames = torch.fft.irfft(spec, n=n_fft, dim=-1)
        else:
            frames = torch.fft.ifft(spec, dim=-1).real
        frames = frames * win
        b, n_frames, _ = frames.shape
        t_len = n_fft + hop_length * (n_frames - 1)

        def ola(f):                            # [N, frames, n_fft] -> [N, T]
            return tF.fold(f.transpose(1, 2), output_size=(1, t_len),
                           kernel_size=(1, n_fft),
                           stride=(1, hop_length))[:, 0, 0]

        out = ola(frames)
        wsum = ola((win * win).to(frames.dtype).expand(1, n_frames, n_fft))
        out = out / wsum.clamp(min=1e-8)
        if center:
            out = out[:, n_fft // 2: t_len - n_fft // 2]
        if length is not None:
            out = out[:, :length]
        return out[0] if squeeze else out

    return apply_op(raw, "istft", (x,), {})
