"""int8 KV-cache quantization helpers (PyTorch; no engine state).

The port's copy of ``paddle_tpu/serving/kv_quant.py``: one float32 scale
per cached position (the symmetric absmax over that position's
``[heads, head_dim]`` vector), so a new token quantizes against its own
absmax and nothing resident ever rescales.  The paged pool keeps the
scales as a ``[num_pages, page_size]`` sidecar written by the same
scatter as the int8 page.  ``torch.round`` rounds half to even, as
``jnp.round`` does, so both frameworks give the same int8 values.
"""
from __future__ import annotations

import torch

__all__ = ["INT8_MAX", "quantize_rows", "dequantize_pool"]

INT8_MAX = 127.0
# floor for the per-row scale: an all-zero row (unwritten pool padding)
# quantizes to zeros with a tiny finite scale instead of dividing by 0
_SCALE_EPS = 1e-8


def quantize_rows(x, eps: float = _SCALE_EPS):
    """``x [..., heads, head_dim]`` float -> ``(q int8 same shape,
    scales [...] float32)``: symmetric absmax over the trailing two dims,
    one scale per leading index (= per cached position)."""
    amax = x.abs().amax(dim=(-2, -1))
    scale = torch.clamp(amax.float() / INT8_MAX, min=eps)
    q = torch.clamp(torch.round(x / scale[..., None, None].to(x.dtype)),
                    -INT8_MAX, INT8_MAX).to(torch.int8)
    return q, scale


def dequantize_pool(q, scale, dtype=torch.float32):
    """Inverse of :func:`quantize_rows`: ``q [..., heads, head_dim]`` int8
    + ``scale [...]`` -> float ``dtype``."""
    return q.to(dtype) * scale[..., None, None].to(dtype)
