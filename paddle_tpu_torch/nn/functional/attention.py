"""Attention functionals in the fused-op layout ``[B, T, H, D]``.

``scaled_dot_product_attention`` sends mask-free calls to the flash
kernel (``kernels/flash_attention.py``: the CUDA kernel for CUDA tensors,
its plain version for CPU tensors) and keeps the plain math
(:func:`sdpa_ref`) for masked calls, which is what
``paddle_tpu.nn.functional.attention`` does too.  The JAX package's
``q.shape[1] < 128`` routing threshold was a TPU tiling choice and is not
ported: on the card every mask-free call launches the kernel.
"""
from __future__ import annotations

import math

from ...kernels.flash_attention import flash_attention_bthd, sdpa_ref

__all__ = ["scaled_dot_product_attention", "sdpa_ref"]


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=False):
    """Inputs ``[batch, seq, heads, head_dim]``; returns the same layout."""
    if dropout_p and training:
        raise NotImplementedError(
            "attention dropout is training-only; the port's training half "
            "is ROADMAP 'Port queue' item 4")
    scale = 1.0 / math.sqrt(query.shape[-1])
    if attn_mask is None:
        return flash_attention_bthd(query, key, value, causal=is_causal,
                                    scale=scale)
    return sdpa_ref(query, key, value, attn_mask, is_causal, scale)
