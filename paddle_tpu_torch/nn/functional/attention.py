"""Attention functionals in the fused-op layout ``[B, T, H, D]``.

``scaled_dot_product_attention`` sends mask-free, dropout-free calls to
the flash kernel and ``fused_qkv_attention`` sends dropout-free calls on
the fused ``[B, T, nh, 3, hd]`` projection to the fused flash kernel
(``kernels/flash_attention.py``: the CUDA kernels for CUDA tensors, their
plain versions for CPU tensors; both differentiable).  Masked calls and
dropout in training keep the plain math (:func:`sdpa_ref`), which is what
``paddle_tpu.nn.functional.attention`` does too.  The JAX package's
``T >= 128`` routing threshold was a TPU tiling choice and is not ported:
on the card every such call launches the kernel.

Attention dropout draws its keep mask from a ``torch.Generator`` (torch's
default one unless ``generator`` is given): it has the JAX draw's
distribution, not its bits.
"""
from __future__ import annotations

import math

from ...kernels.flash_attention import (flash_attention_bthd,
                                        flash_attention_qkv_fused, sdpa_ref)

__all__ = ["scaled_dot_product_attention", "fused_qkv_attention", "sdpa_ref"]


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=False, generator=None):
    """Inputs ``[batch, seq, heads, head_dim]``; returns the same layout."""
    scale = 1.0 / math.sqrt(query.shape[-1])
    dropout_p = dropout_p if training else 0.0
    if attn_mask is None and not dropout_p:
        return flash_attention_bthd(query, key, value, causal=is_causal,
                                    scale=scale)
    return sdpa_ref(query, key, value, attn_mask, is_causal, scale,
                    dropout_p=dropout_p, generator=generator)


def fused_qkv_attention(qkv, dropout_p=0.0, is_causal=True, training=True,
                        generator=None):
    """Self-attention on the fused head-major qkv tensor ``[batch, seq,
    heads, 3, head_dim]``, returning ``[batch, seq, heads*head_dim]``."""
    b, t, nh, three, hd = qkv.shape
    if three != 3:
        raise ValueError(f"fused qkv must be [B, T, nh, 3, hd], got "
                         f"{tuple(qkv.shape)}")
    if not (dropout_p and training):
        return flash_attention_qkv_fused(qkv, causal=is_causal)
    q, k, v = qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]
    out = sdpa_ref(q, k, v, None, is_causal, 1.0 / math.sqrt(hd),
                   dropout_p=dropout_p, generator=generator)
    return out.reshape(b, t, nh * hd)
