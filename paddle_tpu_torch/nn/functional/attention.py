"""Attention functionals in the fused-op layout ``[B, T, H, D]``, and the
pre-LayerNorm fused into the projection that feeds attention or the MLP.

``scaled_dot_product_attention`` sends mask-free, dropout-free calls to
the flash kernel and ``fused_qkv_attention`` sends dropout-free calls on
the fused ``[B, T, nh, 3, hd]`` projection to the fused flash kernel
(``kernels/flash_attention.py``: the CUDA kernels for CUDA tensors, their
plain versions for CPU tensors; both differentiable).  Masked calls and
dropout in training keep the plain math (:func:`sdpa_ref`), which is what
``paddle_tpu.nn.functional.attention`` does too.  The JAX package's
``T >= 128`` routing threshold was a TPU tiling choice and is not ported:
on the card every such call launches the kernel.

``fused_ln_linear`` is ``LN(x) @ weight^T (+ bias)``: with the opt-in
``kernels.ln_matmul.enable_ln_matmul(True)`` and K and M multiples of 128
it runs ``ln_matmul`` (the CUDA kernel for CUDA tensors, its plain
version for CPU tensors), otherwise the plain composition in torch ops.
There is no fallback that catches a kernel failure: a CUDA tensor
launches the kernel or raises.

Attention dropout draws its keep mask from a ``torch.Generator`` (torch's
default one unless ``generator`` is given): it has the JAX draw's
distribution, not its bits.
"""
from __future__ import annotations

import math

import torch

from ...kernels.flash_attention import (flash_attention_bthd,
                                        flash_attention_qkv_fused, sdpa_ref)
from ...kernels.ln_matmul import ln_matmul, ln_matmul_ok

__all__ = ["scaled_dot_product_attention", "fused_qkv_attention",
           "fused_ln_linear", "sdpa_ref"]


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


def fused_ln_linear(x, ln_weight, ln_bias, weight, bias=None, eps=1e-5):
    """Pre-LN fused into its consuming projection: ``LN(x) @ weight^T
    (+ bias)`` with ``weight`` ``[M, K]`` (``nn.Linear.weight``).  Runs
    :func:`ln_matmul` when ``ln_matmul_ok``; otherwise the plain
    composition (statistics in f32, or f64 for f64 inputs; the normalised
    rows rounded to x's type before the product)."""
    if ln_matmul_ok(x, weight, mesh_free=True):
        return ln_matmul(x, ln_weight, ln_bias, weight, bias, eps)
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mu = xf.mean(dim=-1, keepdim=True)
    d = xf - mu
    var = (d * d).mean(dim=-1, keepdim=True)
    xln = (d * torch.rsqrt(var + eps) * ln_weight + ln_bias).to(x.dtype)
    y = torch.matmul(xln, weight.t())
    return y if bias is None else y + bias
