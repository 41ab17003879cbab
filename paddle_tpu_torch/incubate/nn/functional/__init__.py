"""``paddle_tpu.incubate.nn.functional`` counterparts: the functional
forms of the fused transformer ops (``fused_matmul_bias``,
``fused_linear``, ``fused_multi_head_attention``,
``fused_multi_transformer``, ``fused_feedforward``,
``fused_bias_dropout_residual_layer_norm``).

Each is the JAX function's op sequence in torch ops and the port's
``nn.functional``, so autograd records every step and gradients reach
the input and every weight.  The attention core is the port's
``F.scaled_dot_product_attention`` on ``[B, T, nh, hd]`` q, k and v:
a call with no mask and no dropout in training launches the flash
forward (``flash_attention_bthd``, row 1 of the kernel table) and, under
autograd, its backward (rows 2-4) on the card; a masked call takes the
plain attention, as in the JAX package.  A decode step of
``fused_multi_transformer`` (one query, the cache's first ``time_step``
keys and its own) has no mask, so it reaches row 1 with Tq = 1.

Layouts are the JAX package's: ``qkv_weight`` ``[3, nh, hd, e]``
(``trans_qkvw=False`` takes ``[e, 3, nh, hd]``), ``qkv_bias`` ``[3, nh,
hd]``, linear weights ``[in, out]``, and the cache ``[2, b, nh, t, hd]``.
With ``cache_kv`` the new keys and values are appended to the cache's and
the grown cache comes back; with ``time_step`` the layer reads only the
first ``time_step`` positions of a fixed-size cache.  The qkv projection
is one matmul against the ``[3 nh hd, e]`` view of the weight, booked as
the op ``"einsum"`` (the JAX form's op) for ``amp``.

Surface Tensors in give Tensors out; bare torch tensors give torch
tensors (``core.op.defop``).
"""
from __future__ import annotations

import torch

from ....core.op import apply_op, defop
from ....nn import functional as _F
from ....nn.functional.attention import scaled_dot_product_attention
from ....ops.linalg import matmul as _matmul

__all__ = ["fused_matmul_bias", "fused_linear", "fused_multi_head_attention",
           "fused_multi_transformer", "fused_feedforward",
           "fused_bias_dropout_residual_layer_norm"]


@defop(register=False)
def fused_matmul_bias(x, y, bias=None, transpose_x=False, transpose_y=False,
                      name=None):
    out = _matmul(x, y, transpose_x=transpose_x, transpose_y=transpose_y)
    return out if bias is None else out + bias


@defop(register=False)
def fused_linear(x, weight, bias=None, transpose_weight=False, name=None):
    return fused_matmul_bias.raw(x, weight, bias,
                                 transpose_y=transpose_weight)


def _qkv(h, w):
    """``einsum("bse,thde->bsthd", h, w)`` as one matmul."""
    three, nh, hd, e = w.shape
    out = torch.matmul(h, w.reshape(three * nh * hd, e).t())
    return out.view(*h.shape[:-1], three, nh, hd)


@defop(register=False)
def fused_multi_head_attention(x, qkv_weight, linear_weight,
                               pre_layer_norm=False, pre_ln_scale=None,
                               pre_ln_bias=None, ln_scale=None,
                               ln_bias=None, pre_ln_epsilon=1e-5,
                               qkv_bias=None, linear_bias=None,
                               cache_kv=None, attn_mask=None,
                               dropout_rate=0.5, attn_dropout_rate=0.5,
                               ln_epsilon=1e-5, training=True,
                               mode="upscale_in_train", ring_id=-1,
                               add_residual=True, name=None):
    """Self-attention: returns ``out``, or ``(out, new_cache)`` with
    ``cache_kv``."""
    residual = h = x
    if pre_layer_norm:
        h = _F.layer_norm(x, x.shape[-1:], weight=pre_ln_scale,
                          bias=pre_ln_bias, epsilon=pre_ln_epsilon)
    nh, hd = qkv_weight.shape[1], qkv_weight.shape[2]
    qkv = apply_op(_qkv, "einsum", (h, qkv_weight), {})
    if qkv_bias is not None:
        qkv = qkv + qkv_bias                 # [3, nh, hd] over [b, s, ...]
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]   # [b, s, nh, hd]
    if cache_kv is not None:                 # [2, b, nh, t, hd]
        k = torch.cat([cache_kv[0].permute(0, 2, 1, 3), k], dim=1)
        v = torch.cat([cache_kv[1].permute(0, 2, 1, 3), v], dim=1)
    out = scaled_dot_product_attention(
        q, k, v, attn_mask=attn_mask, dropout_p=attn_dropout_rate,
        training=training)                   # [b, s, nh, hd]
    out = out.reshape(out.shape[0], out.shape[1], nh * hd)
    out = _F.linear(out, linear_weight, linear_bias)
    out = _F.dropout(out, p=dropout_rate, training=training, mode=mode)
    if add_residual:
        out = residual + out
    if not pre_layer_norm:
        out = _F.layer_norm(out, out.shape[-1:], weight=ln_scale,
                            bias=ln_bias, epsilon=ln_epsilon)
    if cache_kv is not None:
        return out, torch.stack([k.permute(0, 2, 1, 3),
                                 v.permute(0, 2, 1, 3)])
    return out


@defop(register=False)
def fused_multi_transformer(x, ln_scales, ln_biases, qkv_weights,
                            qkv_biases, linear_weights, linear_biases,
                            ffn_ln_scales, ffn_ln_biases, ffn1_weights,
                            ffn1_biases, ffn2_weights, ffn2_biases,
                            pre_layer_norm=True, epsilon=1e-5,
                            cache_kvs=None, time_step=None, attn_mask=None,
                            dropout_rate=0.0, activation="gelu",
                            training=False, mode="upscale_in_train",
                            trans_qkvw=True, ring_id=-1, name=None):
    """N transformer layers from per-layer weight lists; with
    ``cache_kvs`` returns ``(out, new_caches)``.  ``time_step`` (an int,
    or a one-element tensor: read on the host) is the valid length of
    fixed-size caches ``[2, b, nh, max_len, hd]``: each layer attends to
    their first ``time_step`` positions and its own new ones."""
    out = x
    new_caches = [] if cache_kvs is not None else None
    t = None if time_step is None else int(time_step)
    for i in range(len(qkv_weights)):
        qw = qkv_weights[i]
        if not trans_qkvw:                 # [e, 3, nh, hd] -> [3, nh, hd, e]
            qw = qw.permute(1, 2, 3, 0)
        cache_i = None
        if cache_kvs is not None:
            cache_i = cache_kvs[i]
            if t is not None:
                cache_i = cache_i[:, :, :, :t]
        ln_s = ln_scales[i] if ln_scales else None
        ln_b = ln_biases[i] if ln_biases else None
        attn = fused_multi_head_attention.raw(
            out, qw, linear_weights[i],
            pre_layer_norm=pre_layer_norm,
            # pre-LN reads ln as the norm before, post-LN as the one after
            pre_ln_scale=ln_s if pre_layer_norm else None,
            pre_ln_bias=ln_b if pre_layer_norm else None,
            ln_scale=None if pre_layer_norm else ln_s,
            ln_bias=None if pre_layer_norm else ln_b,
            pre_ln_epsilon=epsilon, ln_epsilon=epsilon,
            qkv_bias=qkv_biases[i] if qkv_biases else None,
            linear_bias=linear_biases[i] if linear_biases else None,
            cache_kv=cache_i, attn_mask=attn_mask,
            dropout_rate=dropout_rate, attn_dropout_rate=dropout_rate,
            training=training, mode=mode)
        if cache_kvs is not None:
            attn, cache = attn
            new_caches.append(cache)
        fln_s = ffn_ln_scales[i] if ffn_ln_scales else None
        fln_b = ffn_ln_biases[i] if ffn_ln_biases else None
        out = fused_feedforward.raw(
            attn, ffn1_weights[i], ffn1_biases[i] if ffn1_biases else None,
            ffn2_weights[i], ffn2_biases[i] if ffn2_biases else None,
            ln1_scale=fln_s, ln1_bias=fln_b, ln2_scale=fln_s,
            ln2_bias=fln_b, ln1_epsilon=epsilon, ln2_epsilon=epsilon,
            dropout1_rate=dropout_rate, dropout2_rate=dropout_rate,
            activation=activation, pre_layer_norm=pre_layer_norm,
            training=training, mode=mode)
    if cache_kvs is not None:
        return out, new_caches
    return out


@defop(register=False)
def fused_feedforward(x, linear1_weight, linear1_bias, linear2_weight,
                      linear2_bias, ln1_scale=None, ln1_bias=None,
                      ln2_scale=None, ln2_bias=None, dropout1_rate=0.5,
                      dropout2_rate=0.5, activation="relu",
                      ln1_epsilon=1e-5, ln2_epsilon=1e-5,
                      pre_layer_norm=False, training=True,
                      mode="upscale_in_train", ring_id=-1, name=None):
    """``linear -> activation -> dropout -> linear -> dropout``, plus the
    residual, with the LayerNorm before (``pre_layer_norm``) or after."""
    residual = x
    if pre_layer_norm:
        x = _F.layer_norm(x, x.shape[-1:], weight=ln1_scale, bias=ln1_bias,
                          epsilon=ln1_epsilon)
    y = _F.linear(x, linear1_weight, linear1_bias)
    y = getattr(_F, activation)(y)
    y = _F.dropout(y, p=dropout1_rate, training=training)
    y = _F.linear(y, linear2_weight, linear2_bias)
    y = _F.dropout(y, p=dropout2_rate, training=training)
    out = residual + y
    if not pre_layer_norm:
        out = _F.layer_norm(out, out.shape[-1:], weight=ln2_scale,
                            bias=ln2_bias, epsilon=ln2_epsilon)
    return out


@defop(register=False)
def fused_bias_dropout_residual_layer_norm(x, residual, bias=None,
                                           ln_scale=None, ln_bias=None,
                                           dropout_rate=0.5, ln_epsilon=1e-5,
                                           training=True,
                                           mode="upscale_in_train",
                                           name=None):
    """``layer_norm(residual + dropout(x + bias))``."""
    y = x if bias is None else x + bias
    y = _F.dropout(y, p=dropout_rate, training=training)
    out = residual + y
    return _F.layer_norm(out, out.shape[-1:], weight=ln_scale, bias=ln_bias,
                         epsilon=ln_epsilon)
