"""Weights between the JAX package and the port, as numpy state dicts.

The port keeps the JAX model's parameter and buffer names, so a JAX
``state_dict()`` turned into numpy arrays loads by name, for GPT and for
ResNet alike (conv weights as they are, batch-norm ``_mean`` and
``_variance`` buffers by name).  Two things differ: the port's
projections are ``nn.Linear`` (weight ``[out, in]``) where paddle stores
``[in, out]``, so linear weights (GPT's projections, ResNet's ``fc``)
transpose; and GPT's fused qkv columns must be head-major ``[nh, 3, hd]``
— a state whose ``qkv_layout`` marker is below 2 (role-major ``[3, nh,
hd]``) is permuted on load, as ``GPTSelfAttention._state_dict_compat_``
does in the JAX package; other models have no such layer and are not
touched.  A name on one side only raises, so a torch-style state with
``num_batches_tracked`` is refused.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .gpt import QKV_LAYOUT_HEAD_MAJOR, GPTSelfAttention

__all__ = ["load_jax_state", "to_jax_state"]


def _linear_weights(model: nn.Module) -> set:
    return {f"{name}.weight" for name, mod in model.named_modules()
            if isinstance(mod, nn.Linear)}


def _role_to_head_major(arr, nh, hd, is_bias):
    if is_bias:
        return arr.reshape(3, nh, hd).transpose(1, 0, 2).reshape(3 * nh * hd)
    h = arr.shape[0]
    return arr.reshape(h, 3, nh, hd).transpose(0, 2, 1, 3).reshape(
        h, 3 * nh * hd)


def load_jax_state(model: nn.Module, np_state: dict,
                   markerless_qkv_layout: str = "head_major") -> None:
    """Copy a JAX state dict (``{name: numpy array}``) into ``model``
    in place.  Raises ``KeyError`` for missing or unexpected names and
    ``ValueError`` for a shape that does not fit.  A state without
    ``qkv_layout`` markers is read as ``markerless_qkv_layout``
    (``"head_major"``, the JAX default, or ``"role_major"``)."""
    if markerless_qkv_layout not in ("head_major", "role_major"):
        raise ValueError(f"markerless_qkv_layout must be 'head_major' or "
                         f"'role_major', got {markerless_qkv_layout!r}")
    src = {k: np.asarray(v) for k, v in np_state.items()}
    own = model.state_dict()
    markers = {k for k in own if k.endswith("qkv_layout")}
    missing = sorted(set(own) - set(src) - markers)
    unexpected = sorted(set(src) - set(own))
    if missing or unexpected:
        raise KeyError(f"state dict mismatch: missing {missing}, "
                       f"unexpected {unexpected}")
    for name, mod in model.named_modules():
        if not isinstance(mod, GPTSelfAttention):
            continue
        pre = f"{name}." if name else ""
        marker = src.get(pre + "qkv_layout")
        role_major = (markerless_qkv_layout == "role_major"
                      if marker is None
                      else int(marker) < QKV_LAYOUT_HEAD_MAJOR)
        if role_major:
            for suffix, is_bias in (("qkv_proj.weight", False),
                                    ("qkv_proj.bias", True)):
                src[pre + suffix] = _role_to_head_major(
                    src[pre + suffix], mod.num_heads, mod.head_dim, is_bias)
    linear = _linear_weights(model)
    with torch.no_grad():
        for name, dst in own.items():
            if name in markers:
                dst.fill_(QKV_LAYOUT_HEAD_MAJOR)
                continue
            arr = src[name].T if name in linear else src[name]
            if tuple(arr.shape) != tuple(dst.shape):
                raise ValueError(f"{name}: JAX shape {tuple(src[name].shape)}"
                                 f" does not fit the port's "
                                 f"{tuple(dst.shape)}")
            dst.copy_(torch.from_numpy(np.array(arr)).to(
                dst.dtype))


def to_jax_state(model: nn.Module) -> dict:
    """The inverse of :func:`load_jax_state`: ``{name: numpy array}`` in
    the JAX package's layout (``[in, out]`` linear weights, head-major
    qkv with its marker)."""
    linear = _linear_weights(model)
    out = {}
    for name, t in model.state_dict().items():
        arr = t.detach().cpu().numpy()
        out[name] = np.ascontiguousarray(arr.T) if name in linear else arr
    return out
