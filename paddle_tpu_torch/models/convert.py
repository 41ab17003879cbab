"""Weights and train states between the JAX package and the port, as numpy.

The port keeps the JAX model's parameter and buffer names, so a JAX
``state_dict()`` turned into numpy arrays loads by name, for GPT (with
its MoE experts and gates, ``mlp.moe.experts.{i}.fc0.weight``,
``mlp.moe.gate.gate.weight``, ...), BERT / ERNIE, ResNet, PP-YOLOE, SVTR
and CRNN alike (conv weights as they are, batch-norm ``_mean`` and
``_variance`` buffers by name, ``LayerList`` children ``"0"``, ``"1"``,
..., LSTM weights ``[4 H, in]`` as they are).  Two things differ: the
port's projections are ``nn.Linear`` (weight ``[out, in]``) where paddle
stores ``[in, out]``, so linear weights (GPT's and BERT's projections,
experts and gates, ResNet's ``fc``, ``MultiHeadAttention``'s
projections) transpose; and GPT's fused qkv columns must be head-major ``[nh,
3, hd]`` — a state whose ``qkv_layout`` marker is below 2 (role-major
``[3, nh, hd]``) is permuted on load, as
``GPTSelfAttention._state_dict_compat_`` does in the JAX package; other
models have no such layer and are not touched (BERT's qkv is role-major
on both sides).  BERT's tied decoder is one parameter under two names
(``cls.decoder_weight`` and the word embedding's), as in JAX: both
entries load into it, so it stays tied.  A name on one side only raises,
so a torch-style state with ``num_batches_tracked`` is refused.

A train state (``ShardedTrainStep.state_dict()``, the ``train_state_v2``
layout: ``params``, ``slots``, ``buffers``, ``step``, ``opt_step_count``,
``meta``; JAX adds its dropout ``rng_key``) crosses the same way: every
slot is shaped as its parameter, so the slots of a linear weight
transpose with it and those of a role-major qkv projection are permuted
with it.  numpy has no bf16: a bf16 leaf leaves the port as f32 (exact),
and a bf16 array (``ml_dtypes``) enters through f32.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .gpt import QKV_LAYOUT_HEAD_MAJOR, GPTSelfAttention

__all__ = ["load_jax_state", "to_jax_state", "load_jax_train_state",
           "to_jax_train_state"]


def _linear_weights(model: nn.Module) -> set:
    return {f"{name}.weight" for name, mod in model.named_modules()
            if isinstance(mod, nn.Linear)}


def _role_to_head_major(arr, nh, hd, is_bias):
    if is_bias:
        return arr.reshape(3, nh, hd).transpose(1, 0, 2).reshape(3 * nh * hd)
    h = arr.shape[0]
    return arr.reshape(h, 3, nh, hd).transpose(0, 2, 1, 3).reshape(
        h, 3 * nh * hd)


def _host(arr) -> np.ndarray:
    arr = np.asarray(arr)
    return arr.astype(np.float32) if arr.dtype.name == "bfloat16" else arr


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class _Layout:
    """How one model's JAX-layout arrays map onto its own: the linear
    weights to transpose and, per fused qkv projection read role-major,
    its heads and head size."""

    def __init__(self, model, markers, markerless_qkv_layout):
        if markerless_qkv_layout not in ("head_major", "role_major"):
            raise ValueError(f"markerless_qkv_layout must be 'head_major' "
                             f"or 'role_major', got "
                             f"{markerless_qkv_layout!r}")
        self.linear = _linear_weights(model)
        self.role_major = {}
        for name, mod in model.named_modules():
            if not isinstance(mod, GPTSelfAttention):
                continue
            pre = f"{name}." if name else ""
            marker = markers.get(pre + "qkv_layout")
            if (markerless_qkv_layout == "role_major" if marker is None
                    else int(np.asarray(marker)) < QKV_LAYOUT_HEAD_MAJOR):
                for suffix, is_bias in (("qkv_proj.weight", False),
                                        ("qkv_proj.bias", True)):
                    self.role_major[pre + suffix] = (
                        mod.num_heads, mod.head_dim, is_bias)

    def to_port(self, name, arr):
        arr = _host(arr)
        if name in self.role_major:
            arr = _role_to_head_major(arr, *self.role_major[name])
        return np.ascontiguousarray(arr.T) if name in self.linear else arr

    def to_jax(self, name, t):
        arr = _to_numpy(t)
        return np.ascontiguousarray(arr.T) if name in self.linear else arr


def load_jax_state(model: nn.Module, np_state: dict,
                   markerless_qkv_layout: str = "head_major") -> None:
    """Copy a JAX state dict (``{name: numpy array}``) into ``model``
    in place.  Raises ``KeyError`` for missing or unexpected names and
    ``ValueError`` for a shape that does not fit.  A state without
    ``qkv_layout`` markers is read as ``markerless_qkv_layout``
    (``"head_major"``, the JAX default, or ``"role_major"``)."""
    layout = _Layout(model, np_state, markerless_qkv_layout)
    own = model.state_dict()
    markers = {k for k in own if k.endswith("qkv_layout")}
    missing = sorted(set(own) - set(np_state) - markers)
    unexpected = sorted(set(np_state) - set(own))
    if missing or unexpected:
        raise KeyError(f"state dict mismatch: missing {missing}, "
                       f"unexpected {unexpected}")
    with torch.no_grad():
        for name, dst in own.items():
            if name in markers:
                dst.fill_(QKV_LAYOUT_HEAD_MAJOR)
                continue
            arr = layout.to_port(name, np_state[name])
            if tuple(arr.shape) != tuple(dst.shape):
                raise ValueError(f"{name}: JAX shape "
                                 f"{tuple(np.shape(np_state[name]))} does "
                                 f"not fit the port's {tuple(dst.shape)}")
            dst.copy_(torch.from_numpy(np.array(arr)).to(dst.dtype))


def to_jax_state(model: nn.Module) -> dict:
    """The inverse of :func:`load_jax_state`: ``{name: numpy array}`` in
    the JAX package's layout (``[in, out]`` linear weights, head-major
    qkv with its marker)."""
    layout = _Layout(model, {}, "head_major")
    return {name: layout.to_jax(name, t)
            for name, t in model.state_dict().items()}


def load_jax_train_state(step, np_state: dict,
                         markerless_qkv_layout: str = "head_major") -> None:
    """Load a JAX ``ShardedTrainStep.state_dict()`` (numpy leaves) into the
    port's ``step`` (``step.load_state_dict``, which checks every leaf
    first).  The qkv markers are read from its ``buffers`` and written as
    head-major; ``rng_key`` is not read (the port's dropout draws from
    torch's generator)."""
    buffers = np_state.get("buffers", {})
    layout = _Layout(step.model, buffers, markerless_qkv_layout)
    step.load_state_dict({
        "params": {n: layout.to_port(n, a)
                   for n, a in np_state.get("params", {}).items()},
        "slots": {n: {k: layout.to_port(n, a) for k, a in d.items()}
                  for n, d in np_state.get("slots", {}).items()},
        "buffers": {n: (np.asarray(QKV_LAYOUT_HEAD_MAJOR, np.int32)
                        if n.endswith("qkv_layout") else _host(a))
                    for n, a in buffers.items()},
        "step": np_state["step"], "opt_step_count": np_state["opt_step_count"],
        "meta": np_state.get("meta", {})})


def to_jax_train_state(step, rng_key=None) -> dict:
    """The port's train state in the JAX step's layout and numpy, ready
    for ``paddle_tpu``'s ``ShardedTrainStep.load_state_dict``.  ``rng_key``
    is the JAX dropout key's data to carry (default ``PRNGKey(0)``'s,
    ``[0, 0]``)."""
    sd = step.state_dict()
    layout = _Layout(step.model, {}, "head_major")
    return {
        "params": {n: layout.to_jax(n, t) for n, t in sd["params"].items()},
        "slots": {n: {k: layout.to_jax(n, t) for k, t in d.items()}
                  for n, d in sd["slots"].items()},
        "buffers": {n: _to_numpy(t) for n, t in sd["buffers"].items()},
        "step": np.asarray(int(sd["step"]), np.int32),
        "rng_key": np.asarray(np.zeros(2) if rng_key is None else rng_key,
                              np.uint32),
        "opt_step_count": np.asarray(int(sd["opt_step_count"]), np.int64),
        "meta": dict(sd["meta"])}
