"""int8 base weights for the serving path (per-channel absmax).

The port's counterpart of ``paddle_tpu/serving/adapters/weight_quant.py``.
``Engine(weight_dtype="int8")`` stores every 2-D floating leaf of the
model's state (the qkv, out and MLP projections, the word and position
tables) as int8 plus one float32 absmax scale per output channel; 1-D
leaves (LayerNorm weights, biases) and non-float buffers stay as they are.

**The axis.**  The JAX package reduces over axis 0 of its layout: one
scale per output column of a linear weight ``[in, out]``, one per hidden
column of ``wte [V, h]`` and ``wpe [P, h]``.  The port's ``nn.Linear``
weights are ``[out, in]`` (``models/convert.py`` transposes them), so for
them the reduction runs over the port's dim 1; the tables are laid out as
in JAX.  The division, rounding (``torch.round``, half to even, as
``jnp.round``) and clip run in the same order and dtype, so the int8
values and scales equal the JAX package's exactly.

**Point of use.**  The JAX engine dequantizes the whole state at the top
of each jitted step and XLA fuses the multiply into the consumers.  Inside
a captured CUDA graph a whole dequantized copy would stay alive in the
graph's private memory pool, so :func:`quantize_model` instead builds a
serving copy of the model whose linears (:class:`Int8Linear`) dequantize
their weight when they run and whose embeddings (:class:`Int8Embedding`)
dequantize only the rows they gather; the tied LM head reads the whole
dequantized word table (``Int8Embedding.weight``) for its one product.
The copy shares every other parameter with the model.
"""
from __future__ import annotations

import copy
from typing import Dict, NamedTuple

import torch
from torch import nn
from torch.nn import functional as tF

__all__ = ["Int8Leaf", "quantize_state", "dequantize_state", "state_bytes",
           "Int8Linear", "Int8Embedding", "quantize_model"]

_INT8_MAX = 127.0
_SCALE_EPS = 1e-8


class Int8Leaf(NamedTuple):
    """One quantized 2-D leaf: ``q`` int8 in the leaf's shape, ``scale``
    float32 with one entry per channel along ``dim`` of ``q``, and the
    leaf's original dtype."""

    q: torch.Tensor
    scale: torch.Tensor
    dim: int
    dtype: torch.dtype

    def dequantize(self) -> torch.Tensor:
        return self.q.to(self.dtype) * self.scale.unsqueeze(
            1 - self.dim).to(self.dtype)


def _quantizable(v) -> bool:
    return torch.is_tensor(v) and v.dim() == 2 and v.is_floating_point()


def quantize_state(values: Dict[str, torch.Tensor], transposed=()
                   ) -> Dict[str, object]:
    """``{name: tensor}`` (the port's layout) -> ``{name: Int8Leaf or
    tensor}``: every 2-D float leaf is quantized, everything else passes
    through.  ``transposed`` names the leaves stored as the transpose of
    the JAX layout (the ``nn.Linear`` weights, ``[out, in]``): their
    channels are the rows; the other 2-D leaves' channels are the
    columns."""
    packed: Dict[str, object] = {}
    for k, v in values.items():
        if not _quantizable(v):
            packed[k] = v
            continue
        dim = 0 if k in transposed else 1          # the channel dim
        amax = v.abs().amax(dim=1 - dim)
        scale = torch.clamp(amax.float() / _INT8_MAX, min=_SCALE_EPS)
        q = torch.clamp(torch.round(v / scale.unsqueeze(1 - dim).to(v.dtype)),
                        -_INT8_MAX, _INT8_MAX).to(torch.int8)
        packed[k] = Int8Leaf(q, scale, dim, v.dtype)
    return packed


def dequantize_state(packed: Dict[str, object]) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`quantize_state` (the weights the int8 engine
    computes with)."""
    return {k: v.dequantize() if isinstance(v, Int8Leaf) else v
            for k, v in packed.items()}


def state_bytes(packed: Dict[str, object]) -> int:
    """Bytes of the packed state as stored: int8 values and f32 scales for
    the quantized leaves, the other leaves as they are."""
    total = 0
    for v in packed.values():
        for t in ((v.q, v.scale) if isinstance(v, Int8Leaf) else (v,)):
            total += t.numel() * t.element_size()
    return total


class Int8Linear(nn.Module):
    """``nn.Linear`` over an int8 weight ``[out, in]`` with one scale a
    row, dequantized each time it runs; the bias is the model's own."""

    def __init__(self, leaf: Int8Leaf, bias):
        super().__init__()
        if leaf.dim != 0:
            raise ValueError("an Int8Linear weight takes one scale a row")
        self.register_buffer("qweight", leaf.q)
        self.register_buffer("scale", leaf.scale)
        self.bias = bias
        self.dtype = leaf.dtype

    def forward(self, x):
        # one f32 temporary (multiplied in place): inside a captured graph
        # its memory is reused by the next linear's
        w = self.qweight.to(self.dtype)
        return tF.linear(x, w.mul_(self.scale[:, None].to(self.dtype)),
                         self.bias)


class Int8Embedding(nn.Module):
    """``nn.Embedding`` over an int8 table ``[V, h]`` with one scale a
    column: a lookup dequantizes only the rows it gathers; ``weight`` is
    the whole dequantized table (the tied LM head's product)."""

    def __init__(self, leaf: Int8Leaf):
        super().__init__()
        if leaf.dim != 1:
            raise ValueError("an Int8Embedding table takes one scale a "
                             "column")
        self.register_buffer("qweight", leaf.q)
        self.register_buffer("scale", leaf.scale)
        self.dtype = leaf.dtype

    @property
    def weight(self):
        return self.qweight.to(self.dtype).mul_(self.scale.to(self.dtype))

    def forward(self, ids):
        return tF.embedding(ids, self.qweight).to(self.dtype).mul_(
            self.scale.to(self.dtype))


def quantize_model(model: nn.Module):
    """``(serving copy, stored bytes)``: a copy of ``model`` whose
    ``nn.Linear`` and ``nn.Embedding`` modules hold int8 weights
    (:class:`Int8Linear`, :class:`Int8Embedding`) and whose other modules
    and parameters are the model's own; the bytes are
    :func:`state_bytes` of the quantized state.  ``model`` is unchanged."""
    linear = {f"{n}.weight" for n, m in model.named_modules()
              if isinstance(m, nn.Linear)}
    with torch.no_grad():
        packed = quantize_state(model.state_dict(), transposed=linear)

    def swap(mod, prefix):
        new = copy.copy(mod)
        new._modules = {}
        for name, child in mod._modules.items():
            key = f"{prefix}{name}"
            if isinstance(child, nn.Linear):
                child = Int8Linear(packed[f"{key}.weight"], child.bias)
            elif isinstance(child, nn.Embedding):
                child = Int8Embedding(packed[f"{key}.weight"])
            elif child is not None:
                child = swap(child, f"{key}.")
            new._modules[name] = child
        return new

    return swap(model, ""), state_bytes(packed)
