"""Batched LoRA adapters for the serving path (host factors + model scope).

The port's counterpart of ``paddle_tpu/serving/adapters/lora.py``.  A
:class:`LoraAdapter` holds the low-rank update of each layer's fused-qkv
projection, ``W + scale * A @ B`` with ``A [h, r]`` and ``B [r, 3h]`` per
layer in the JAX layout (``W [h, 3h]``; the port's ``qkv_proj.weight`` is
its transpose ``[3h, h]``).  Both packages use the head-major ``[nh, 3,
hd]`` column order, so B's columns carry across as they are.

The engine stacks every resident adapter into fixed-shape device banks::

    a_bank [max_resident + 1, num_layers, h, r_max]
    b_bank [max_resident + 1, num_layers, r_max, 3h]
    scales [max_resident + 1]

Row 0 is the zero adapter (zero factors at scale 0): a base request adds
an exactly-zero delta, so base rows and adapter rows share one forward.
While the engine's forward runs inside :func:`adapter_scope` (per-row
bank ids and the banks), ``GPTSelfAttention`` adds the gathered per-row
delta to its fused qkv after the base projection::

    a = a_bank[ids, layer]; b = b_bank[ids, layer]
    qkv += (x @ a @ b) * scales[ids]

Every operand has a fixed shape, so the adapter mix never changes the
decode graph.  Host weights, validation and bank residency live in
:mod:`.registry`.
"""
from __future__ import annotations

import contextlib
import threading
from typing import List, Optional

import numpy as np
import torch

__all__ = ["LoraAdapter", "make_lora", "merge_into_qkv", "adapter_scope",
           "active"]


class LoraAdapter:
    """Host-side LoRA factors for every decoder layer's fused-qkv
    projection.

    Args:
        name: registry key.
        a: per-layer down-projections, each ``[hidden, rank]`` float32.
        b: per-layer up-projections, each ``[rank, 3 * hidden]`` float32.
        scale: the merged update is ``W + scale * A @ B``.
    """

    __slots__ = ("name", "a", "b", "scale", "rank")

    def __init__(self, name: str, a: List[np.ndarray], b: List[np.ndarray],
                 scale: float = 1.0):
        if not a or len(a) != len(b):
            raise ValueError(
                f"adapter {name!r}: need matching per-layer A/B lists, "
                f"got {len(a)} A / {len(b)} B")
        self.name = str(name)
        self.a = [np.asarray(m, np.float32) for m in a]
        self.b = [np.asarray(m, np.float32) for m in b]
        self.scale = float(scale)
        ranks = {m.shape[-1] for m in self.a} | {m.shape[0] for m in self.b}
        if len(ranks) != 1:
            raise ValueError(
                f"adapter {name!r}: inconsistent ranks across layers/"
                f"factors: {sorted(ranks)}")
        self.rank = int(next(iter(ranks)))
        for i, (ma, mb) in enumerate(zip(self.a, self.b)):
            if ma.ndim != 2 or mb.ndim != 2 or ma.shape[1] != mb.shape[0]:
                raise ValueError(
                    f"adapter {name!r} layer {i}: A {ma.shape} / B "
                    f"{mb.shape} do not compose")

    @property
    def num_layers(self) -> int:
        return len(self.a)

    def __repr__(self):
        return (f"LoraAdapter(name={self.name!r}, rank={self.rank}, "
                f"layers={self.num_layers}, scale={self.scale})")


def make_lora(config, rank: int, seed: int = 0, scale: Optional[float] = None,
              name: str = "lora", std: float = 0.02) -> LoraAdapter:
    """Random LoRA factors shaped for ``config``, with the JAX package's
    ``RandomState`` draws (the same seed gives the same factors);
    ``scale`` defaults to ``1 / rank``."""
    rs = np.random.RandomState(seed)
    h = config.hidden_size
    a = [rs.normal(0.0, std, (h, rank)).astype(np.float32)
         for _ in range(config.num_layers)]
    b = [rs.normal(0.0, std, (rank, 3 * h)).astype(np.float32)
         for _ in range(config.num_layers)]
    return LoraAdapter(name, a, b,
                       scale=(1.0 / rank) if scale is None else scale)


def merge_into_qkv(model, adapter: LoraAdapter):
    """Fold ``scale * A @ B`` into each layer's fused-qkv weight in place
    (the merged-weights reference the batched path is held against).  The
    port's weight is ``[3h, h]``, so the transpose of the JAX delta is
    added.  Merge into a throwaway model: there is no unmerge."""
    gpt = getattr(model, "gpt", model)
    layers = gpt.layers
    if len(layers) != adapter.num_layers:
        raise ValueError(
            f"adapter {adapter.name!r} has {adapter.num_layers} layers, "
            f"model has {len(layers)}")
    with torch.no_grad():
        for i, layer in enumerate(layers):
            w = layer.self_attn.qkv_proj.weight
            delta = adapter.scale * (adapter.a[i] @ adapter.b[i])
            w.add_(torch.from_numpy(np.ascontiguousarray(delta.T)).to(
                device=w.device, dtype=w.dtype))


# -- the thread's adapter scope (the engine's forwards enter it) ---------------

_TLS = threading.local()


class _AdapterScope:
    """The operands of one batched-adapter forward.  ``layer`` is advanced
    by ``GPTModel.forward`` as it walks the decoder stack."""

    __slots__ = ("ids", "a_bank", "b_bank", "scales", "layer")

    def __init__(self, ids, a_bank, b_bank, scales):
        self.ids = ids            # [B] int64: bank row per batch row
        self.a_bank = a_bank      # [R+1, L, h, r_max]
        self.b_bank = b_bank      # [R+1, L, r_max, 3h]
        self.scales = scales      # [R+1] f32
        self.layer = 0

    def delta_qkv(self, x):
        """Per-row LoRA delta for the current layer's fused qkv: ``x`` is
        the projection's input ``[B, T, h]``; returns ``[B, T, 3h]``.  Rows
        at id 0 gather the zero adapter, so their delta is exactly 0."""
        a = self.a_bank[self.ids, self.layer].to(x.dtype)     # [B, h, r]
        b = self.b_bank[self.ids, self.layer].to(x.dtype)     # [B, r, 3h]
        s = self.scales[self.ids].to(x.dtype)                 # [B]
        return torch.bmm(torch.bmm(x, a), b) * s[:, None, None]


@contextlib.contextmanager
def adapter_scope(ids, a_bank, b_bank, scales):
    """Apply the batched adapters to the model forwards this thread runs
    inside the block."""
    prev = getattr(_TLS, "scope", None)
    _TLS.scope = _AdapterScope(ids, a_bank, b_bank, scales)
    try:
        yield _TLS.scope
    finally:
        _TLS.scope = prev


def active() -> Optional[_AdapterScope]:
    """The thread's live adapter scope, or None outside one."""
    return getattr(_TLS, "scope", None)
