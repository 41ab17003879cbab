"""AdapterRegistry — named LoRA adapters + device bank residency.

The port's own copy of ``paddle_tpu/serving/adapters/registry.py`` (pure
Python: the port imports nothing of the JAX package).

Two concerns, deliberately split the way the prefix cache splits content
from pool slots:

* :class:`AdapterRegistry` is the PERSISTENT side: named host-resident
  :class:`~paddle_tpu_torch.serving.adapters.lora.LoraAdapter` weights,
  validated against the base model's shape at ``register()`` time.  It
  survives engine rebuilds (a supervisor's factory hands the same
  registry to every build).

* :class:`AdapterResidency` is the PER-ENGINE-BUILD side, mirroring the
  prefix cache's refcount+LRU design: a fixed-capacity device bank
  (``max_resident`` rows; row 0 is the reserved zero adapter) where an
  adapter must be resident before any of its requests can decode.
  Admission **pins** the adapter (``refs += 1``) for the request's
  lifetime; eviction only reclaims rows with ``refs == 0`` (LRU), so a
  bank row feeding in-flight decode rows can never be reloaded under
  them.  A cold adapter is loaded at admission time; when every bank row
  is pinned the request stays QUEUED — the same head-of-line
  backpressure semantics as page exhaustion (admitted work never waits,
  so the queue always drains).  The residency object dies with its
  engine build: a supervisor rebuild starts with fresh banks and zero
  pins (asserted via :meth:`AdapterResidency.check`).

Typed errors: ``UnknownAdapterError`` (unregistered name at submit),
``AdapterShapeError`` (register() shape/rank mismatch vs the base model
or a previous registration of the same name), ``AdapterRankError``
(rank can NEVER fit the bank width — raised at submit, like the paged
pool's never-fits ValueError).
"""
from __future__ import annotations

import itertools
import threading
from typing import Dict, List, Optional, Tuple

from .lora import LoraAdapter

__all__ = ["AdapterError", "UnknownAdapterError", "AdapterShapeError",
           "AdapterRankError", "AdapterRegistry", "AdapterResidency"]


class AdapterError(ValueError):
    """Base for adapter registry/residency errors."""


class UnknownAdapterError(AdapterError):
    """The request names an adapter nobody registered."""


class AdapterShapeError(AdapterError):
    """register() found factors that don't match the base model (or a
    same-name registration with different shapes)."""


class AdapterRankError(AdapterError):
    """The adapter's rank exceeds the bank width (``max_rank``): it can
    never become resident, so submit fails fast instead of queueing a
    request that would wait forever."""


class AdapterRegistry:
    """Named adapters for ONE base model (see module doc).

    Args:
        model_or_config: the base model (``GPTForPretraining``/
            ``GPTModel``) or its ``GPTConfig`` — fixes the per-layer
            shapes every ``register()`` validates against.
        max_resident: device bank rows available to engines built over
            this registry (row 0 — the zero adapter — is extra).
        max_rank: bank width; adapters with smaller rank are zero-padded,
            larger ranks are rejected at submit (AdapterRankError).
    """

    def __init__(self, model_or_config, *, max_resident: int = 4,
                 max_rank: int = 8):
        cfg = getattr(getattr(model_or_config, "gpt", model_or_config),
                      "config", model_or_config)
        hidden = getattr(cfg, "hidden_size", None)
        layers = getattr(cfg, "num_layers", None)
        if not hidden or not layers:
            raise AdapterError(
                "AdapterRegistry needs a GPT-style model or config "
                "(hidden_size + num_layers) to validate adapters against")
        self.hidden = int(hidden)
        self.num_layers = int(layers)
        self.max_resident = int(max_resident)
        self.max_rank = int(max_rank)
        if self.max_resident < 1 or self.max_rank < 1:
            raise AdapterError("need max_resident >= 1 and max_rank >= 1")
        # callers' threads resolve names while the engine's scheduler
        # loads — one small lock covers the dict
        self._lock = threading.Lock()
        self._adapters: Dict[str, LoraAdapter] = {}

    def register(self, adapter: LoraAdapter) -> LoraAdapter:
        """Add (or re-register) ``adapter`` under its name.  Shapes are
        validated against the base model; a double-register of the same
        name must present the SAME rank/shapes (anything else is a
        config error, not an update — raise, don't silently swap)."""
        if not isinstance(adapter, LoraAdapter):
            raise AdapterError(f"expected a LoraAdapter, got "
                               f"{type(adapter).__name__}")
        if adapter.num_layers != self.num_layers:
            raise AdapterShapeError(
                f"adapter {adapter.name!r} has {adapter.num_layers} "
                f"layers; base model has {self.num_layers}")
        want_a = (self.hidden, adapter.rank)
        want_b = (adapter.rank, 3 * self.hidden)
        for i, (a, b) in enumerate(zip(adapter.a, adapter.b)):
            if a.shape != want_a or b.shape != want_b:
                raise AdapterShapeError(
                    f"adapter {adapter.name!r} layer {i}: A {a.shape} / "
                    f"B {b.shape}, expected A {want_a} / B {want_b}")
        with self._lock:
            prev = self._adapters.get(adapter.name)
            if prev is not None and prev.rank != adapter.rank:
                raise AdapterShapeError(
                    f"adapter {adapter.name!r} already registered with "
                    f"rank {prev.rank}; re-register must keep the shape "
                    f"(got rank {adapter.rank})")
            self._adapters[adapter.name] = adapter
        return adapter

    def get(self, name: str) -> LoraAdapter:
        with self._lock:
            a = self._adapters.get(name)
        if a is None:
            raise UnknownAdapterError(
                f"adapter {name!r} is not registered "
                f"(known: {sorted(self._adapters)})")
        return a

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._adapters)

    def __contains__(self, name) -> bool:
        with self._lock:
            return name in self._adapters

    def __len__(self) -> int:
        with self._lock:
            return len(self._adapters)

    def residency(self) -> "AdapterResidency":
        """A fresh per-engine-build residency tracker (fresh banks, zero
        pins — called once per Engine construction)."""
        return AdapterResidency(self.max_resident)

    def bank_nbytes(self) -> int:
        """Device bytes of the stacked f32 banks an engine builds over
        this registry (A + B factors + scales, ``max_resident + 1`` rows
        incl. the zero adapter)."""
        rows = self.max_resident + 1
        a = rows * self.num_layers * self.hidden * self.max_rank
        b = rows * self.num_layers * self.max_rank * 3 * self.hidden
        return 4 * (a + b + rows)

    def __repr__(self):
        return (f"AdapterRegistry(adapters={len(self)}, "
                f"max_resident={self.max_resident}, "
                f"max_rank={self.max_rank})")


class _Resident:
    __slots__ = ("name", "slot", "refs", "tick", "loaded")

    def __init__(self, name: str, slot: int, tick: int):
        self.name = name
        self.slot = slot          # bank row (1..max_resident)
        self.refs = 0             # in-flight requests pinned on this row
        self.tick = tick          # LRU clock: touched on every acquire
        self.loaded = False       # device bank row holds the weights


class AdapterResidency:
    """Host-side bank bookkeeping for one engine build (engine-lock
    guarded by the caller, like SlotPool/PrefixIndex — no device arrays
    live here; the engine owns the banks the slots index into)."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._by_name: Dict[str, _Resident] = {}
        self._free: List[int] = list(range(self.capacity, 0, -1))  # pop->1
        self._clock = itertools.count(1)
        self.hits = 0
        self.loads = 0
        self.evictions = 0

    @property
    def n_resident(self) -> int:
        return len(self._by_name)

    @property
    def n_pinned(self) -> int:
        return sum(1 for r in self._by_name.values() if r.refs > 0)

    def slot_of(self, name: str) -> Optional[int]:
        r = self._by_name.get(name)
        return None if r is None else r.slot

    def acquire(self, name: str) -> Optional[Tuple[int, bool]]:
        """Pin ``name`` for one in-flight request.  Returns
        ``(bank_slot, is_cold)`` — ``is_cold`` means the caller must
        upload the weights into the bank row (admission-time load of a
        cold adapter) — or None when every bank row is pinned by other
        in-flight work (the caller leaves the request queued:
        backpressure, not failure)."""
        r = self._by_name.get(name)
        if r is not None:
            r.refs += 1
            r.tick = next(self._clock)
            self.hits += 1
            return r.slot, not r.loaded
        if self._free:
            slot = self._free.pop()
        else:
            victims = sorted((x for x in self._by_name.values()
                              if x.refs == 0), key=lambda x: x.tick)
            if not victims:
                return None                  # every row pinned: wait
            v = victims[0]
            del self._by_name[v.name]
            self.evictions += 1
            slot = v.slot
        r = _Resident(name, slot, next(self._clock))
        r.refs = 1
        self._by_name[name] = r
        self.loads += 1
        return slot, True

    def mark_loaded(self, name: str):
        """The engine finished uploading the row (weights now on the device)."""
        self._by_name[name].loaded = True

    def release(self, name: str):
        """Unpin one in-flight reference (request retired/evicted/died).
        The row stays RESIDENT at refs 0 — a later request re-pins it
        without a reload; only LRU pressure reclaims it."""
        r = self._by_name.get(name)
        if r is not None and r.refs > 0:
            r.refs -= 1

    def check(self):
        """Zero leaked pins (teardown assert): after every request
        unwound, no bank row may still be pinned."""
        pinned = {r.name: r.refs for r in self._by_name.values()
                  if r.refs > 0}
        if pinned:
            raise AssertionError(f"leaked adapter pins: {pinned}")

    def stats(self) -> dict:
        return {"resident": self.n_resident, "pinned": self.n_pinned,
                "capacity": self.capacity, "hits": self.hits,
                "loads": self.loads, "evictions": self.evictions}

    def __repr__(self):
        return (f"AdapterResidency(resident={self.n_resident}/"
                f"{self.capacity}, pinned={self.n_pinned}, "
                f"loads={self.loads}, evictions={self.evictions})")
