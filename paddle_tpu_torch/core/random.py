"""Random state of the port (``paddle_tpu.core.random`` counterpart).

The port's random ops draw from ``torch.Generator``s that it owns, one
for each device, made on first use and seeded from :func:`seed` (0 until
it is called).  torch's global generator is never touched, so models,
dropout and the tests' own draws keep their streams.  The draws cannot
equal the JAX package's (its keys are functional); what holds across the
packages is shape, dtype, range, moments and same-seed determinism.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["seed", "get_rng_state", "set_rng_state", "generator"]

_seed = 0
_generators: dict = {}
_lock = threading.Lock()


def seed(value: int):
    """paddle.seed — reseed every generator (and those made later)."""
    global _seed
    with _lock:
        _seed = int(value)
        for g in _generators.values():
            g.manual_seed(_seed)


def generator(device) -> torch.Generator:
    """The port's generator for ``device``."""
    key = str(torch.device(device))
    g = _generators.get(key)
    if g is None:
        with _lock:
            g = _generators.get(key)
            if g is None:
                g = torch.Generator(device=key).manual_seed(_seed)
                _generators[key] = g
    return g


def get_rng_state() -> dict:
    """``{device: state}`` of every generator made so far."""
    return {k: g.get_state() for k, g in _generators.items()}


def set_rng_state(state: dict):
    for k, s in state.items():
        generator(k).set_state(s)
