"""Runtime flags (``paddle_tpu.flags`` counterpart): ``paddle.set_flags``
/ ``get_flags`` over the JAX package's 13 flags and defaults, each also
read from a ``FLAGS_*`` environment variable when the module loads.  An
unknown flag raises.  Every ``set_flags`` change is recorded in the
flight ring (``observability.flight``), so a crash dump names the flags
that were live.

Two flags act: ``FLAGS_check_nan_inf`` is ``core.op.CHECK_NAN_INF`` (every
op's floating outputs scanned), ``FLAGS_telemetry`` is
``observability.enable``.  The others (the reference's allocator and
cuDNN settings) are recorded only, as in the JAX package.
"""
from __future__ import annotations

import os

__all__ = ["set_flags", "get_flags"]

_FLAGS: dict[str, object] = {
    "FLAGS_check_nan_inf": False,
    "FLAGS_telemetry": False,
    "FLAGS_cudnn_deterministic": False,
    "FLAGS_allocator_strategy": "auto_growth",
    "FLAGS_fraction_of_gpu_memory_to_use": 0.92,
    "FLAGS_eager_delete_tensor_gb": 0.0,
    "FLAGS_use_pinned_memory": True,
    "FLAGS_benchmark": False,
    "FLAGS_paddle_num_threads": 1,
    "FLAGS_max_inplace_grad_add": 0,
    "FLAGS_conv_workspace_size_limit": 512,
    "FLAGS_cudnn_exhaustive_search": False,
    "FLAGS_selected_devices": "",
}


def _coerce(old, value):
    if isinstance(old, bool):
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    if isinstance(old, int):
        return int(value)
    if isinstance(old, float):
        return float(value)
    return value


def _key(name: str) -> str:
    key = name if name.startswith("FLAGS_") else f"FLAGS_{name}"
    if key not in _FLAGS:
        raise ValueError(f"unknown flag {name!r}")
    return key


def _sync(key: str):
    if key == "FLAGS_check_nan_inf":
        from .core import op
        op.CHECK_NAN_INF = bool(_FLAGS[key])
    elif key == "FLAGS_telemetry":
        from . import observability
        observability.enable(bool(_FLAGS[key]))


def set_flags(flags: dict):
    """``paddle.set_flags``: names with or without the ``FLAGS_``
    prefix; an unknown one raises ``ValueError``."""
    from .observability import flight
    for k, v in flags.items():
        key = _key(k)
        _FLAGS[key] = _coerce(_FLAGS[key], v)
        flight.record("flag", key, value=str(_FLAGS[key]))
        _sync(key)


def get_flags(flags):
    """``paddle.get_flags``: a name or a list of names -> ``{FLAGS_name:
    value}``."""
    keys = [flags] if isinstance(flags, str) else list(flags)
    return {_key(k): _FLAGS[_key(k)] for k in keys}


def _bootstrap_from_env():
    for key in _FLAGS:
        if key in os.environ:
            _FLAGS[key] = _coerce(_FLAGS[key], os.environ[key])
            if _FLAGS[key]:
                _sync(key)


_bootstrap_from_env()
