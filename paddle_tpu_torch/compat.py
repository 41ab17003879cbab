"""paddle.compat (``paddle_tpu.compat``, a copy): the reference's
py2/3 helpers (to_text:25, to_bytes:121, round:206, floor_division:232,
get_exception_message:249) that some reference model-zoo code imports."""
from __future__ import annotations

__all__ = ["to_text", "to_bytes", "round", "floor_division",
           "get_exception_message"]


def to_text(obj, encoding="utf-8", inplace=False):
    """Decode bytes (recursively through list/set/dict) to str."""
    if obj is None:
        return obj
    if isinstance(obj, list):
        if inplace:
            obj[:] = [to_text(i, encoding) for i in obj]
            return obj
        return [to_text(i, encoding) for i in obj]
    if isinstance(obj, set):
        if inplace:
            vals = [to_text(i, encoding) for i in obj]
            obj.clear()
            obj.update(vals)
            return obj
        return set(to_text(i, encoding) for i in obj)
    if isinstance(obj, dict):
        if inplace:
            new = {to_text(k, encoding): to_text(v, encoding)
                   for k, v in obj.items()}
            obj.clear()
            obj.update(new)
            return obj
        return {to_text(k, encoding): to_text(v, encoding)
                for k, v in obj.items()}
    return _to_text(obj, encoding)


def _to_text(obj, encoding):
    if obj is None:
        return obj
    if isinstance(obj, bytes):
        return obj.decode(encoding)
    if isinstance(obj, str):
        return obj
    return str(obj)


def to_bytes(obj, encoding="utf-8", inplace=False):
    """Encode str (recursively through list/set) to bytes."""
    if obj is None:
        return obj
    if isinstance(obj, list):
        if inplace:
            obj[:] = [to_bytes(i, encoding) for i in obj]
            return obj
        return [to_bytes(i, encoding) for i in obj]
    if isinstance(obj, set):
        if inplace:
            vals = [to_bytes(i, encoding) for i in obj]
            obj.clear()
            obj.update(vals)
            return obj
        return set(to_bytes(i, encoding) for i in obj)
    return _to_bytes(obj, encoding)


def _to_bytes(obj, encoding):
    if obj is None:
        return obj
    if isinstance(obj, str):
        return obj.encode(encoding)
    if isinstance(obj, bytes):
        return obj
    return str(obj).encode(encoding)


def round(x, d=0):
    """Python-2-style round: half away from zero (reference compat.py:206
    keeps the legacy semantics)."""
    import math
    if x > 0.0:
        p = 10 ** d
        return float(math.floor((x * p) + math.copysign(0.5, x))) / p
    if x < 0.0:
        p = 10 ** d
        return float(math.ceil((x * p) + math.copysign(0.5, x))) / p
    return math.copysign(0.0, x)


def floor_division(x, y):
    return x // y


def get_exception_message(exc):
    assert exc is not None
    return str(exc)
