"""``paddle_tpu.incubate.multiprocessing`` counterpart: the port's Tensors
across Python processes, through POSIX shared memory.

``init_reductions()`` registers a reducer for the port's ``Tensor`` class
(only: torch's own tensors keep the reducers ``torch.multiprocessing``
gives them) on ``ForkingPickler``.  The reducer copies the tensor's
bytes to the host, into a new shared-memory segment, and pickles only
the segment's name, the shape and the dtype's name; bf16, which numpy
lacks, travels as its int16 bits.  The consumer copies the bytes out,
unlinks the segment and rebuilds the tensor on its current place (the
card unless it set the CPU).

The delivery contract is the JAX package's:

* each sent tensor is rebuilt exactly once (fan-out sends one message a
  consumer);
* at most 64 segments are in flight on the producer's side; an older one
  leaves the window (its name is kept, in case no consumer has rebuilt
  it);
* an ``atexit`` hook unlinks what is left, so nothing outlives the
  process in ``/dev/shm``.

    import paddle_tpu_torch.incubate.multiprocessing as mp
    q = mp.Queue()            # a spawn context with the reducer
    q.put(tensor)
"""
from __future__ import annotations

import atexit
import multiprocessing as _std_mp
from multiprocessing import shared_memory
from multiprocessing.reduction import ForkingPickler

import numpy as np
import torch

from ...core import place as place_mod
from ...core.tensor import Tensor

__all__ = ["init_reductions", "Queue", "Pipe", "Process", "get_context"]

_INITIALIZED = False
WINDOW = 64
# the producer's segments, alive until the consumer rebuilds (and
# unlinks) them; bounded by WINDOW
_LIVE_SEGMENTS: list = []
# names that left the window before a consumer may have rebuilt them:
# unlinked at exit
_EVICTED_NAMES: list = []
# dtypes numpy lacks, sent as the bits of a numpy dtype of their width
_VIEWS = {torch.bfloat16: torch.int16}


def _cleanup_segments():
    for shm in _LIVE_SEGMENTS:
        try:
            shm.close()
            shm.unlink()
        except Exception:
            pass
    for name in _EVICTED_NAMES:
        try:
            s = shared_memory.SharedMemory(name=name)
            s.close()
            s.unlink()
        except Exception:
            pass
    _LIVE_SEGMENTS.clear()
    _EVICTED_NAMES.clear()


atexit.register(_cleanup_segments)


def _rebuild_tensor_from_shm(shm_name: str, shape, dtype_name: str,
                             stop_gradient: bool):
    dtype = getattr(torch, dtype_name)
    wire = _VIEWS.get(dtype, dtype)
    shm = shared_memory.SharedMemory(name=shm_name)
    try:
        arr = np.ndarray(shape, dtype=torch.empty((), dtype=wire).numpy()
                         .dtype, buffer=shm.buf).copy()
    finally:
        shm.close()
        try:
            shm.unlink()
        except FileNotFoundError:
            pass
    value = torch.from_numpy(arr)
    if wire is not dtype:
        value = value.view(dtype)
    t = Tensor._wrap(value.to(place_mod.current_device()))
    t.stop_gradient = stop_gradient
    return t


def _reduce_tensor(t: Tensor):
    value = t._value.detach()
    wire = _VIEWS.get(value.dtype)
    host = value.cpu().contiguous()
    arr = (host.view(wire) if wire is not None else host).numpy()
    shm = shared_memory.SharedMemory(create=True, size=max(1, arr.nbytes))
    np.ndarray(arr.shape, dtype=arr.dtype, buffer=shm.buf)[...] = arr
    _LIVE_SEGMENTS.append(shm)
    if len(_LIVE_SEGMENTS) > WINDOW:
        old = _LIVE_SEGMENTS.pop(0)
        old.close()
        # a consumer may have rebuilt it already (the name is gone and the
        # unlink at exit does nothing); if not, it is unlinked at exit
        _EVICTED_NAMES.append(old.name)
    return (_rebuild_tensor_from_shm,
            (shm.name, tuple(arr.shape), str(value.dtype).split(".")[-1],
             t.stop_gradient))


def init_reductions() -> None:
    """Register the Tensor reducer on ``ForkingPickler``."""
    global _INITIALIZED
    if _INITIALIZED:
        return
    ForkingPickler.register(Tensor, _reduce_tensor)
    _INITIALIZED = True


# the reference re-exports multiprocessing with the reducer installed
def get_context(method=None):
    init_reductions()
    return _std_mp.get_context(method)


def Queue(*args, **kwargs):
    init_reductions()
    return _std_mp.get_context("spawn").Queue(*args, **kwargs)


def Pipe(duplex=True):
    init_reductions()
    return _std_mp.get_context("spawn").Pipe(duplex)


def Process(*args, **kwargs):
    init_reductions()
    return _std_mp.get_context("spawn").Process(*args, **kwargs)
