"""Shared-memory batch channel for DataLoader workers — Python side of
``io/csrc/shm_ring.cpp`` (the port's copy of
``paddle_tpu/io/shm_channel.py``; reference: shared-memory tensor transfer
in fluid/dataloader/dataloader_iter.py + use_shared_memory flag).

Numpy batches cross the process boundary as raw bytes in a POSIX shm ring:
no pickle for array payloads; a compact header carries dtype/shape.  The
ring's source is built with ``g++`` at first use into the port's build
directory (``utils/native_build.py``); where the JAX package falls back to
a pickling queue without a toolchain, the port raises: a
``DataLoader(use_shared_memory=True)`` whose ring cannot be built fails
loudly (``use_shared_memory=False`` takes the pickling queue).
"""
from __future__ import annotations

import ctypes
import os
import pickle
import struct
import uuid

import numpy as np

_LIB = None
_LIB_ERR = None


def _build():
    from ..utils.native_build import build_native_lib

    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                       "shm_ring.cpp")
    return build_native_lib(src, "libshm_ring.so", extra_flags=("-lrt",))


def _lib():
    global _LIB, _LIB_ERR
    if _LIB is not None or _LIB_ERR is not None:
        return _LIB
    try:
        lib = ctypes.CDLL(_build())
        lib.shmring_create.restype = ctypes.c_void_p
        lib.shmring_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                       ctypes.c_int]
        lib.shmring_open.restype = ctypes.c_void_p
        lib.shmring_open.argtypes = [ctypes.c_char_p]
        lib.shmring_write.restype = ctypes.c_int
        lib.shmring_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_uint64, ctypes.c_int]
        lib.shmring_read.restype = ctypes.c_longlong
        lib.shmring_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_uint64, ctypes.c_int,
                                     ctypes.POINTER(ctypes.c_uint64)]
        lib.shmring_close.argtypes = [ctypes.c_void_p]
        lib.shmring_free.argtypes = [ctypes.c_void_p]
        _LIB = lib
    except Exception as e:  # noqa: BLE001 — kept, raised by ShmQueue
        _LIB_ERR = e
    return _LIB


def available() -> bool:
    """True when the ring's library is built (building it if needed)."""
    return _lib() is not None


# -- batch codec -------------------------------------------------------------
# message: u64 bid | u8 kind | payload
#   kind 0 = tuple of arrays, 2 = list of arrays, 3 = single bare array
#   kind 1 = pickled python object (exceptions, odd collations)
#   arrays payload: u32 count | per array: u16 dtype_len, dtype, u8 ndim,
#                   u64*ndim shape, u64 nbytes, raw
def encode_batch(bid: int, batch) -> bytes:
    if isinstance(batch, np.ndarray):
        kind, arrays = 3, [batch]
    elif isinstance(batch, list):
        kind, arrays = 2, batch
    elif isinstance(batch, tuple):
        kind, arrays = 0, list(batch)
    else:
        kind, arrays = 1, None
    if kind != 1 and all(isinstance(a, np.ndarray) and a.dtype != object
                         for a in arrays):
        parts = [struct.pack("<QB", bid, kind)]
        parts.append(struct.pack("<I", len(arrays)))
        for a in arrays:
            a = np.ascontiguousarray(a)
            dt = a.dtype.str.encode()
            parts.append(struct.pack("<H", len(dt)))
            parts.append(dt)
            parts.append(struct.pack("<B", a.ndim))
            parts.append(struct.pack(f"<{a.ndim}Q", *a.shape) if a.ndim
                         else b"")
            parts.append(struct.pack("<Q", a.nbytes))
            parts.append(a.tobytes())
        return b"".join(parts)
    return struct.pack("<QB", bid, 1) + pickle.dumps(batch, protocol=4)


def decode_batch(data: bytes):
    bid, kind = struct.unpack_from("<QB", data, 0)
    off = 9
    if kind == 1:
        return bid, pickle.loads(data[off:])
    (count,) = struct.unpack_from("<I", data, off)
    off += 4
    arrays = []
    for _ in range(count):
        (dlen,) = struct.unpack_from("<H", data, off)
        off += 2
        dtype = np.dtype(data[off:off + dlen].decode())
        off += dlen
        (ndim,) = struct.unpack_from("<B", data, off)
        off += 1
        shape = struct.unpack_from(f"<{ndim}Q", data, off) if ndim else ()
        off += 8 * ndim
        (nbytes,) = struct.unpack_from("<Q", data, off)
        off += 8
        arr = np.frombuffer(data, dtype=dtype, count=nbytes // dtype.itemsize,
                            offset=off).reshape(shape)
        off += nbytes
        arrays.append(arr)
    if kind == 3:
        return bid, arrays[0]
    return bid, (arrays if kind == 2 else tuple(arrays))


class ShmQueue:
    """One-direction message queue over the native ring."""

    def __init__(self, capacity=64 << 20, name=None, create=True,
                 linger=False):
        """linger=False (default) unlinks the shm name right after creation:
        the segment lives exactly as long as its (fork-inherited) mappings,
        so crashed runs can never leak /dev/shm memory.  linger=True keeps
        the name so unrelated processes can `open_peer()` by name — the
        creator must then call free()."""
        lib = _lib()
        if lib is None:
            raise RuntimeError(f"shm ring unavailable: {_LIB_ERR}")
        self.name = name or f"/pt_ring_{os.getpid()}_{uuid.uuid4().hex[:8]}"
        self._linger = linger
        if create:
            self._h = lib.shmring_create(self.name.encode(), capacity,
                                         1 if linger else 0)
        else:
            self._h = lib.shmring_open(self.name.encode())
        if not self._h:
            raise RuntimeError(f"shm ring {self.name} setup failed")
        self._closed = False

    def open_peer(self) -> "ShmQueue":
        """Handle for a non-forked peer (reopen by name; needs linger=True).
        Forked children simply inherit this object's mapping."""
        if self._linger is False:
            raise RuntimeError(
                "open_peer needs ShmQueue(linger=True); forked children "
                "inherit the mapping and don't need it")
        return ShmQueue(name=self.name, create=False)

    def put(self, data: bytes, timeout_ms=-1):
        if self._closed or not self._h:
            raise BrokenPipeError("shm ring closed")
        rc = _lib().shmring_write(self._h, data, len(data), timeout_ms)
        if rc == -3:
            raise ValueError(
                f"message of {len(data)} bytes exceeds ring capacity; raise "
                "DataLoader(shm_ring_capacity=...) or shrink the batch")
        if rc == -2:
            raise TimeoutError("shm ring write timed out")
        if rc != 0:
            raise BrokenPipeError("shm ring closed")

    def get(self, timeout_ms=-1) -> bytes:
        if self._closed or not self._h:
            raise BrokenPipeError("shm ring closed")
        cap = 1 << 20
        need = ctypes.c_uint64(0)
        while True:
            buf = ctypes.create_string_buffer(cap)
            n = _lib().shmring_read(self._h, buf, cap, timeout_ms,
                                    ctypes.byref(need))
            if n == -3:
                cap = int(need.value) + 16
                continue
            if n == -2:
                raise TimeoutError("shm ring read timed out")
            if n < 0:
                raise BrokenPipeError("shm ring closed")
            return ctypes.string_at(buf, n)

    def close(self):
        if not self._closed and self._h:
            _lib().shmring_close(self._h)
            self._closed = True

    def free(self):
        if self._h:
            _lib().shmring_free(self._h)
            self._h = None
