"""Sharded + async checkpointing with torn-write detection and committed
markers (the port's copy of ``paddle_tpu/framework/checkpoint.py``;
SURVEY §5.4, robustness posture per CheckFreq / Varuna: preemption must
cost a resume, not a run).

Layout (the JAX package's, file for file): one `.npy` per tensor under the
checkpoint dir plus a `manifest.json` with the key → file/dtype/shape/CRC32
map and a ``COMMITTED`` marker file written LAST (after every data file and
the manifest are fsynced) — a directory without the marker is by definition
a torn checkpoint and is never offered for restore.  Either package reads
the other's checkpoints.

Where the port differs:

* **Snapshot isolation.**  The port's train steps update parameters and
  optimizer slots in place, so :meth:`AsyncCheckpointSaver.save` copies
  every leaf to host memory (device tensors with one device-to-host copy
  each, host tensors and arrays with a copy) before it returns; the
  writer thread only ever sees those copies.
* **bfloat16 leaves.**  numpy has no bfloat16: the port writes a bf16
  leaf as its 16-bit pattern in a ``'|V2'`` ``.npy`` (the JAX package's
  layout for an ``ml_dtypes`` bf16 leaf) with ``"dtype": "bfloat16"`` in
  the manifest, the CRC32 over the same bytes, and restores it as a
  bfloat16 tensor from the manifest's dtype (``return_numpy=True`` gives
  a CPU ``torch.bfloat16`` tensor for it, the one non-numpy leaf).
* **Mesh relayout** (``target_mesh``) raises ``NotImplementedError``:
  meshes are ROADMAP module item 11.

Validation: :func:`load_sharded` verifies the marker and every leaf's
CRC32 and raises :class:`CheckpointCorruptError` naming the bad leaf;
:meth:`AsyncCheckpointSaver.restore_latest_valid` walks backward past
corrupt/uncommitted checkpoints, quarantining them (``<dir>.corrupt``)
with a flight-recorder event, so a flipped bit in the newest checkpoint
costs one step of history, never the run.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zlib

import numpy as np
import torch

from ..core import place as place_mod
from ..core.tensor import Tensor
from ..testing import faults

_MANIFEST = "manifest.json"
_COMMITTED = "COMMITTED"

# metrics registry names (docs/observability.md)
CHECKPOINT_FAILURES_TOTAL = "paddle_tpu_checkpoint_failures_total"
CHECKPOINT_RETRIES_TOTAL = "paddle_tpu_checkpoint_retries_total"

# remote fs retry policy (bounded exponential backoff; docs/robustness.md)
_FS_TRIES = int(os.environ.get("PADDLE_TPU_CHECKPOINT_FS_TRIES", "3"))
_FS_BASE_DELAY = float(os.environ.get(
    "PADDLE_TPU_CHECKPOINT_FS_BASE_DELAY_S", "0.05"))


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed validation (missing COMMITTED marker, missing
    manifest/leaf file, or a CRC32 mismatch)."""

    def __init__(self, msg: str, dirname: str | None = None,
                 leaf: str | None = None):
        super().__init__(msg)
        self.dirname = dirname
        self.leaf = leaf


class ElasticReshardError(RuntimeError):
    """An elastic (cross-topology) restore could not lay a stored leaf out
    on the target mesh — shape not divisible by the requested axes, a spec
    naming an axis the mesh doesn't have, or a source/target state-tree
    mismatch.  The checkpoint itself is NOT corrupt: callers must never
    quarantine or otherwise mutate the checkpoint dir on this error."""

    def __init__(self, msg: str, leaf: str | None = None,
                 spec=None, mesh_axes: dict | None = None):
        super().__init__(msg)
        self.leaf = leaf
        self.spec = spec
        self.mesh_axes = dict(mesh_axes or {})


class ElasticResumeError(RuntimeError):
    """A world-size-aware resume could not map the checkpoint's global
    sample offset onto the new topology (offset not divisible by the new
    global batch).  The checkpoint is intact — pick a compatible
    batch-size x dp-world product, or resume on the original topology."""

    def __init__(self, msg: str, samples: int | None = None,
                 global_batch_size: int | None = None):
        super().__init__(msg)
        self.samples = samples
        self.global_batch_size = global_batch_size


def mesh_axes_of(mesh) -> dict:
    """``{axis_name: size}`` of a Mesh — the topology fingerprint stored
    in train-state checkpoints and quoted by elastic-restore errors."""
    if mesh is None:
        return {}
    return {str(a): int(mesh.shape[a]) for a in mesh.axis_names}


_BF16 = "bfloat16"


class _Bits:
    """A bfloat16 leaf on the host: its 16-bit pattern as a ``'|V2'``
    array (what ``np.save`` writes for an ``ml_dtypes`` bf16 array)."""

    __slots__ = ("array",)

    def __init__(self, t: torch.Tensor):
        self.array = t.detach().to("cpu", copy=True).contiguous().view(
            torch.int16).numpy().view("V2")

    @property
    def nbytes(self):
        return self.array.nbytes


def _host_copy(v):
    """``v`` as a host value that nothing else writes: tensors (surface
    or torch, on any device) and arrays are copied, bf16 as
    :class:`_Bits`."""
    if isinstance(v, Tensor):
        v = v._value
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            return _Bits(v)
        return v.detach().to("cpu", copy=True).resolve_conj().numpy()
    if isinstance(v, np.ndarray):
        return np.array(v, copy=True)
    arr = np.asarray(v)
    # non-numeric leaves (strings, python objects) stay as-is and go
    # into the manifest as JSON
    return arr if arr.dtype.kind not in "USO" else v


def _to_numpy_tree(state):
    out = {}
    for k, v in state.items():
        out[k] = _to_numpy_tree(v) if isinstance(v, dict) else _host_copy(v)
    return out


def _is_array(leaf) -> bool:
    return isinstance(leaf, _Bits) or (
        isinstance(leaf, np.ndarray) and leaf.dtype != object)


def _flatten(tree, prefix=""):
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(_flatten(v, f"{key}/"))
        else:
            flat[key] = v
    return flat


def _unflatten(flat):
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _crc32(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def _fsync_file(path: str):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str):
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # platforms without O_RDONLY dirs
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def is_committed(dirname: str) -> bool:
    """True when `dirname` holds a fully written checkpoint (marker file
    present — written last, so its existence implies the rest)."""
    return os.path.isfile(os.path.join(dirname, _COMMITTED))


def save_sharded(state: dict, dirname: str) -> None:
    """Write `state` (possibly nested state_dict) as per-tensor .npy files
    + manifest + COMMITTED marker.  Atomic: writes into `<dir>.tmp`
    (fsyncing every file and the marker) then renames."""
    from ..observability import trace as _trace
    with _trace.span("checkpoint.save", dir=dirname) as _sp:
        _save_sharded(state, dirname, _sp)


def _save_sharded(state: dict, dirname: str, _sp=None) -> None:
    flat = _flatten(_to_numpy_tree(state))
    if _sp is not None:
        _sp.attrs["leaves"] = len(flat)
        _sp.attrs["bytes"] = int(sum(
            v.nbytes for v in flat.values() if _is_array(v)))
    tmp = dirname + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {}
    scalars = {}
    for i, (key, leaf) in enumerate(flat.items()):
        if _is_array(leaf):
            dtype = _BF16 if isinstance(leaf, _Bits) else str(leaf.dtype)
            leaf = leaf.array if isinstance(leaf, _Bits) else leaf
            fname = f"t{i}.npy"
            fpath = os.path.join(tmp, fname)
            np.save(fpath, leaf)
            faults.fault_point("checkpoint.write", path=fpath, leaf=key)
            _fsync_file(fpath)
            manifest[key] = {"file": fname, "dtype": dtype,
                             "shape": list(leaf.shape),
                             "crc32": _crc32(leaf)}
        else:
            try:
                json.dumps(leaf)
                scalars[key] = leaf
            except TypeError:
                raise TypeError(
                    f"checkpoint leaf {key!r} of type {type(leaf).__name__} "
                    "is neither a numeric array nor JSON-serializable")
    mpath = os.path.join(tmp, _MANIFEST)
    with open(mpath, "w") as f:
        json.dump({"tensors": manifest, "scalars": scalars,
                   "ts": time.time(), "format": 2}, f)
    faults.fault_point("checkpoint.manifest", path=mpath)
    _fsync_file(mpath)
    # the commit point: the marker is written LAST and fsynced before the
    # atomic rename — a crash anywhere above leaves a marker-less dir that
    # validation treats as torn
    faults.fault_point("checkpoint.commit")
    cpath = os.path.join(tmp, _COMMITTED)
    with open(cpath, "w") as f:
        json.dump({"ts": time.time(), "leaves": len(flat)}, f)
    _fsync_file(cpath)
    _fsync_dir(tmp)
    # crash-safe promote: move the old copy ASIDE first so there is always
    # at least one complete checkpoint on disk, delete it only last
    faults.fault_point("checkpoint.promote")
    old = dirname + ".old"
    if os.path.exists(old):
        shutil.rmtree(old)
    if os.path.exists(dirname):
        os.replace(dirname, old)
    os.replace(tmp, dirname)
    _fsync_dir(os.path.dirname(os.path.abspath(dirname)))
    if os.path.exists(old):
        shutil.rmtree(old, ignore_errors=True)


def _mesh_unported() -> NotImplementedError:
    return NotImplementedError(
        "an elastic restore onto a device mesh (target_mesh) is not ported "
        "yet: the port has the single-device step (ROADMAP module item 11)")


def _restore_leaf(arr, meta, return_numpy):
    """A stored array as the caller gets it: bf16 leaves from their 16-bit
    pattern by the manifest's dtype, others as numpy or a Tensor."""
    if meta.get("dtype") == _BF16:
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                             .copy()).view(torch.bfloat16)
        return t if return_numpy else Tensor._wrap(
            t.to(place_mod.current_device()))
    return arr if return_numpy else Tensor(arr)


def load_sharded(dirname: str, return_numpy: bool = False,
                 verify: bool = True, target_mesh=None,
                 target_specs=None) -> dict:
    """Load a sharded checkpoint; with `verify` (default) requires the
    COMMITTED marker and checks every leaf's CRC32, raising
    :class:`CheckpointCorruptError` naming the offending leaf.  Leaves
    come back as Tensors on the current place, or as numpy arrays with
    `return_numpy` (bf16 leaves as CPU bfloat16 tensors).  A
    `target_mesh` raises ``NotImplementedError`` (ROADMAP module item
    11)."""
    from ..observability import trace as _trace
    if target_mesh is not None:
        raise _mesh_unported()
    with _trace.span("checkpoint.load", dir=dirname) as sp:
        mpath = os.path.join(dirname, _MANIFEST)
        if not os.path.isfile(mpath):
            raise CheckpointCorruptError(
                f"checkpoint {dirname!r} has no manifest", dirname=dirname)
        if verify and not is_committed(dirname):
            raise CheckpointCorruptError(
                f"checkpoint {dirname!r} has no COMMITTED marker "
                "(torn or in-flight write)", dirname=dirname)
        try:
            with open(mpath) as f:
                meta_all = json.load(f)
        except (json.JSONDecodeError, OSError) as e:
            raise CheckpointCorruptError(
                f"checkpoint {dirname!r} manifest unreadable: {e}",
                dirname=dirname)
        # phase 1 — read + CRC-verify every leaf from the stored bytes
        arrays = {}
        for key, meta in meta_all["tensors"].items():
            fpath = os.path.join(dirname, meta["file"])
            faults.fault_point("restore.read", path=fpath, leaf=key)
            try:
                arr = np.load(fpath)
            except (OSError, ValueError, EOFError) as e:
                raise CheckpointCorruptError(
                    f"checkpoint leaf {key!r} unreadable "
                    f"({meta['file']}): {e}", dirname=dirname, leaf=key)
            if verify and "crc32" in meta and _crc32(arr) != meta["crc32"]:
                raise CheckpointCorruptError(
                    f"checkpoint leaf {key!r} failed CRC32 validation "
                    f"({meta['file']})", dirname=dirname, leaf=key)
            arrays[key] = arr
        flat = {key: _restore_leaf(arr, meta_all["tensors"][key],
                                   return_numpy)
                for key, arr in arrays.items()}
        flat.update(meta_all.get("scalars", {}))
        sp.attrs["leaves"] = len(flat)
        return _unflatten(flat)


class AsyncCheckpointSaver:
    """Non-blocking checkpoint writer: snapshot on the caller, IO in a
    worker thread.  keep_last prunes old step dirs (reference auto_checkpoint
    keeps a bounded history).

    `fs` (fleet.utils.fs client) selects the storage backend: a remote
    client (HDFSClient/GCSClient, `need_upload_download()` True) stages the
    sharded write through a local temp dir then uploads — the reference's
    checkpoint_saver.py + fs.py path (auto_checkpoint.py:636).  Remote
    uploads go payload-first, COMMITTED marker last (each under the
    bounded-backoff retry policy), so an interrupted upload is a
    marker-less remote dir that ``steps()`` never counts — not a checkpoint
    that restores garbage."""

    def __init__(self, base_dir: str, keep_last: int = 3, fs=None):
        self.base_dir = base_dir
        self.keep_last = keep_last
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._fs = fs
        self._remote = fs is not None and fs.need_upload_download()
        if self._remote:
            fs.mkdirs(base_dir)
        else:
            os.makedirs(base_dir, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.base_dir, f"step_{step}")

    def _retry(self, fn, *args, name: str):
        from ..utils.retry import retry_call

        def call():
            faults.fault_point(name)  # fs.upload / fs.download
            return fn(*args)
        return retry_call(call, name=name, tries=_FS_TRIES,
                          base_delay=_FS_BASE_DELAY,
                          counter=CHECKPOINT_RETRIES_TOTAL)

    def _upload_committed(self, local: str, remote: str):
        """Payload first, marker last: the remote dir only becomes a
        checkpoint once everything else arrived."""
        marker = os.path.join(local, _COMMITTED)
        marker_aside = local + "." + _COMMITTED
        os.replace(marker, marker_aside)
        faults.fault_point("checkpoint.upload", dir=remote)
        self._retry(self._fs.upload, local, remote, name="fs.upload")
        faults.fault_point("checkpoint.upload_commit", dir=remote)
        self._retry(self._fs.upload, marker_aside,
                    remote + "/" + _COMMITTED, name="fs.upload")

    def _note_failure(self, err: BaseException, step, phase: str):
        """Emit the failure signal AT failure time (the caller may not
        call wait() for many steps)."""
        from ..observability import flight, registry
        flight.record("checkpoint", "write_failed", step=int(step),
                      phase=phase, error=f"{type(err).__name__}: {err}"[:300])
        registry().counter(
            CHECKPOINT_FAILURES_TOTAL,
            "checkpoint writes/restores that failed").inc(
            1.0, labels={"phase": phase})

    def save(self, state: dict, step: int, blocking: bool = False):
        from ..observability import trace as _trace
        self.wait()  # one outstanding write at a time
        # snapshot blocks the caller (device → host copies); the write
        # phase runs in the worker thread — two separate spans so a
        # stalled train loop and a stalled disk are distinguishable
        with _trace.span("checkpoint.snapshot", step=step):
            snapshot = _flatten(_to_numpy_tree(state))

        def work():
            try:
                with _trace.span("checkpoint.async_write", step=step,
                                 remote=self._remote):
                    if self._remote:
                        import tempfile
                        with tempfile.TemporaryDirectory() as tmp:
                            local = os.path.join(tmp, f"step_{step}")
                            save_sharded(_unflatten(snapshot), local)
                            self._upload_committed(local,
                                                   self._step_dir(step))
                    else:
                        save_sharded(_unflatten(snapshot),
                                     self._step_dir(step))
                    self._prune()
            except BaseException as e:  # noqa: BLE001
                self._note_failure(e, step, "async_write")
                self._error = e

        if blocking:
            work()
            self._raise_pending()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_pending()

    def _raise_pending(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"async checkpoint write failed: {err}")

    def _is_committed_step(self, name: str) -> bool:
        if self._remote:
            return self._fs.is_file(
                os.path.join(self.base_dir, name, _COMMITTED))
        return is_committed(os.path.join(self.base_dir, name))

    def steps(self) -> list[int]:
        """Committed steps only: a dir without the COMMITTED marker is a
        torn write (or an in-flight upload), never a restore candidate."""
        if self._remote:
            dirs, _ = self._fs.ls_dir(self.base_dir)
            names = dirs
        else:
            names = os.listdir(self.base_dir)
        out = []
        for name in names:
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    step = int(name[len("step_"):])
                except ValueError:
                    continue
                if self._is_committed_step(name):
                    out.append(step)
        return sorted(out)

    def latest_step(self):
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step=None, return_numpy=False, target_mesh=None,
                target_specs=None):
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        if self._remote:
            import tempfile
            with tempfile.TemporaryDirectory() as tmp:
                local = os.path.join(tmp, f"step_{step}")
                self._retry(self._fs.download, self._step_dir(step), local,
                            name="fs.download")
                return load_sharded(local, return_numpy,
                                    target_mesh=target_mesh,
                                    target_specs=target_specs)
        return load_sharded(self._step_dir(step), return_numpy,
                            target_mesh=target_mesh,
                            target_specs=target_specs)

    def restore_latest_valid(self, return_numpy=False, target_mesh=None,
                             target_specs=None):
        """Walk backward from the newest committed step past anything that
        fails validation, quarantining bad dirs (``<dir>.corrupt``) with a
        flight event.  Returns ``(step, state)`` or ``(None, None)`` when
        no valid checkpoint exists.

        Elastic failures are different: an :class:`ElasticReshardError`
        (or an injected restore fault) means the CHECKPOINT is fine and
        the restore request is wrong — it re-raises immediately and never
        quarantines, so a failed elastic restore leaves the checkpoint dir
        untouched."""
        from ..observability import flight, registry
        if target_mesh is not None:
            raise _mesh_unported()
        for step in reversed(self.steps()):
            try:
                return step, self.restore(step, return_numpy,
                                          target_mesh=target_mesh,
                                          target_specs=target_specs)
            except (ElasticReshardError, faults.FaultInjected):
                raise  # not a corrupt dir: never quarantine
            except Exception as e:  # noqa: BLE001 — any broken dir: skip it
                flight.record("checkpoint", "quarantine", step=int(step),
                              dir=self._step_dir(step),
                              error=f"{type(e).__name__}: {e}"[:300])
                registry().counter(
                    CHECKPOINT_FAILURES_TOTAL,
                    "checkpoint writes/restores that failed").inc(
                    1.0, labels={"phase": "restore"})
                self._quarantine(step)
        return None, None

    def _quarantine(self, step: int):
        src = self._step_dir(step)
        dst = src + ".corrupt"
        try:
            if self._remote:
                if self._fs.is_exist(dst):
                    self._fs.delete(dst)
                self._fs.mv(src, dst)
            else:
                if os.path.exists(dst):
                    shutil.rmtree(dst, ignore_errors=True)
                os.replace(src, dst)
        except OSError:
            pass  # quarantine is best-effort; steps() already skips it

    def _prune(self):
        steps = self.steps()
        for s in steps[:-self.keep_last] if self.keep_last else []:
            if self._remote:
                self._fs.delete(self._step_dir(s))
            else:
                shutil.rmtree(self._step_dir(s), ignore_errors=True)
        self._sweep_orphans()

    def _sweep_orphans(self):
        """Remove debris a crashed writer leaves behind: `step_*.tmp`
        partial writes, `*.old` promote leftovers, and marker-less step
        dirs older than the newest committed step (interrupted uploads)."""
        from ..observability import flight
        newest = max(self.steps(), default=None)
        if self._remote:
            dirs, _ = self._fs.ls_dir(self.base_dir)
        else:
            dirs = [n for n in os.listdir(self.base_dir)
                    if os.path.isdir(os.path.join(self.base_dir, n))]
        for name in dirs:
            full = os.path.join(self.base_dir, name)
            orphan = name.endswith(".tmp") or name.endswith(".old")
            if not orphan and name.startswith("step_") and \
                    newest is not None and not name.endswith(".corrupt"):
                try:
                    orphan = int(name[len("step_"):]) < newest and \
                        not self._is_committed_step(name)
                except ValueError:
                    orphan = False
            if orphan:
                flight.record("checkpoint", "sweep_orphan", dir=full)
                if self._remote:
                    self._fs.delete(full)
                else:
                    shutil.rmtree(full, ignore_errors=True)
