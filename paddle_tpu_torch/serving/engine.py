"""Continuous-batching serving engine over the paged KV pool.

The port of ``paddle_tpu/serving/engine.py`` for its main serving path,
``Engine(paged_kv=True, decode_kernel="pallas")``:

* a **slot pool** of ``max_slots`` decode lanes plus one scratch lane, and
  a **paged KV pool** per layer: ``[num_pages, page_size, heads,
  head_dim]`` K and V tensors (int8 with ``[num_pages, page_size]`` f32
  scales under ``kv_dtype="int8"``).  Each lane carries an int32 page
  table; a host-side :class:`PageAllocator` owns the free list.
* a **scheduler thread**: each iteration sweeps cancellations and
  deadlines, admits queued requests (each reserves every page it can
  ever write, ``ceil((prompt + max_new_tokens) / page_size)``; page
  exhaustion leaves the head of the queue waiting), prefills them as one
  batch padded to a power-of-two bucket, then runs one batched decode
  step over all ``max_slots + 1`` lanes.  Idle lanes are parked at the
  pool's virtual end with all-sentinel tables, so their writes drop.
* on the card, prefill attention runs the flash kernel and every decode
  step's attention read runs the paged decode kernel
  (``paddle_tpu_torch/kernels``); on the CPU the same code runs their
  plain versions.

**Sampling.**  Greedy decoding (temperature 0) is exact: the same
weights give the JAX engine's tokens.  With a temperature (and optional
top-k) each request draws from its own ``torch.Generator`` seeded with
``seed``, so a request is reproducible within the port, but sampled
tokens are *distributional*, not seed-equal to the JAX engine, which
draws with threefry ``fold_in`` keys that this port does not
reimplement.

Flags of the JAX engine this slice does not port raise
``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from concurrent.futures import CancelledError
from typing import Callable, Optional

import numpy as np
import torch

from ..device import resolve_device
from .kv_quant import quantize_rows
from .paged_kv import PageAllocator
from .slot_pool import SlotPool

__all__ = ["Engine", "RequestHandle", "QueueFullError", "EngineClosedError",
           "EngineDeadError", "DeadlineExceededError", "_bucket"]


class QueueFullError(RuntimeError):
    """Admission queue is at capacity — backpressure; retry later."""


class DeadlineExceededError(TimeoutError):
    """The request's deadline passed before it finished."""


class EngineClosedError(RuntimeError):
    """The engine was shut down with this request still in flight."""


class EngineDeadError(RuntimeError):
    """The scheduler thread crashed; the engine rejects new work."""

    def __init__(self, cause: BaseException):
        super().__init__(
            f"serving scheduler died: {type(cause).__name__}: {cause}")
        self.cause = cause


_ids = itertools.count(1)


class RequestHandle:
    """Future-style handle for one submitted request: ``result(timeout)``
    returns the generated ids (or raises the request's error), ``tokens``
    is the stream so far, ``ttft_s`` and ``token_latencies_s`` carry the
    latency telemetry."""

    def __init__(self, engine, prompt, max_new_tokens, eos_token_id,
                 temperature, top_k, seed, deadline_s, stream):
        self.request_id = next(_ids)
        self.prompt = prompt
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = eos_token_id
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.seed = int(seed)
        self._gen: Optional[torch.Generator] = None   # set at admission
        self._stream = stream
        self._engine = engine
        self._state = "queued"            # queued|active|done
        self._cancel_requested = False
        self._done = threading.Event()
        self._error: Optional[BaseException] = None
        self._tokens: list[int] = []
        self.slot: Optional[int] = None
        self._pages: Optional[list] = None
        now = time.perf_counter()
        self.t_submit = now
        self.t_admit: Optional[float] = None
        self._t_last_token = now
        self.ttft_s: Optional[float] = None
        self.token_latencies_s: list[float] = []
        self.deadline = None if deadline_s is None else now + float(deadline_s)

    def done(self) -> bool:
        return self._done.is_set()

    def cancel(self) -> bool:
        """Request cancellation; False if already finished.  A queued
        request fails at once; an active one is evicted on the next
        sweep."""
        return self._engine._request_cancel(self)

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id} not finished within {timeout}s")
        if self._error is not None:
            raise self._error
        return np.asarray(self._tokens, np.int64)

    def exception(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id} not finished within {timeout}s")
        return self._error

    @property
    def tokens(self) -> list[int]:
        return list(self._tokens)

    def _finish(self, error: Optional[BaseException] = None):
        self._state = "done"
        self._error = error
        self._done.set()

    def _emit(self, token: int):
        if self._done.is_set():
            return
        self._tokens.append(int(token))
        if self._stream is not None:
            try:
                self._stream(int(token))
            except Exception:  # noqa: BLE001 — a broken consumer must
                pass           # not kill the batch

    def __repr__(self):
        return (f"RequestHandle(id={self.request_id}, state={self._state}, "
                f"slot={self.slot}, tokens={len(self._tokens)})")


def _bucket(n: int, lo: int, hi: int) -> int:
    """Smallest power of two >= n, clamped to [lo, hi] — prompt padding
    buckets."""
    b = lo
    while b < n:
        b *= 2
    return min(b, hi)


def _sample_row(logits_row, temperature: float, top_k: int,
                gen: torch.Generator) -> int:
    """Temperature (+ optional top-k) draw from one row of logits with
    the request's generator."""
    lg = logits_row.float() / max(temperature, 1e-6)
    if top_k:
        kth = torch.topk(lg, min(top_k, lg.numel())).values[-1]
        lg = torch.where(lg < kth, torch.full_like(lg, -1e30), lg)
    probs = torch.softmax(lg, dim=-1)
    return int(torch.multinomial(probs, 1, generator=gen))


def _unported(flag: str, item: int):
    return NotImplementedError(
        f"{flag} is not ported yet: ROADMAP 'Port queue' item {item}")


class Engine:
    """Continuous-batching inference engine over a paged KV pool.

    Args:
        model: a port ``GPTForPretraining`` (trunk ``.gpt`` + ``.lm_head``)
            on ``device``.
        max_slots: concurrent requests sharing the batched decode step.
        max_len: per-slot length; ``len(prompt) + max_new_tokens`` may not
            exceed ``max_pages_per_slot * page_size`` (capped by the
            model's position table).
        max_queue: admission-queue bound (default ``2 * max_slots``);
            submits beyond it raise :class:`QueueFullError`.
        prefill_batch: requests admitted per batched prefill (default
            ``min(4, max_slots)``).
        eos_token_id: default end-of-sequence id.
        paged_kv: must be True (the dense pool is not ported).
        page_size: positions per page (default 16).
        num_pages: pages in the pool (default ``max_slots *
            ceil(max_len / page_size)``).
        max_pages_per_slot: page-table width (default
            ``ceil(max_len / page_size)``).
        kv_dtype: None (f32 pools) or ``"int8"`` (per-position scales).
        device: ``"cuda"`` by default; raises without a card.
        auto_start: start the scheduler on the first submit (tests pass
            False to stage a queue, then call :meth:`start`).
        decode_kernel: ``"pallas"``, the JAX flag value for the fused
            paged read; here it is the CUDA paged decode kernel.
    """

    def __init__(self, model, max_slots: int = 8, max_len: int = 256,
                 max_queue: Optional[int] = None,
                 prefill_batch: Optional[int] = None, eos_token_id=None,
                 paged_kv: bool = True, page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 max_pages_per_slot: Optional[int] = None,
                 kv_dtype: Optional[str] = None, device=None,
                 auto_start: bool = True, prefix_cache: bool = False,
                 speculative_k: int = 0, adapters=None,
                 weight_dtype: Optional[str] = None,
                 host_prefix_mb: Optional[float] = None, host_prefix=None,
                 decode_kernel: str = "pallas"):
        self.device = resolve_device(device)
        if decode_kernel not in ("xla", "pallas"):
            raise ValueError(f"decode_kernel must be 'xla' or 'pallas', "
                             f"got {decode_kernel!r}")
        if kv_dtype not in (None, "int8"):
            raise ValueError(f"kv_dtype must be None or 'int8', "
                             f"got {kv_dtype!r}")
        if not paged_kv:
            raise _unported("the dense slot pool (paged_kv=False)", 2)
        if decode_kernel == "xla":
            raise _unported("decode_kernel='xla' (the gather read)", 2)
        if prefix_cache:
            raise _unported("prefix_cache", 2)
        if int(speculative_k) > 1:
            raise _unported("speculative_k (W > 1 verify)", 2)
        if adapters is not None:
            raise _unported("adapters (multi-LoRA)", 2)
        if weight_dtype is not None:
            raise _unported("weight_dtype (int8 weights)", 2)
        if host_prefix_mb is not None or host_prefix is not None:
            raise _unported("the host prefix tier (host_prefix*)", 2)
        self.model = model
        self.max_slots = int(max_slots)
        self.max_len = int(max_len)
        if self.max_slots < 1 or self.max_len < 2:
            raise ValueError("need max_slots >= 1 and max_len >= 2")
        cfg = model.gpt.config
        limit = int(cfg.max_position_embeddings)
        if self.max_len > limit:
            raise ValueError(
                f"max_len={self.max_len} exceeds the model's "
                f"max_position_embeddings={limit}")
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if any(p.device != self.device for p in model.parameters()):
            raise ValueError(f"the model does not lie on the engine's "
                             f"device {self.device}")
        self.max_queue = (2 * self.max_slots if max_queue is None
                          else int(max_queue))
        self.prefill_batch = (min(4, self.max_slots) if prefill_batch is None
                              else max(1, min(int(prefill_batch),
                                              self.max_slots)))
        self.eos_token_id = eos_token_id
        self.kv_dtype = kv_dtype
        self._quant = kv_dtype == "int8"
        self._auto_start = bool(auto_start)

        P = 16 if page_size is None else int(page_size)
        if P < 1:
            raise ValueError(f"page_size must be >= 1, got {P}")
        dense_pages = -(-self.max_len // P)
        n_pt = dense_pages if max_pages_per_slot is None \
            else int(max_pages_per_slot)
        if n_pt < 1:
            raise ValueError(f"max_pages_per_slot must be >= 1, got {n_pt}")
        n_pages = self.max_slots * dense_pages if num_pages is None \
            else int(num_pages)
        self._page_alloc = PageAllocator(n_pages, P)
        self._max_pages_per_slot = n_pt
        self._limit = min(n_pt * P, limit)

        n_rows = self.max_slots + 1             # + scratch lane
        self._pool = SlotPool(self.max_slots)
        self._queue: deque = deque()
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self._dead: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        self._ids = np.zeros((n_rows, 1), np.int64)
        # idle lanes park at the pool's virtual end with all-sentinel
        # tables: their decode writes drop and their reads are skipped
        self._park = n_pt * P
        self._lengths = np.full(n_rows, self._park, np.int32)
        self._page_tables = np.full((n_rows, n_pt), n_pages, np.int32)
        self._counts = {"submitted": 0, "completed": 0, "rejected": 0,
                        "cancelled": 0, "deadline_expired": 0, "failed": 0,
                        "decode_steps": 0, "prefill_batches": 0,
                        "tokens": 0, "page_alloc_stalls": 0,
                        # host wall seconds inside batched prefill / decode
                        # dispatches, device work included (each ends in a
                        # device-to-host copy of the sampled tokens)
                        "prefill_seconds": 0.0, "decode_seconds": 0.0}
        self._active_pages = 0
        self._page_stalled = False

        H = cfg.num_attention_heads
        D = cfg.hidden_size // H
        self._heads, self._head_dim = H, D
        pool_dtype = torch.int8 if self._quant else torch.float32
        shape = (n_pages, P, H, D)
        L = cfg.num_layers
        self._kpools = [torch.zeros(shape, dtype=pool_dtype,
                                    device=self.device) for _ in range(L)]
        self._vpools = [torch.zeros(shape, dtype=pool_dtype,
                                    device=self.device) for _ in range(L)]
        if self._quant:
            self._kscales = [torch.zeros((n_pages, P), device=self.device)
                             for _ in range(L)]
            self._vscales = [torch.zeros((n_pages, P), device=self.device)
                             for _ in range(L)]
        groups = [self._kpools, self._vpools] + (
            [self._kscales, self._vscales] if self._quant else [])
        self._pool_bytes = sum(t.numel() * t.element_size()
                               for g in groups for t in g)
        self._was_training = model.training
        model.eval()

    # -- request API ---------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 16, eos_token_id=...,
               temperature: float = 0.0, top_k: int = 0, seed: int = 0,
               deadline_s: Optional[float] = None,
               stream: Optional[Callable[[int], None]] = None
               ) -> RequestHandle:
        """Queue one request; returns its handle.  Raises
        :class:`QueueFullError` when the queue is full and ``ValueError``
        when the request cannot fit a slot."""
        if self._dead is not None:
            raise EngineDeadError(self._dead) from self._dead
        if self._stop:
            raise EngineClosedError("engine is shut down")
        ids = np.asarray(prompt).astype(np.int64).reshape(-1)
        if ids.size < 1:
            raise ValueError("empty prompt")
        if int(max_new_tokens) < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if ids.size + int(max_new_tokens) > self._limit:
            raise ValueError(
                f"prompt ({ids.size}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds the paged limit (max_pages_per_slot * page_size, "
                f"capped by the model's positions)={self._limit}")
        need = self._pages_for(ids.size + int(max_new_tokens))
        if need > self._page_alloc.num_pages:
            raise ValueError(f"request needs {need} pages but the pool has "
                             f"only {self._page_alloc.num_pages}")
        eos = self.eos_token_id if eos_token_id is ... else eos_token_id
        req = RequestHandle(self, ids, max_new_tokens, eos, temperature,
                            top_k, seed, deadline_s, stream)
        with self._lock:
            if len(self._queue) >= self.max_queue:
                self._counts["rejected"] += 1
                raise QueueFullError(
                    f"admission queue full ({self.max_queue}); retry later")
            self._queue.append(req)
            self._counts["submitted"] += 1
        if self._auto_start:
            self.start()
        self._wake.set()
        return req

    def start(self):
        """Start the scheduler thread (idempotent)."""
        if self._dead is not None:
            raise EngineDeadError(self._dead) from self._dead
        if self._stop:
            raise EngineClosedError("engine is shut down")
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._thread = threading.Thread(
                target=self._loop, name="paddle-tpu-torch-serving",
                daemon=True)
            self._thread.start()

    def join(self, timeout: Optional[float] = None) -> bool:
        """Block until queue and slots are empty; False on timeout."""
        deadline = None if timeout is None else time.perf_counter() + timeout
        while True:
            with self._lock:
                if not self._queue and self._pool.n_active == 0:
                    return True
            if self._dead is not None or (
                    deadline is not None and time.perf_counter() > deadline):
                return False
            time.sleep(0.005)

    def shutdown(self):
        """Stop the scheduler; queued and in-flight requests fail with
        :class:`EngineClosedError`."""
        if self._stop:
            return
        self._stop = True
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=60)
        with self._lock:
            pending = list(self._queue) + list(self._pool.active().values())
            self._queue.clear()
            for slot in list(self._pool.active()):
                self._release_pages_locked(self._pool.free(slot))
            self._page_alloc.check()     # zero leaked pages at teardown
        err = EngineClosedError("engine shut down")
        for req in pending:
            req._finish(err)
        if self._was_training:
            self.model.train()

    close = shutdown

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False

    def stats(self) -> dict:
        with self._lock:
            out = dict(self._counts)
            out["active_slots"] = self._pool.n_active
            out["queue_depth"] = len(self._queue)
            out["slot_allocs"] = self._pool.alloc_total
            out["slot_reuses"] = self._pool.reuse_total
            out["kv_pool_bytes"] = self._pool_bytes
            out["kv_num_pages"] = self._page_alloc.num_pages
            out["kv_page_size"] = self._page_alloc.page_size
            out["kv_pages_free"] = self._page_alloc.n_free
            out["kv_pages_used"] = self._page_alloc.n_used
            out["kv_pages_active"] = self._active_pages
        return out

    # -- scheduler -----------------------------------------------------------
    def _loop(self):
        while not self._stop and self._dead is None:
            try:
                did = self._step_once()
            except Exception as e:  # noqa: BLE001 — fail loudly, not hang
                self._fail_as_dead(e)
                raise
            if not did:
                self._wake.wait(0.02)
                self._wake.clear()

    def _step_once(self) -> bool:
        """One iteration: sweep, admit (batched prefill), one batched
        decode step.  Returns whether any work happened."""
        self._sweep()
        did = self._admit()
        return self._decode_step() or did

    def _fail_as_dead(self, cause: BaseException):
        with self._lock:
            self._dead = cause
            pending = list(self._queue) + list(self._pool.active().values())
            self._queue.clear()
            for slot in list(self._pool.active()):
                self._release_pages_locked(self._pool.free(slot))
            self._counts["failed"] += len(pending)
        for req in pending:
            req._finish(EngineDeadError(cause))

    def _sweep(self):
        """Evict cancelled / past-deadline requests (queued and active)."""
        now = time.perf_counter()
        to_finish = []
        with self._lock:
            for req in list(self._queue):
                if req._cancel_requested or (req.deadline is not None and
                                             now > req.deadline):
                    self._queue.remove(req)
                    outcome = ("cancelled" if req._cancel_requested
                               else "deadline_expired")
                    self._counts[outcome] += 1
                    to_finish.append((req, outcome))
            for req in self._pool.active().values():
                if req._cancel_requested or (req.deadline is not None and
                                             now > req.deadline):
                    outcome = ("cancelled" if req._cancel_requested
                               else "deadline_expired")
                    self._evict_locked(req, outcome)
                    to_finish.append((req, outcome))
        for req, outcome in to_finish:
            req._finish(CancelledError() if outcome == "cancelled" else
                        DeadlineExceededError(
                            f"request {req.request_id} missed its deadline"))

    def _request_cancel(self, req: RequestHandle) -> bool:
        if req.done():
            return False
        req._cancel_requested = True
        with self._lock:
            if req in self._queue:
                self._queue.remove(req)
                self._counts["cancelled"] += 1
                req._finish(CancelledError())
                return True
        self._wake.set()
        return True

    # -- admission -----------------------------------------------------------
    def _pages_for(self, n_tokens: int) -> int:
        return -(-int(n_tokens) // self._page_alloc.page_size)

    def _admit_locked(self) -> list:
        """Head-of-queue requests admit while a lane AND their whole page
        reservation fit; page exhaustion keeps the head queued (FIFO
        backpressure; admitted work never waits on pages)."""
        alloc = self._page_alloc
        want = min(self.prefill_batch, len(self._queue))
        if want == 0:
            self._page_stalled = False
            return []
        batch = []
        while self._queue and len(batch) < want and self._pool.n_free > 0:
            req = self._queue[0]
            pages = alloc.alloc(
                self._pages_for(req.prompt.size + req.max_new_tokens))
            if pages is None:
                if not self._page_stalled:
                    self._page_stalled = True
                    self._counts["page_alloc_stalls"] += 1
                break
            self._page_stalled = False
            self._queue.popleft()
            req.slot = self._pool.alloc(req)
            req._state = "active"
            req.t_admit = time.perf_counter()
            table = self._page_tables[req.slot]
            table[:] = alloc.num_pages
            table[:len(pages)] = pages
            req._pages = pages
            self._active_pages += len(pages)
            batch.append(req)
        return batch

    def _admit(self) -> bool:
        with self._lock:
            batch = self._admit_locked()
        if not batch:
            return False
        for req in batch:
            if req.temperature > 0:
                req._gen = torch.Generator(device=self.device)
                req._gen.manual_seed(req.seed)
        self._prefill(batch)
        return True

    def _prefill(self, batch) -> None:
        """Cold prefill of one admission wave: prompts padded to a pow2
        bucket over ``prefill_batch`` lanes run the static-prefill
        forward (the flash kernel on the card); every real prompt
        position is then written into its slot's pages."""
        bucket = _bucket(max(r.prompt.size for r in batch),
                         min(8, self._limit), self._limit)
        n = self.prefill_batch
        NP = self._page_alloc.num_pages
        P = self._page_alloc.page_size
        n_pt = self._max_pages_per_slot
        ids = np.zeros((n, bucket), np.int64)
        plens = np.ones(n, np.int64)
        tables = np.full((n, n_pt), NP, np.int32)
        with self._lock:
            for i, req in enumerate(batch):
                ids[i, :req.prompt.size] = req.prompt
                plens[i] = req.prompt.size
                tables[i] = self._page_tables[req.slot]
        # host-side scatter plan: prompt positions map through the lane's
        # table; padding positions and padding lanes resolve to sentinel
        # pages and are dropped
        pos = np.arange(bucket)
        pid = np.where(pos[None, :] < plens[:, None],
                       tables[:, np.minimum(pos // P, n_pt - 1)], NP)
        lane, col = np.nonzero(pid < NP)
        dev = self.device
        H, D = self._heads, self._head_dim
        t0 = time.perf_counter()
        with torch.no_grad():
            caches = [(torch.zeros((n, bucket, H, D), device=dev),
                       torch.zeros((n, bucket, H, D), device=dev), 0)
                      for _ in self._kpools]
            x, new_caches = self.model.gpt(torch.from_numpy(ids).to(dev),
                                           caches=caches)
            h_last = x[torch.arange(n, device=dev),
                       torch.from_numpy(plens - 1).to(dev)]
            logits = self.model.lm_head(h_last)
            idx = (torch.from_numpy(pid[lane, col]).long().to(dev),
                   torch.from_numpy(col % P).long().to(dev))
            src = (torch.from_numpy(lane).to(dev), torch.from_numpy(col).to(dev))
            for i, (kb, vb, _) in enumerate(new_caches):
                self._write_pages(i, idx, kb[src], vb[src])
            toks = self._sample(logits, batch)
        with self._lock:
            self._counts["prefill_batches"] += 1
            self._counts["prefill_seconds"] += time.perf_counter() - t0
        self._emit_first_tokens(batch, toks)

    def _write_pages(self, layer, idx, k, v):
        """Write ``k``/``v`` ``[N, H, D]`` at ``idx = (page ids, offsets)``
        of one layer's pools, in place (quantized for int8 pools)."""
        if self._quant:
            kq, ks = quantize_rows(k)
            vq, vs = quantize_rows(v)
            self._kpools[layer].index_put_(idx, kq)
            self._vpools[layer].index_put_(idx, vq)
            self._kscales[layer].index_put_(idx, ks)
            self._vscales[layer].index_put_(idx, vs)
        else:
            self._kpools[layer].index_put_(idx, k)
            self._vpools[layer].index_put_(idx, v)

    def _sample(self, logits, rows) -> np.ndarray:
        """Token per row: argmax, or a draw with the request's generator
        for rows whose request has a temperature (``rows[i]`` is the
        request of row ``i``, or None)."""
        toks = logits.argmax(dim=-1)
        drawn = {i: _sample_row(logits[i], r.temperature, r.top_k, r._gen)
                 for i, r in enumerate(rows)
                 if r is not None and r.temperature > 0}
        out = toks.cpu().numpy()
        for i, t in drawn.items():
            out[i] = t
        return out

    def _emit_first_tokens(self, batch, toks):
        now = time.perf_counter()
        finishers = []
        for i, req in enumerate(batch):
            req.ttft_s = now - req.t_submit
            req._t_last_token = now
            if req.done():
                continue
            token = int(toks[i])
            finished = self._emit_one(req, token)
            with self._lock:
                self._counts["tokens"] += 1
                self._lengths[req.slot] = req.prompt.size
                if finished:
                    self._evict_locked(req, "completed")
                else:
                    self._ids[req.slot, 0] = token
            if finished:
                finishers.append(req)
        for req in finishers:
            req._finish(None)

    # -- decode --------------------------------------------------------------
    def _decode_step(self) -> bool:
        with self._lock:
            active = self._pool.active()
            if not active:
                return False
            ids = np.array(self._ids)
            lengths = np.array(self._lengths)
            tables = np.array(self._page_tables)
        dev = self.device
        t0 = time.perf_counter()
        with torch.no_grad():
            lens_t = torch.from_numpy(lengths).to(dev)
            pt_t = torch.from_numpy(tables).to(dev)
            if self._quant:
                caches = list(zip(self._kpools, self._vpools,
                                  [lens_t] * len(self._kpools),
                                  [pt_t] * len(self._kpools),
                                  self._kscales, self._vscales))
            else:
                caches = [(kp, vp, lens_t, pt_t)
                          for kp, vp in zip(self._kpools, self._vpools)]
            x, _ = self.model.gpt(torch.from_numpy(ids).to(dev),
                                  caches=caches)
            logits = self.model.lm_head(x[:, 0])
            toks = self._sample(logits, [active.get(r)
                                         for r in range(len(ids))])
        now = time.perf_counter()
        finishers = []
        with self._lock:
            self._counts["decode_steps"] += 1
            self._counts["decode_seconds"] += now - t0
        for slot, req in active.items():
            if req.done():
                continue
            token = int(toks[slot])
            req.token_latencies_s.append(now - req._t_last_token)
            req._t_last_token = now
            finished = self._emit_one(req, token)
            with self._lock:
                self._counts["tokens"] += 1
                self._lengths[slot] = int(lengths[slot]) + 1
                if finished:
                    self._evict_locked(req, "completed")
                else:
                    self._ids[slot, 0] = token
            if finished:
                finishers.append(req)
        for req in finishers:
            req._finish(None)
        return True

    def _emit_one(self, req: RequestHandle, token: int) -> bool:
        """Stream one token; returns whether the request is finished."""
        req._emit(token)
        return (len(req._tokens) >= req.max_new_tokens or
                (req.eos_token_id is not None and
                 token == req.eos_token_id))

    # -- eviction ------------------------------------------------------------
    def _release_pages_locked(self, req: RequestHandle):
        if req._pages is None:
            return
        for p in req._pages:
            self._page_alloc.deref(p)
        self._active_pages -= len(req._pages)
        req._pages = None
        if req.slot is not None:
            self._page_tables[req.slot, :] = self._page_alloc.num_pages
            self._lengths[req.slot] = self._park

    def _evict_locked(self, req: RequestHandle, outcome: str):
        self._release_pages_locked(req)
        self._pool.free(req.slot)
        self._counts[outcome] += 1
