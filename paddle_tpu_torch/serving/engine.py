"""Continuous-batching serving engine over the paged KV pool.

The port of ``paddle_tpu/serving/engine.py`` for its main serving path,
``Engine(paged_kv=True, decode_kernel="pallas")``, with the decode fast
path's flags:

* a **slot pool** of ``max_slots`` decode lanes plus one scratch lane, and
  a **paged KV pool** per layer: ``[num_pages + 1, page_size, heads,
  head_dim]`` K and V tensors (int8 with ``[num_pages + 1, page_size]``
  f32 scales under ``kv_dtype="int8"``).  Each lane carries an int32 page
  table; a host-side :class:`PageAllocator` owns the ``num_pages``
  mappable pages.  The last page is the **spare**: no table maps it, the
  read never sees it, and every write a table cannot place (a sentinel
  entry, a position past the table, a parked lane) lands there, so the
  write has a fixed shape and syncs nothing (the cache tuples end in
  ``kernels.paged_attention.SPARE_PAGE``; ``models/gpt.py`` writes).
* a **scheduler thread**: each iteration sweeps cancellations and
  deadlines, admits queued requests (each reserves every page it can
  ever write, ``ceil((prompt + max_new_tokens) / page_size)`` less the
  full pages a prefix hit shares; page exhaustion leaves the head of the
  queue waiting), prefills them as one batch padded to a power-of-two
  bucket, then runs one batched decode step over all ``max_slots + 1``
  lanes.  Idle lanes are parked at the pool's virtual end with
  all-sentinel tables, so their writes land on the spare page.
* **one decode graph**: the decode step's inputs are static device
  buffers (``ids [n_rows, W]``, ``lengths``, ``page_tables``) filled from
  pinned host arrays; on the card the forward, the LM head and the argmax
  are captured once as a ``torch.cuda.CUDAGraph`` per engine config (W,
  the pool dtype, the LayerNorm routing) and replayed every step, and the
  token ids are the step's one device-to-host copy.  A failed capture or
  replay kills the engine; the step never runs eagerly on the card.
  :meth:`Engine.compile_stats` counts the signatures (``decode_compiles``:
  graph captures on the card, distinct decode input signatures on the
  CPU), as the JAX engine's retrace sentinel does.
* ``prefix_cache=True``: completed requests' pages are retained behind a
  content-addressed :class:`PrefixIndex`; a hit shares the cached full
  pages by reference (one copy-on-write page where the match ends inside
  a page) and prefills only the prompt's tail through the paged read.
* ``speculative_k=k``: ``k - 1`` drafted tokens a step (:class:`NgramDrafter`
  by default, ``drafter=`` for another) verified in the one ``[n_rows,
  k]`` decode step; greedy rows accept the matched draft prefix.
* on the card, prefill attention runs the flash kernel and every decode
  step's and tail prefill's attention read runs the paged decode kernel
  (``paddle_tpu_torch/kernels``); on the CPU the same code runs their
  plain versions.

**Sampling.**  Greedy decoding (temperature 0) is exact: the same
weights give the JAX engine's tokens, speculative or not.  With a
temperature (and optional top-k) each request draws from its own
``torch.Generator`` seeded with ``seed``, so a request is reproducible
within the port, but sampled tokens are *distributional*, not seed-equal
to the JAX engine, which draws with threefry ``fold_in`` keys that this
port does not reimplement.  Sampled rows take no drafts and emit one
token a step.

Flags of the JAX engine this slice does not port raise
``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from concurrent.futures import CancelledError
from contextlib import nullcontext
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import layer_norm as _ln
from ..kernels import paged_attention as _pa
from ..kernels.paged_attention import SPARE_PAGE
from .kv_quant import quantize_rows
from .paged_kv import PageAllocator
from .prefix_cache import PrefixIndex
from .slot_pool import SlotPool
from .speculative import NgramDrafter

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
        self._pages: Optional[list] = None    # backing pages, in table order
        self._prefix_src = None           # PrefixEntry this request shares
        self._prefix_match = 0            # tokens covered by that entry
        self._cow = None                  # pending (src, dst) page COW copy
        self.prefix_hit = False           # admitted through a prefix hit
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


def _unported(flag: str):
    return NotImplementedError(
        f"{flag} is not ported yet: ROADMAP section 1, module entry 4 (the "
        f"rest of the serving engine)")


class _DecodeGraph(NamedTuple):
    """One captured decode step: the graph, its static outputs (logits
    ``[n_rows, W, V]`` and argmax ids ``[n_rows, W]``) and the kernel
    launches one replay makes (counted by the wrappers at capture)."""

    graph: "torch.cuda.CUDAGraph"
    logits: torch.Tensor
    toks: torch.Tensor
    launches: dict


def _kernel_launches() -> dict:
    """The decode step's kernels' launch counters."""
    return {"paged": _pa.paged_decode_attention.launches,
            "ln_fwd": _ln.layer_norm_fused.launches_fwd}


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
        page_size: positions per page (default ``prefix_block``, 16: a
            block-aligned prefix hit then shares only whole pages).
        num_pages: mappable pages in the pool (default ``max_slots *
            ceil(max_len / page_size)``); the pool holds one spare page
            more.
        max_pages_per_slot: page-table width (default
            ``ceil(max_len / page_size)``).
        kv_dtype: None (f32 pools) or ``"int8"`` (per-position scales).
        prefix_cache: retain completed requests' pages behind a
            content-addressed prefix index; an admission whose prompt
            starts with a cached prefix shares its pages and prefills only
            the tail.
        prefix_block: prefix-match granularity in tokens.
        speculative_k: verify ``k`` positions a decode step (``k - 1``
            drafted tokens; 0 and 1 disable).  The decode width is
            ``max(1, k)`` for every step of the engine.
        drafter: ``drafter(context_ids, n) -> n proposed ids`` (default
            :class:`NgramDrafter` when ``speculative_k > 1``).
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
                 prefix_block: int = 16, speculative_k: int = 0,
                 drafter: Optional[Callable] = None, adapters=None,
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
        k = int(speculative_k)
        if k < 0:
            raise ValueError(f"speculative_k must be >= 0, got {k}")
        if not paged_kv:
            raise _unported("the dense slot pool (paged_kv=False)")
        if decode_kernel == "xla":
            raise _unported("decode_kernel='xla' (the gather read)")
        if adapters is not None:
            raise _unported("adapters (multi-LoRA)")
        if weight_dtype is not None:
            raise _unported("weight_dtype (int8 weights)")
        if host_prefix_mb is not None or host_prefix is not None:
            raise _unported("the host prefix tier (host_prefix*)")
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
        self.speculative_k = k
        self._W = max(1, k)                     # decode width
        self._drafter = (drafter if drafter is not None
                         else NgramDrafter() if self._W > 1 else None)
        self._prefix = (PrefixIndex(block=prefix_block) if prefix_cache
                        else None)

        P = int(prefix_block if page_size is None else page_size)
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
        self._ids = np.zeros((n_rows, self._W), np.int64)
        # idle lanes park at the pool's virtual end with all-sentinel
        # tables: their decode writes land on the spare page and their
        # reads are skipped
        self._park = n_pt * P
        self._lengths = np.full(n_rows, self._park, np.int32)
        self._page_tables = np.full((n_rows, n_pt), n_pages, np.int32)
        self._counts = {"submitted": 0, "completed": 0, "rejected": 0,
                        "cancelled": 0, "deadline_expired": 0, "failed": 0,
                        "decode_steps": 0, "prefill_batches": 0,
                        "tokens": 0, "page_alloc_stalls": 0,
                        "prefix_hits": 0, "prefix_misses": 0,
                        "prefix_inserts": 0, "prefix_evictions": 0,
                        "page_cow_copies": 0, "spec_drafted": 0,
                        "spec_accepted": 0,
                        # column groups of the tail prefills' paged reads
                        # (one kernel launch each a layer on the card)
                        "tail_prefill_read_groups": 0,
                        # decode steps replayed from the captured graph and
                        # the kernel launches those replays made (the
                        # launches one replay makes, counted at capture)
                        "decode_graph_replays": 0,
                        "replayed_paged_launches": 0,
                        "replayed_ln_fwd_launches": 0,
                        # host wall seconds inside batched prefill / decode
                        # dispatches, device work included (each ends in a
                        # device-to-host copy of the sampled tokens)
                        "prefill_seconds": 0.0, "decode_seconds": 0.0,
                        # device seconds of the replays (CUDA events)
                        "decode_device_seconds": 0.0}
        self._active_pages = 0     # pages referenced by in-flight requests
        self._cached_pages = 0     # pages referenced by prefix entries
        self._page_stalled = False
        # input signatures seen per entry point (compile_stats)
        self._sigs = {"prefill": set(), "decode": set(), "tail": set(),
                      "copy": set()}

        H = cfg.num_attention_heads
        D = cfg.hidden_size // H
        self._heads, self._head_dim = H, D
        pool_dtype = torch.int8 if self._quant else torch.float32
        shape = (n_pages + 1, P, H, D)          # + the spare page
        L = cfg.num_layers
        dev = self.device
        self._kpools = [torch.zeros(shape, dtype=pool_dtype, device=dev)
                        for _ in range(L)]
        self._vpools = [torch.zeros(shape, dtype=pool_dtype, device=dev)
                        for _ in range(L)]
        if self._quant:
            self._kscales = [torch.zeros(shape[:2], device=dev)
                             for _ in range(L)]
            self._vscales = [torch.zeros(shape[:2], device=dev)
                             for _ in range(L)]
        self._pool_bytes = sum(t.numel() * t.element_size()
                               for g in self._pool_groups() for t in g)
        # the decode step's static inputs (what the graph reads), their
        # host staging arrays (pinned on the card) and the ids' way back
        pin = dev.type == "cuda"
        self._dec_in = (torch.zeros((n_rows, self._W), dtype=torch.int64,
                                    device=dev),
                        torch.zeros(n_rows, dtype=torch.int32, device=dev),
                        torch.zeros((n_rows, n_pt), dtype=torch.int32,
                                    device=dev))
        self._dec_host = tuple(torch.zeros(t.shape, dtype=t.dtype,
                                           pin_memory=pin)
                               for t in self._dec_in)
        self._toks_host = torch.zeros((n_rows, self._W), dtype=torch.int64,
                                      pin_memory=pin)
        self._graphs: dict = {}                 # signature -> _DecodeGraph
        if pin:
            self._events = [torch.cuda.Event(enable_timing=True)
                            for _ in range(3)]
        self._was_training = model.training
        model.eval()

    def _pool_groups(self):
        return [self._kpools, self._vpools] + (
            [self._kscales, self._vscales] if self._quant else [])

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
        :class:`EngineClosedError`.  The prefix index is dropped and every
        page returns to the free list."""
        if self._stop:
            return
        self._stop = True
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=60)
        with self._lock:
            pending = self._drop_all_locked()
            self._page_alloc.check()     # zero leaked pages at teardown
            self._graphs.clear()
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
            out["prefix_entries"] = (0 if self._prefix is None
                                     else len(self._prefix))
            out["kv_pool_bytes"] = self._pool_bytes
            out["kv_num_pages"] = self._page_alloc.num_pages
            out["kv_page_size"] = self._page_alloc.page_size
            out["kv_pages_free"] = self._page_alloc.n_free
            out["kv_pages_used"] = self._page_alloc.n_used
            out["kv_pages_active"] = self._active_pages
            out["kv_pages_cached"] = self._cached_pages
            out.update(self._compile_stats_locked())
        return out

    def compile_stats(self) -> dict:
        """Distinct input signatures per entry point, with the JAX
        engine's keys.  ``decode_compiles`` must stay at 1 with every
        flag on: on the card it counts decode-graph captures, on the CPU
        (no graph) distinct decode signatures (shapes, dtypes and the
        LayerNorm routing).  Prefill and tail prefill run eagerly: their
        signatures are the ``(lanes, bucket)`` shapes."""
        with self._lock:
            return self._compile_stats_locked()

    def _compile_stats_locked(self) -> dict:
        return {"prefill_compiles": len(self._sigs["prefill"]),
                "decode_compiles": len(self._sigs["decode"]),
                "tail_prefill_compiles": len(self._sigs["tail"]),
                "prefix_copy_compiles": len(self._sigs["copy"])}

    # -- scheduler -----------------------------------------------------------
    def _loop(self):
        ctx = (torch.cuda.device(self.device) if self.device.type == "cuda"
               else nullcontext())
        with ctx:
            while not self._stop and self._dead is None:
                try:
                    did = self._step_once()
                except Exception as e:  # noqa: BLE001 — fail loudly
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

    def _drop_all_locked(self) -> list:
        """Free every lane and page: the queued and in-flight requests
        (returned, to be failed), then the prefix index's entries."""
        pending = list(self._queue) + list(self._pool.active().values())
        self._queue.clear()
        for slot in list(self._pool.active()):
            req = self._pool.free(slot)
            if req._prefix_src is not None:
                self._prefix.release(req._prefix_src)
                req._prefix_src = None
            self._release_pages_locked(req)
        if self._prefix is not None:
            for e in self._prefix.drop_all():
                for p in e.pages:
                    self._page_alloc.deref(p)
                self._cached_pages -= len(e.pages)
        return pending

    def _fail_as_dead(self, cause: BaseException):
        with self._lock:
            self._dead = cause
            pending = self._drop_all_locked()
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
        """Head-of-queue requests admit while a lane AND their page
        reservation fit.  A request reserves every page it can ever write
        less the full pages a prefix hit shares (a match ending inside a
        page takes one copy-on-write page); when the free list is short,
        unreferenced prefix entries are evicted LRU-first, sparing those
        this wave is about to hit.  Page exhaustion keeps the head queued
        (FIFO backpressure; admitted work never waits on pages)."""
        alloc = self._page_alloc
        P = alloc.page_size
        want = min(self.prefill_batch, len(self._queue))
        if want == 0:
            self._page_stalled = False
            return []
        protect = set()
        if self._prefix is not None:
            for req in itertools.islice(self._queue, want):
                hit = self._prefix.lookup(req.prompt, peek=True)
                if hit is not None:
                    protect.add(id(hit[0]))
        batch = []
        while self._queue and len(batch) < want and self._pool.n_free > 0:
            req = self._queue[0]
            total = self._pages_for(req.prompt.size + req.max_new_tokens)
            hit = (self._prefix.lookup(req.prompt, peek=True)
                   if self._prefix is not None else None)
            need = total - (hit[1] // P if hit is not None else 0)
            while need > alloc.n_free and self._prefix is not None:
                victims = self._prefix.evict_lru(1, protect=protect)
                if not victims:
                    break
                for p in victims[0].pages:
                    alloc.deref(p)
                self._cached_pages -= len(victims[0].pages)
                self._counts["prefix_evictions"] += 1
            pages = alloc.alloc(need)
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
            if hit is not None:
                entry, matched = hit
                self._prefix.touch(entry)      # count the peeked hit
                self._prefix.acquire(entry)
                req._prefix_src = entry
                req._prefix_match = matched
                req.prefix_hit = True
                self._counts["prefix_hits"] += 1
            elif self._prefix is not None:
                self._prefix.miss()
                self._counts["prefix_misses"] += 1
            self._map_pages_locked(req, pages)
            batch.append(req)
        return batch

    def _map_pages_locked(self, req: RequestHandle, fresh):
        """Fill the lane's page table: a hit entry's fully matched pages
        by reference (refcount + 1 each), then the fresh pages.  When the
        match ends inside a shared page, schedule its copy-on-write clone
        into the first fresh page: the writer diverges on a private copy,
        the cached entry's bytes are untouched."""
        alloc = self._page_alloc
        P = alloc.page_size
        table = self._page_tables[req.slot]
        table[:] = alloc.num_pages
        m = req._prefix_match
        pages = []
        req._cow = None
        if req._prefix_src is not None:
            src_pages = req._prefix_src.pages
            for p in src_pages[:m // P]:
                alloc.share(p)
                pages.append(p)
            if m % P:
                req._cow = (src_pages[m // P], fresh[0])
        pages += fresh
        table[:len(pages)] = pages
        req._pages = pages
        self._active_pages += len(pages)

    def _admit(self) -> bool:
        with self._lock:
            batch = self._admit_locked()
        if not batch:
            return False
        for req in batch:
            if req.temperature > 0:
                req._gen = torch.Generator(device=self.device)
                req._gen.manual_seed(req.seed)
        cold = [r for r in batch if r._prefix_src is None]
        hits = [r for r in batch if r._prefix_src is not None]
        if cold:
            self._prefill(cold)
        if hits:
            self._prefill_hits(hits)
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
        # table; padding positions and padding lanes are not written
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
            self._sigs["prefill"].add((n, bucket))
        self._emit_first_tokens(batch, toks)

    def _prefill_hits(self, hits) -> None:
        """Prefix-hit admission: the hits already share the cached pages
        through their tables (host-side integer writes); the boundary
        pages that copy on write are cloned, then ONLY the prompt tails
        run, through the paged cache over all lanes (ids ``[n_rows, tail
        bucket]``; lanes that are not this wave's hits are parked, so
        their writes land on the spare page), and each hit's first-token
        logits come from its last tail position.  On the card the read
        is the paged kernel in column groups of at most 8 queries."""
        lanes = self.prefill_batch
        NP = self._page_alloc.num_pages
        n_rows = self.max_slots + 1
        # copy-on-write pairs, padded to the lanes with the spare page
        src = np.full(lanes, NP, np.int64)
        dst = np.full(lanes, NP, np.int64)
        n_copy = 0
        tb = _bucket(max(r.prompt.size - r._prefix_match for r in hits), 1,
                     self._limit)
        ids = np.zeros((n_rows, tb), np.int64)
        lens = np.full(n_rows, self._park, np.int32)
        gidx = np.zeros(n_rows, np.int64)
        with self._lock:
            for req in hits:
                if req._cow is not None:
                    src[n_copy], dst[n_copy] = req._cow
                    n_copy += 1
                    req._cow = None
                m = req._prefix_match
                tail = req.prompt[m:]
                ids[req.slot, :tail.size] = tail
                lens[req.slot] = m
                gidx[req.slot] = tail.size - 1
            tables = np.array(self._page_tables)
        dev = self.device
        t0 = time.perf_counter()
        with torch.no_grad():
            if n_copy:
                self._copy_pages(torch.from_numpy(src).to(dev),
                                 torch.from_numpy(dst).to(dev))
            caches = self._caches(torch.from_numpy(lens).to(dev),
                                  torch.from_numpy(tables).to(dev))
            x, _ = self.model.gpt(torch.from_numpy(ids).to(dev),
                                  caches=caches)
            h_last = x[torch.arange(n_rows, device=dev),
                       torch.from_numpy(gidx).to(dev)]
            rows = [None] * n_rows
            for req in hits:
                rows[req.slot] = req
            toks = self._sample(self.model.lm_head(h_last), rows)
        with self._lock:
            self._counts["prefill_batches"] += 1
            self._counts["prefill_seconds"] += time.perf_counter() - t0
            self._counts["page_cow_copies"] += n_copy
            self._counts["tail_prefill_read_groups"] += len(
                _pa.paged_groups(tb))
            self._sigs["tail"].add((n_rows, tb))
            if n_copy:
                self._sigs["copy"].add((lanes,))
        self._emit_first_tokens(hits, toks, by_slot=True)

    def _copy_pages(self, src, dst):
        """Copy-on-write: clone pages ``src`` into ``dst`` over every
        layer's K, V (and scale) pools, one index copy each.  Padding
        lanes copy the spare page onto itself."""
        for group in self._pool_groups():
            for pool in group:
                pool.index_copy_(0, dst, pool.index_select(0, src))

    def _caches(self, lengths, tables):
        """The model's paged cache tuples over the engine's pools, in the
        spare-page form."""
        if self._quant:
            return [(kp, vp, lengths, tables, ks, vs, SPARE_PAGE)
                    for kp, vp, ks, vs in zip(self._kpools, self._vpools,
                                              self._kscales, self._vscales)]
        return [(kp, vp, lengths, tables, SPARE_PAGE)
                for kp, vp in zip(self._kpools, self._vpools)]

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

    def _emit_first_tokens(self, batch, toks, by_slot: bool = False):
        now = time.perf_counter()
        finishers = []
        for i, req in enumerate(batch):
            req.ttft_s = now - req.t_submit
            req._t_last_token = now
            if req.done():
                continue
            token = int(toks[req.slot] if by_slot else toks[i])
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
    def _decode_forward(self):
        """The decode step over the static inputs: the forward through
        the paged cache, the LM head at every position and the argmax.
        What the graph captures; on the CPU it runs as it is."""
        ids, lengths, tables = self._dec_in
        x, _ = self.model.gpt(ids, caches=self._caches(lengths, tables))
        logits = self.model.lm_head(x)                # [n_rows, W, V]
        return logits, logits.argmax(dim=-1)

    def _decode_signature(self) -> tuple:
        return (tuple((tuple(t.shape), t.dtype) for t in self._dec_in),
                self._kpools[0].dtype, _ln.fused_layernorm_mode())

    def _stage(self, ids, lengths, tables):
        """Copy one step's inputs into the static buffers (through the
        pinned staging arrays on the card)."""
        for dev_t, host_t, arr in zip(self._dec_in, self._dec_host,
                                      (ids, lengths, tables)):
            host_t.numpy()[...] = arr
            dev_t.copy_(host_t, non_blocking=True)

    def _capture(self, sig) -> _DecodeGraph:
        """Warm up on a side stream with every lane parked (the writes
        land on the spare page), then capture the step.  The pools are
        never reallocated while the graph lives: the kernels' tensor maps
        hold their addresses."""
        NP = self._page_alloc.num_pages
        park = (np.zeros(self._ids.shape, np.int64),
                np.full(self._lengths.shape, self._park, np.int32),
                np.full(self._page_tables.shape, NP, np.int32))
        self._stage(*park)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(2):
                self._decode_forward()
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = _kernel_launches()
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="thread_local"):
            logits, toks = self._decode_forward()
        launches = {k: v - before[k] for k, v in _kernel_launches().items()}
        entry = _DecodeGraph(graph, logits, toks, launches)
        self._graphs[sig] = entry
        return entry

    def _run_decode(self, ids, lengths, tables):
        """One decode step: ``(logits [n_rows, W, V] on the device, argmax
        ids [n_rows, W] numpy)``.  On the card: replay the step's graph
        (captured at the first step of a new signature)."""
        sig = self._decode_signature()
        if self.device.type != "cuda":
            self._stage(ids, lengths, tables)
            logits, toks = self._decode_forward()
            with self._lock:
                self._sigs["decode"].add(sig)
            return logits, toks.numpy()
        entry = self._graphs.get(sig)
        if entry is None:
            entry = self._capture(sig)
            with self._lock:
                self._sigs["decode"].add(sig)
        self._stage(ids, lengths, tables)
        t0, t1, t2 = self._events
        t0.record()
        entry.graph.replay()
        t1.record()
        self._toks_host.copy_(entry.toks, non_blocking=True)
        t2.record()
        t2.synchronize()
        with self._lock:
            c = self._counts
            c["decode_graph_replays"] += 1
            c["replayed_paged_launches"] += entry.launches["paged"]
            c["replayed_ln_fwd_launches"] += entry.launches["ln_fwd"]
            c["decode_device_seconds"] += 1e-3 * t0.elapsed_time(t1)
        return entry.logits, self._toks_host.numpy()

    def _decode_step(self) -> bool:
        with self._lock:
            active = self._pool.active()
            if not active:
                return False
        W = self._W
        drafts = {}
        if W > 1:
            for slot, req in active.items():
                if req.temperature == 0.0:
                    # prompt-lookup drafts are for greedy rows only: an
                    # accepted draft must equal the model's argmax
                    ctx = np.concatenate(
                        [req.prompt, np.asarray(req._tokens, np.int64)])
                    drafts[slot] = np.asarray(self._drafter(ctx, W - 1),
                                              np.int64)
        with self._lock:
            if W > 1:
                for slot in active:
                    d = drafts.get(slot)
                    self._ids[slot, 1:] = (d if d is not None
                                           else self._ids[slot, 0])
            ids = np.array(self._ids)
            lengths = np.array(self._lengths)
            tables = np.array(self._page_tables)
        t0 = time.perf_counter()
        with torch.no_grad():
            logits, toks = self._run_decode(ids, lengths, tables)
            toks = np.array(toks)
            for slot, req in active.items():
                if req.temperature > 0 and not req.done():
                    toks[slot, 0] = _sample_row(logits[slot, 0],
                                                req.temperature, req.top_k,
                                                req._gen)
        now = time.perf_counter()
        with self._lock:
            self._counts["decode_steps"] += 1
            self._counts["decode_seconds"] += now - t0
        drafted = accepted = 0
        finishers = []
        for slot, req in active.items():
            if req.done():
                continue
            # the draft at position j is kept iff it equals the model's
            # choice at position j - 1; the run emits up to W tokens
            run = [int(toks[slot, 0])]
            d = drafts.get(slot)
            if d is not None:
                for j in range(1, W):
                    if int(d[j - 1]) != int(toks[slot, j - 1]):
                        break
                    run.append(int(toks[slot, j]))
                drafted += W - 1
                accepted += len(run) - 1
            lat = now - req._t_last_token
            req._t_last_token = now
            emitted = 0
            finished = False
            for token in run:
                finished = self._emit_one(req, token)
                emitted += 1
                if finished:
                    break
            req.token_latencies_s.extend([lat / emitted] * emitted)
            with self._lock:
                self._counts["tokens"] += emitted
                # rejected drafts' K/V past the new length is overwritten
                # by the next step
                self._lengths[slot] = int(lengths[slot]) + emitted
                if finished:
                    self._evict_locked(req, "completed")
                else:
                    self._ids[slot, 0] = run[emitted - 1]
            if finished:
                finishers.append(req)
        if drafted:
            with self._lock:
                self._counts["spec_drafted"] += drafted
                self._counts["spec_accepted"] += accepted
        for req in finishers:
            req._finish(None)
        return True

    def _emit_one(self, req: RequestHandle, token: int) -> bool:
        """Stream one token; returns whether the request is finished."""
        req._emit(token)
        return (len(req._tokens) >= req.max_new_tokens or
                (req.eos_token_id is not None and
                 token == req.eos_token_id))

    # -- eviction / retention ------------------------------------------------
    def _release_pages_locked(self, req: RequestHandle):
        if req._pages is not None:
            for p in req._pages:
                self._page_alloc.deref(p)
            self._active_pages -= len(req._pages)
            req._pages = None
        req._cow = None
        if req.slot is not None:
            self._page_tables[req.slot, :] = self._page_alloc.num_pages
            self._lengths[req.slot] = self._park

    def _evict_locked(self, req: RequestHandle, outcome: str):
        if req._prefix_src is not None:
            self._prefix.release(req._prefix_src)
            req._prefix_src = None
        if self._prefix is not None and outcome == "completed":
            # the lane holds the K/V of prompt + generated[:-1] (exactly
            # `lengths[slot]` positions): the entry takes the pages that
            # cover them (no device work), the rest of the reservation is
            # released; a duplicate frees normally
            n = int(self._lengths[req.slot])
            cached = np.concatenate(
                [req.prompt, np.asarray(req._tokens, np.int64)])[:n]
            keep = self._pages_for(n)
            entry = (self._prefix.insert(None, cached,
                                         pages=req._pages[:keep])
                     if keep > 0 else None)
            if entry is not None:
                for p in req._pages[keep:]:
                    self._page_alloc.deref(p)
                self._active_pages -= len(req._pages)
                self._cached_pages += keep
                req._pages = None
                self._counts["prefix_inserts"] += 1
        self._release_pages_locked(req)
        self._pool.free(req.slot)
        self._counts[outcome] += 1
