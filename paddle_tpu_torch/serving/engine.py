"""Continuous-batching serving engine over the paged KV pool.

The port of ``paddle_tpu/serving/engine.py`` for its main serving path,
``Engine(paged_kv=True, decode_kernel="pallas")``, with the decode fast
path's flags, multi-LoRA adapters, int8 base weights, the supervision
surface and the host prefix tier:

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
  all-sentinel tables, so their writes land on the spare page.  On the
  card all of the thread's device work runs on the engine's own CUDA
  stream (non-blocking, so another engine's capture in the same process
  is never invalidated by it).
* **one decode graph**: the decode step's inputs are static device
  buffers (``ids [n_rows, W]``, ``lengths``, ``page_tables`` and, with
  adapters, the per-row bank ids ``[n_rows]``) filled from pinned host
  arrays; on the card the forward, the LM head and the argmax are
  captured once as a ``torch.cuda.CUDAGraph`` per engine config (W, the
  pool dtype, the LayerNorm routing) and replayed every step, and the
  token ids are the step's one device-to-host copy.  A failed capture or
  replay kills the engine; the step never runs eagerly on the card.
  :meth:`Engine.compile_stats` counts the signatures (``decode_compiles``:
  graph captures on the card, distinct decode input signatures on the
  CPU), as the JAX engine's retrace sentinel does.
* ``prefix_cache=True``: completed requests' pages are retained behind a
  content-addressed :class:`PrefixIndex`, keyed by the namespace
  ``(adapter, conversation)``; a hit shares the cached full pages by
  reference (one copy-on-write page where the match ends inside a page)
  and prefills only the prompt's tail through the paged read.  With a
  host tier (``host_prefix_mb=`` / ``host_prefix=``) an evicted entry's
  pages are gathered on the engine's stream and copied to pinned host
  memory by the tier (:class:`HostPrefixTier`); an admission that misses
  the device index but hits the tier uploads the pages into fresh pages
  and proceeds as a hit.
* ``speculative_k=k``: ``k - 1`` drafted tokens a step (:class:`NgramDrafter`
  by default, ``drafter=`` for another) verified in the one ``[n_rows,
  k]`` decode step; greedy rows accept the matched draft prefix.
* ``adapters=AdapterRegistry``: ``submit(adapter=name)`` rows add their
  adapter's LoRA delta to the fused qkv, gathered from stacked device
  banks allocated once before the capture (row 0, the zero adapter, for
  base rows); a cold adapter is copied into its bank row at admission.
  ``weight_dtype="int8"``: the engine serves a copy of the model whose
  2-D weights are int8, dequantized where they are used
  (``adapters/weight_quant.py``).
* **supervision**: ``health()``, ``load()``, ``drain()``, ``abandon()``
  and ``resubmit()``, the ``admission_hook`` and ``redispatch_hook``
  seams and the fault points ``serving.scheduler``, ``serving.prefill``,
  ``serving.decode`` and ``serving.stream`` (``testing/faults.py``).  On
  death, requests that streamed no token are offered to the redispatch
  hook (an :class:`EngineSupervisor` re-enqueues the same handles in a
  rebuilt engine); those that streamed fail with
  :class:`RequestInterruptedError`.  A dead or abandoned engine's thread
  checks that it is dead before every launch and exits without one.
* on the card, prefill attention runs the flash kernel and every decode
  step's and tail prefill's attention read runs the paged decode kernel
  (``paddle_tpu_torch/kernels``); on the CPU the same code runs their
  plain versions.
* **telemetry** (``paddle_tpu_torch.observability``), under the JAX
  engine's names and at its sites: the ``paddle_tpu_serving_*`` counters,
  gauges and histograms (requests by outcome, tokens, TTFT, per-token
  latency, batch seconds by phase, slots, queue depth, pages, prefix,
  speculative, adapter and host-tier series, weight and pool bytes);
  flight events for admit, evict, reject, stalls, loads, promotes, COW
  copies, death, hand-off; spans around each batched prefill, tail
  prefill, prefix copy, adapter load and decode step; the journey phases
  of ``submit(journey=)`` (``engine_queue`` split at an ``adapter_stall``
  / ``page_stall``, ``build`` for the decode graph's capture,
  ``adapter_load``, ``prefix_promote``, ``prefill``, ``prefix_copy``,
  ``tail_prefill``, and one ``decode`` a dispatch with the drafted and
  accepted counts); ``decode_timeout_s`` arms the crash-dump watchdog
  around each prefill, tail prefill and decode step; the device memory
  ledger's rows (``weights``, ``kv_pool``, ``adapter_bank`` and the nested
  ``prefix_cache``); and, with perfscope sampling on, the CUDA-event
  device time of every Nth decode replay against the signature's cost.
  Everything recorded is a host value the step already has (the token
  copy, the lengths on the host): nothing waits for the device to feed a
  metric.

**Sampling.**  Greedy decoding (temperature 0) is exact: the same
weights give the JAX engine's tokens, speculative or not.  With a
temperature (and optional top-k) each request draws from its own
``torch.Generator`` seeded with ``seed``, so a request is reproducible
within the port, but sampled tokens are *distributional*, not seed-equal
to the JAX engine, which draws with threefry ``fold_in`` keys that this
port does not reimplement.  Sampled rows take no drafts and emit one
token a step.

Flags of the JAX engine this port does not have raise
``NotImplementedError`` naming their ROADMAP entry, and so does a model
with MoE layers (entry 4).
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from concurrent.futures import CancelledError
from contextlib import contextmanager, nullcontext
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import layer_norm as _ln
from ..kernels import paged_attention as _pa
from ..kernels.paged_attention import SPARE_PAGE
from ..observability import flight, registry
from ..observability import perfscope as _perfscope
from ..observability import retrace as _retrace
from ..observability import watchdog as _watchdog
from ..observability.trace import span
from ..testing import faults
from .adapters.lora import adapter_scope
from .adapters.registry import AdapterRankError
from .adapters.weight_quant import quantize_model
from .kv_quant import quantize_rows
from .kv_tier import HostPrefixTier
from .paged_kv import PageAllocator
from .prefix_cache import PrefixEntry, PrefixIndex
from .slot_pool import SlotPool
from .speculative import NgramDrafter

__all__ = ["Engine", "RequestHandle", "QueueFullError", "EngineClosedError",
           "EngineDrainingError", "EngineDeadError", "EngineStalledError",
           "RequestInterruptedError", "DeadlineExceededError", "_bucket"]

# -- metric names (paddle_tpu_torch.observability registry; the JAX
# engine's names, so one dashboard reads either package) --------------------
SERVING_ACTIVE_SLOTS = "paddle_tpu_serving_active_slots"
SERVING_QUEUE_DEPTH = "paddle_tpu_serving_queue_depth"
SERVING_REQUESTS = "paddle_tpu_serving_requests_total"
SERVING_TOKENS = "paddle_tpu_serving_tokens_total"
SERVING_TTFT = "paddle_tpu_serving_ttft_seconds"
SERVING_TOKEN_LATENCY = "paddle_tpu_serving_token_seconds"
SERVING_BATCH_SECONDS = "paddle_tpu_serving_batch_seconds"
SERVING_REDISPATCHED = "paddle_tpu_serving_requests_redispatched_total"
SERVING_INTERRUPTED = "paddle_tpu_serving_requests_interrupted_total"
SERVING_PREFIX_HITS = "paddle_tpu_serving_prefix_cache_hits_total"
SERVING_PREFIX_MISSES = "paddle_tpu_serving_prefix_cache_misses_total"
SERVING_PREFIX_EVICTIONS = "paddle_tpu_serving_prefix_cache_evictions_total"
SERVING_SPEC_DRAFTED = "paddle_tpu_serving_speculative_tokens_drafted_total"
SERVING_SPEC_ACCEPTED = \
    "paddle_tpu_serving_speculative_tokens_accepted_total"
SERVING_KV_POOL_BYTES = "paddle_tpu_serving_kv_pool_bytes"
SERVING_KV_PAGES_FREE = "paddle_tpu_serving_kv_pages_free"
SERVING_KV_PAGES_ACTIVE = "paddle_tpu_serving_kv_pages_active"
SERVING_KV_PAGES_CACHED = "paddle_tpu_serving_kv_pages_cached"
SERVING_KV_COW_COPIES = "paddle_tpu_serving_kv_page_cow_copies_total"
SERVING_ADAPTERS_RESIDENT = "paddle_tpu_serving_adapters_resident"
SERVING_ADAPTER_TOKENS = "paddle_tpu_serving_adapter_tokens_total"
SERVING_ADAPTER_TTFT = "paddle_tpu_serving_adapter_ttft_seconds"
SERVING_ADAPTER_LOADS = "paddle_tpu_serving_adapter_loads_total"
SERVING_ADAPTER_EVICTIONS = "paddle_tpu_serving_adapter_evictions_total"
SERVING_ADAPTER_STALLS = "paddle_tpu_serving_adapter_load_stalls_total"
SERVING_WEIGHT_BYTES = "paddle_tpu_serving_weight_bytes"
SERVING_HOST_PREFIX_HITS = "paddle_tpu_serving_host_prefix_hits_total"
SERVING_HOST_PREFIX_PROMOTES = \
    "paddle_tpu_serving_host_prefix_promotes_total"
SERVING_HOST_PREFIX_PROMOTE_SECONDS = \
    "paddle_tpu_serving_host_prefix_promote_seconds"

# the perfscope program names of the engine's dispatches
PROGRAM_DECODE = "serving.decode"


# the retrace sentinel's entry-point names (the JAX engine's)
_RETRACE_NAMES = {"prefill": "serving.prefill", "decode": "serving.decode",
                  "tail": "serving.tail_prefill",
                  "copy": "serving.prefix_copy"}


class QueueFullError(RuntimeError):
    """Admission queue is at capacity — backpressure; retry later."""


class DeadlineExceededError(TimeoutError):
    """The request's deadline passed before it finished."""


class EngineClosedError(RuntimeError):
    """The engine was shut down with this request still in flight."""


class EngineDrainingError(EngineClosedError):
    """The engine is draining: no new admissions, in-flight work finishes
    (retry elsewhere)."""


class EngineDeadError(RuntimeError):
    """The scheduler thread crashed; the engine rejects new work.  A
    request that had streamed no token when the engine died also fails
    with this type (unless a supervisor re-dispatches it): nothing reached
    a consumer, so a retry is duplication-safe."""

    def __init__(self, cause: BaseException):
        super().__init__(
            f"serving scheduler died: {type(cause).__name__}: {cause}")
        self.cause = cause


class EngineStalledError(RuntimeError):
    """The scheduler stopped making progress with work pending: a
    supervisor declared the engine dead through :meth:`Engine.abandon`."""


class RequestInterruptedError(RuntimeError):
    """The engine died after this request streamed token(s): a replay
    would duplicate what was delivered, so the caller gets this error
    naming how far the stream got and the engine's failure."""

    def __init__(self, request_id: int, tokens_streamed: int,
                 cause: BaseException):
        super().__init__(
            f"request {request_id} interrupted after {tokens_streamed} "
            f"streamed token(s): {type(cause).__name__}: {cause}")
        self.request_id = request_id
        self.tokens_streamed = tokens_streamed
        self.cause = cause


@contextmanager
def _armed(name: str, timeout: float):
    _watchdog.arm(name, timeout)
    try:
        yield
    finally:
        _watchdog.disarm()


class _Retired(Exception):
    """The engine died or shut down under its own scheduler thread: the
    thread exits without another launch."""


_ids = itertools.count(1)


class RequestHandle:
    """Future-style handle for one submitted request: ``result(timeout)``
    returns the generated ids (or raises the request's error), ``tokens``
    is the stream so far, ``ttft_s`` and ``token_latencies_s`` carry the
    latency telemetry, and ``journey`` (when the caller passed one) the
    request's phase timeline."""

    def __init__(self, engine, prompt, max_new_tokens, eos_token_id,
                 temperature, top_k, seed, deadline_s, stream,
                 adapter=None, conversation=None, journey=None):
        self.request_id = next(_ids)
        self.redispatches = 0        # times re-enqueued after an engine death
        self.adapter = adapter       # LoRA adapter name (None: base model)
        self.conversation = conversation  # prefix-index namespace qualifier
        self.journey = journey       # observability.journey.Journey or None
        self._adapter_slot = 0       # bank row while active (0: zero adapter)
        self._adapter_pinned = False
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
        self._torn = False                # torn off a dead/abandoned engine
        self._cancel_requested = False
        self._done = threading.Event()
        self._error: Optional[BaseException] = None
        self._tokens: list[int] = []
        self.slot: Optional[int] = None
        self._pages: Optional[list] = None    # backing pages, in table order
        self._prefix_src = None           # PrefixEntry this request shares
        self._prefix_match = 0            # tokens covered by that entry
        self._cow = None                  # pending (src, dst) page COW copy
        self._promote = None              # pending (host entry, match) upload
        self.prefix_hit = False           # admitted through a prefix hit
        self.promote_s: Optional[float] = None   # host-tier promote wall s
        now = time.perf_counter()
        self.t_submit = now
        self.t_queue = now           # engine-queue entry (reset on resubmit)
        self._stall_t0: Optional[float] = None   # HOL stall began (journey)
        self._stall_kind: Optional[str] = None   # adapter_stall | page_stall
        self._park_t0: Optional[float] = None    # parked by a supervisor
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
        if self._done.is_set() or self._torn:
            # torn off a dead engine while a dispatch was in flight: a
            # zero-token handle must stay zero-token for its re-dispatch
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


# The streams of engines that were shut down, by device.  PyTorch keeps a
# cuBLAS workspace (32 MiB on sm_90) for every stream that ran a product,
# for the life of the process, so a new engine (a supervisor's rebuild)
# takes a former engine's stream before it makes one.
_spare_streams: dict = {}
_spare_lock = threading.Lock()
# One decode-graph capture at a time in the process, and no graph freed
# during one: ``torch.cuda.graph`` synchronizes the device and empties the
# allocator's cache on entry, which must not land inside another engine's
# capture (an autoscaler's scale-up beside its warm-pool refill, a
# rollout's build beside a supervisor's rebuild).
_capture_lock = threading.Lock()


def _take_stream(dev) -> "torch.cuda.Stream":
    with _spare_lock:
        spare = _spare_streams.get(dev)
        if spare:
            return spare.pop()
    return torch.cuda.Stream(dev)


def _give_stream(dev, stream):
    with _spare_lock:
        _spare_streams.setdefault(dev, []).append(stream)


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
        admission_hook: ``hook(request, load)`` called by ``submit`` after
            validation, before the request is queued; raising rejects the
            request (counted as ``rejected``) and reaches the caller.
        redispatch_hook: ``hook(requests, cause) -> taken``, called from
            the dying scheduler thread with the requests that streamed no
            token; it returns those it takes (an
            :class:`EngineSupervisor` re-enqueues them in a rebuilt
            engine).  Requests not taken fail with
            :class:`EngineDeadError`; requests that streamed tokens fail
            with :class:`RequestInterruptedError`.
        adapters: an ``AdapterRegistry``: ``submit(adapter=name)`` rows
            add that adapter's LoRA delta, gathered from stacked device
            banks in the same decode step (bank row 0 is the base model).
            The registry persists across rebuilds; bank residency
            (refcount + LRU, cold loads at admission, backpressure when
            every row is pinned) is this build's.
        weight_dtype: None (the model's weights) or ``"int8"``: serve a
            copy of the model with int8 2-D weights and per-channel
            scales, dequantized where they are used.
        host_prefix_mb: give this engine its own host prefix tier of this
            many MiB (closed by :meth:`shutdown`).
        host_prefix: a shared :class:`HostPrefixTier` (outlives this
            engine: a supervisor's factory hands the same tier to every
            build).  Either tier needs ``prefix_cache=True``.
        decode_kernel: ``"pallas"``, the JAX flag value for the fused
            paged read; here it is the CUDA paged decode kernel.
        tokenizer: optional — lets ``submit`` accept strings (``encode``)
            and the gateway take string prompts.
        decode_timeout_s: arm the crash-dump watchdog around every batched
            prefill, tail prefill and decode step (default: the
            ``PADDLE_TPU_DECODE_TIMEOUT_S`` env var): a stalled dispatch
            writes a bundle naming the stuck phase (the flight tail, the
            open spans, every thread's stack) instead of a silent hang.
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
                 admission_hook: Optional[Callable] = None,
                 redispatch_hook: Optional[Callable] = None,
                 decode_timeout_s: Optional[float] = None,
                 sample_on_device: bool = False,
                 decode_kernel: str = "pallas", tokenizer=None):
        self.device = resolve_device(device)
        if decode_kernel not in ("xla", "pallas"):
            raise ValueError(f"decode_kernel must be 'xla' or 'pallas', "
                             f"got {decode_kernel!r}")
        if kv_dtype not in (None, "int8"):
            raise ValueError(f"kv_dtype must be None or 'int8', "
                             f"got {kv_dtype!r}")
        if weight_dtype not in (None, "int8"):
            raise ValueError(f"weight_dtype must be None or 'int8', "
                             f"got {weight_dtype!r}")
        k = int(speculative_k)
        if k < 0:
            raise ValueError(f"speculative_k must be >= 0, got {k}")
        if not paged_kv:
            raise _unported("the dense slot pool (paged_kv=False)")
        if decode_kernel == "xla":
            raise _unported("decode_kernel='xla' (the gather read)")
        if sample_on_device:
            raise _unported("sample_on_device (device-fused sampling)")
        if model.gpt.config.moe_num_experts > 0:
            raise _unported("serving a model with MoE layers (capacity "
                            "routing over the decode graph's padded slots)")
        if host_prefix is not None and host_prefix_mb is not None:
            raise ValueError(
                "pass host_prefix_mb= (engine-owned tier) OR host_prefix= "
                "(shared tier), not both")
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
        self.tokenizer = tokenizer
        if decode_timeout_s is None:
            raw = os.environ.get("PADDLE_TPU_DECODE_TIMEOUT_S", "")
            try:
                decode_timeout_s = float(raw)
            except ValueError:
                decode_timeout_s = None
        self._decode_timeout_s = (float(decode_timeout_s)
                                  if decode_timeout_s and
                                  decode_timeout_s > 0 else None)
        self.kv_dtype = kv_dtype
        self._quant = kv_dtype == "int8"
        self._auto_start = bool(auto_start)
        self.admission_hook = admission_hook
        self.redispatch_hook = redispatch_hook
        self.speculative_k = k
        self._W = max(1, k)                     # decode width
        self._drafter = (drafter if drafter is not None
                         else NgramDrafter() if self._W > 1 else None)
        self._prefix = (PrefixIndex(block=prefix_block) if prefix_cache
                        else None)
        # the host tier: engine-owned (host_prefix_mb=, closed by
        # shutdown) or shared (host_prefix=, outlives every build)
        self._host_tier = None
        self._own_host_tier = False
        if host_prefix is not None or host_prefix_mb is not None:
            if self._prefix is None:
                raise ValueError("the host prefix tier requires "
                                 "paged_kv=True and prefix_cache=True")
            if host_prefix is not None:
                if host_prefix.block != self._prefix.block:
                    raise ValueError(
                        f"host tier block={host_prefix.block} does not "
                        f"match prefix_block={self._prefix.block}")
                self._host_tier = host_prefix
            else:
                self._host_tier = HostPrefixTier(
                    capacity_mb=float(host_prefix_mb),
                    block=self._prefix.block)
                self._own_host_tier = True
        # adapters: the registry persists across rebuilds; residency (bank
        # rows, pins, LRU) is this build's
        self.adapter_registry = adapters
        self._adapters = adapters.residency() if adapters is not None \
            else None
        self._adapter_uploads: dict = {}     # name -> bank row, pending
        self._adapter_stalled = False

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
        self._draining = False
        self._dead: Optional[BaseException] = None
        self._last_progress = time.perf_counter()
        self._thread: Optional[threading.Thread] = None
        self._ids = np.zeros((n_rows, self._W), np.int64)
        # idle lanes park at the pool's virtual end with all-sentinel
        # tables: their decode writes land on the spare page and their
        # reads are skipped
        self._park = n_pt * P
        self._lengths = np.full(n_rows, self._park, np.int32)
        self._page_tables = np.full((n_rows, n_pt), n_pages, np.int32)
        self._aids = np.zeros(n_rows, np.int64)   # bank row per lane
        self._counts = {"submitted": 0, "completed": 0, "rejected": 0,
                        "cancelled": 0, "deadline_expired": 0, "failed": 0,
                        "resubmitted": 0, "redispatched": 0,
                        "interrupted": 0,
                        "decode_steps": 0, "prefill_batches": 0,
                        "tokens": 0, "page_alloc_stalls": 0,
                        "prefix_hits": 0, "prefix_misses": 0,
                        "prefix_inserts": 0, "prefix_evictions": 0,
                        "page_cow_copies": 0, "spec_drafted": 0,
                        "spec_accepted": 0,
                        "adapter_hits": 0, "adapter_loads": 0,
                        "adapter_evictions": 0, "adapter_load_stalls": 0,
                        # host wall of the cold loads (the bank rows'
                        # copies are enqueued, not waited for)
                        "adapter_load_seconds": 0.0,
                        "host_prefix_hits": 0, "host_prefix_promotes": 0,
                        "host_prefix_promoted_pages": 0,
                        # device seconds of the promotes' uploads (CUDA
                        # events; host wall on the CPU)
                        "host_prefix_promote_seconds": 0.0,
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
                        "decode_device_seconds": 0.0,
                        # device memory the decode-graph captures reserved
                        "decode_graph_reserved_bytes": 0,
                        # host wall of the captures (their two warm-up
                        # steps included)
                        "decode_capture_seconds": 0.0}
        self._evicted_wave = 0     # prefix entries one admission evicted
        self._build = None         # the last capture's (start, seconds)
        self._active_pages = 0     # pages referenced by in-flight requests
        self._cached_pages = 0     # pages referenced by prefix entries
        self._page_stalled = False
        self._promote_events: list = []   # (start, end, pages) to resolve
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
        on_card = dev.type == "cuda"
        # the thread's own stream (the caller's stream waits for the
        # allocations below, the engine's for the model's weights)
        self._stream = _take_stream(dev) if on_card else None
        if weight_dtype == "int8":
            self._net, self._weight_bytes = quantize_model(model)
        else:
            self._net = model
            self._weight_bytes = sum(t.numel() * t.element_size()
                                     for t in model.state_dict().values())
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
        if adapters is not None:
            # allocated once, before any capture, and never reallocated:
            # the decode graph reads them by address
            R, r, h = (self._adapters.capacity, adapters.max_rank,
                       cfg.hidden_size)
            self._abank = torch.zeros((R + 1, L, h, r), device=dev)
            self._bbank = torch.zeros((R + 1, L, r, 3 * h), device=dev)
            self._ascale = torch.zeros(R + 1, device=dev)
            # host staging rows for the cold loads, pinned here: pinning
            # while serving would stall every thread's CUDA calls
            self._astage = torch.zeros(self._abank.shape,
                                       pin_memory=on_card)
            self._bstage = torch.zeros(self._bbank.shape,
                                       pin_memory=on_card)
        # the device memory ledger's rows (observability/perfscope.py): one
        # per long-lived allocation this build owns, released by shutdown
        # (a rebuilt engine registers its own), and the prefix cache's
        # pages as a nested sub-account of the pool bytes
        led = _perfscope.ledger()
        self._ledger_rows = [led.register(
            "weights", self._weight_bytes,
            detail=("serving weights, int8 + scales"
                    if weight_dtype == "int8" else "serving weights"))]
        if adapters is not None:
            self._ledger_rows.append(led.register(
                "adapter_bank", sum(t.numel() * t.element_size() for t in
                                    (self._abank, self._bbank,
                                     self._ascale)),
                detail=f"stacked LoRA banks, {self._adapters.capacity} rows "
                       f"+ zero adapter"))
        self._ledger_rows.append(led.register(
            "kv_pool", self._pool_bytes,
            detail=f"paged KV pool, {n_pages} pages + the spare"))
        self._ledger_prefix = (led.register(
            "prefix_cache", 0, nested=True,
            detail="retained KV pages (bytes inside kv_pool)")
            if self._prefix is not None else None)
        if self._ledger_prefix is not None:
            self._ledger_rows.append(self._ledger_prefix)
        self._page_bytes = self._pool_bytes // (n_pages + 1)
        reg = registry()
        reg.gauge(SERVING_WEIGHT_BYTES,
                  "device bytes of the serving weight operands as stored"
                  ).set(float(self._weight_bytes))
        reg.gauge(SERVING_KV_POOL_BYTES,
                  "device bytes of the serving KV pools (incl. int8 scales)"
                  ).set(float(self._pool_bytes))
        # the decode step's GEMM operations a token (the trunk's linears
        # and the tied head; perfscope's cost of the decode signature)
        self._gemm_params = sum(
            m.weight.numel() for m in model.modules()
            if isinstance(m, torch.nn.Linear)) + \
            model.gpt.embeddings.word_embeddings.weight.numel()
        # the decode step's static inputs (what the graph reads), their
        # host staging arrays (pinned on the card) and the ids' way back
        dec = [torch.zeros((n_rows, self._W), dtype=torch.int64, device=dev),
               torch.zeros(n_rows, dtype=torch.int32, device=dev),
               torch.zeros((n_rows, n_pt), dtype=torch.int32, device=dev)]
        if adapters is not None:
            dec.append(torch.zeros(n_rows, dtype=torch.int64, device=dev))
        self._dec_in = tuple(dec)
        self._dec_host = tuple(torch.zeros(t.shape, dtype=t.dtype,
                                           pin_memory=on_card)
                               for t in self._dec_in)
        self._toks_host = torch.zeros((n_rows, self._W), dtype=torch.int64,
                                      pin_memory=on_card)
        self._graphs: dict = {}                 # signature -> _DecodeGraph
        if on_card:
            self._events = [torch.cuda.Event(enable_timing=True)
                            for _ in range(3)]
            self._stream.wait_stream(torch.cuda.current_stream(dev))
            torch.cuda.current_stream(dev).wait_stream(self._stream)
        self._was_training = model.training
        model.eval()

    def _pool_groups(self):
        return [self._kpools, self._vpools] + (
            [self._kscales, self._vscales] if self._quant else [])

    def _on_stream(self):
        """The engine's stream for the block (the CPU has none)."""
        return (torch.cuda.stream(self._stream) if self._stream is not None
                else nullcontext())

    def _scope(self, aids):
        """The adapter scope of one forward over rows with bank ids
        ``aids`` (a device tensor), or nothing without adapters."""
        if self._adapters is None:
            return nullcontext()
        return adapter_scope(aids, self._abank, self._bbank, self._ascale)

    def _check_live(self):
        """Before every launch: a dead or shut-down engine's thread exits
        without one."""
        if self._dead is not None or self._stop:
            raise _Retired()

    # -- request API ---------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 16, eos_token_id=...,
               temperature: float = 0.0, top_k: int = 0, seed: int = 0,
               deadline_s: Optional[float] = None,
               stream: Optional[Callable[[int], None]] = None,
               adapter: Optional[str] = None,
               conversation: Optional[str] = None,
               journey=None) -> RequestHandle:
        """Queue one request; returns its handle.  Raises
        :class:`QueueFullError` when the queue is full and ``ValueError``
        when the request cannot fit a slot.  ``adapter`` names a
        registered LoRA adapter (an unknown name or a rank that can never
        fit the bank raises the registry's typed error here);
        ``conversation`` qualifies the prefix namespace to ``(adapter,
        conversation)``; ``journey`` is an optional
        :class:`~paddle_tpu_torch.observability.journey.Journey` the engine
        appends its phases to (the caller finishes it)."""
        if self._dead is not None:
            raise EngineDeadError(self._dead) from self._dead
        if self._stop:
            raise EngineClosedError("engine is shut down")
        if self._draining:
            raise EngineDrainingError(
                "engine is draining; no new admissions")
        if isinstance(prompt, str):
            if self.tokenizer is None:
                raise ValueError("string prompt needs a tokenizer")
            prompt = self.tokenizer.encode(prompt)
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
        if adapter is not None:
            if self._adapters is None:
                raise ValueError(
                    "this engine has no adapter registry "
                    "(Engine(adapters=AdapterRegistry(...)))")
            entry = self.adapter_registry.get(adapter)   # typed: unknown
            if entry.rank > self.adapter_registry.max_rank:
                raise AdapterRankError(
                    f"adapter {adapter!r} rank {entry.rank} exceeds the "
                    f"bank width max_rank="
                    f"{self.adapter_registry.max_rank}: it can never "
                    f"become resident")
        eos = self.eos_token_id if eos_token_id is ... else eos_token_id
        req = RequestHandle(self, ids, max_new_tokens, eos, temperature,
                            top_k, seed, deadline_s, stream,
                            adapter=adapter, conversation=conversation,
                            journey=journey)
        hook = self.admission_hook
        if hook is not None:
            try:
                hook(req, self.load())
            except Exception:
                with self._lock:
                    self._counts["rejected"] += 1
                flight.record("serving", "reject", request=req.request_id,
                              reason="admission_hook")
                registry().counter(
                    SERVING_REQUESTS, "serving requests by outcome").inc(
                    1.0, labels={"outcome": "rejected"})
                raise
        with self._lock:
            if len(self._queue) >= self.max_queue:
                self._counts["rejected"] += 1
                self._gauges_locked()
                flight.record("serving", "reject", request=req.request_id,
                              queue_depth=len(self._queue),
                              max_queue=self.max_queue)
                registry().counter(
                    SERVING_REQUESTS, "serving requests by outcome").inc(
                    1.0, labels={"outcome": "rejected"})
                raise QueueFullError(
                    f"admission queue full ({self.max_queue}); retry later")
            self._queue.append(req)
            self._counts["submitted"] += 1
            self._gauges_locked()
        registry().counter(SERVING_REQUESTS,
                           "serving requests by outcome").inc(
            1.0, labels={"outcome": "submitted"})
        if self._auto_start:
            self.start()
        self._wake.set()
        return req

    def resubmit(self, req: RequestHandle) -> RequestHandle:
        """Re-enqueue a handle taken off a dead engine (the supervisor's
        re-dispatch): the same handle enters this engine's queue, so a
        caller blocked on ``result()`` never notices.  Only zero-token
        handles are accepted.  Bypasses the admission hook and the queue
        bound (the request was admitted once already)."""
        if req._tokens:
            raise ValueError(
                f"request {req.request_id} already streamed "
                f"{len(req._tokens)} token(s); re-dispatch would "
                f"duplicate them")
        if req.adapter is not None and self._adapters is None:
            raise ValueError(
                f"request {req.request_id} needs adapter {req.adapter!r} "
                f"but this engine has no adapter registry")
        if self._dead is not None:
            raise EngineDeadError(self._dead) from self._dead
        if self._stop:
            raise EngineClosedError("engine is shut down")
        req._engine = self
        req._state = "queued"
        req._torn = False
        req.t_queue = time.perf_counter()   # journey engine_queue restarts
        req._stall_t0 = None
        req._stall_kind = None
        req.slot = None
        req._prefix_src = None  # the dead engine's pool (and index) is gone
        req._prefix_match = 0
        req._pages = None
        req._cow = None
        req._promote = None
        req.prefix_hit = False
        req._adapter_slot = 0   # the dead engine's banks (and pins) died
        req._adapter_pinned = False
        req.redispatches += 1
        with self._lock:
            self._queue.append(req)
            self._counts["resubmitted"] += 1
            self._gauges_locked()
        flight.record("serving", "resubmit", request=req.request_id,
                      redispatches=req.redispatches)
        registry().counter(
            SERVING_REDISPATCHED,
            "requests re-dispatched after an engine death").inc(
            1.0, labels={"layer": "supervisor"})
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

    def drain(self, deadline_s: float = 30.0) -> bool:
        """Stop admission (submits raise :class:`EngineDrainingError`,
        ``load()`` advertises not-alive) while every queued and in-flight
        request finishes; True when all did before the deadline."""
        with self._lock:
            self._draining = True
            depth, active = len(self._queue), self._pool.n_active
        flight.record("serving", "drain_begin", queue_depth=depth,
                      active_slots=active, deadline_s=float(deadline_s))
        if (depth or active) and self._dead is None and not self._stop:
            self.start()
        ok = self.join(timeout=deadline_s) and self._dead is None
        flight.record("serving", "drain_done", drained=ok)
        return ok

    def undrain(self):
        """Reverse :meth:`drain` on an engine still alive; raises on a dead
        or shut-down one."""
        if self._dead is not None:
            raise EngineDeadError(self._dead) from self._dead
        if self._stop:
            raise EngineClosedError("engine is shut down")
        with self._lock:
            was = self._draining
            self._draining = False
        if was:
            flight.record("serving", "undrain")

    def abandon(self, cause: Optional[BaseException] = None):
        """Declare the engine dead from outside its scheduler thread (a
        stall): it stops taking work and its requests are classified as
        for a crash.  Idempotent; a no-op on a dead or shut-down
        engine."""
        if self._dead is not None or self._stop:
            return
        self._fail_as_dead(cause or EngineStalledError(
            "engine abandoned by its supervisor"))
        self._wake.set()

    def shutdown(self):
        """Stop the scheduler; queued and in-flight requests fail with
        :class:`EngineClosedError`.  The prefix index is dropped, every
        page returns to the free list, and once the scheduler thread has
        exited the engine's device memory (graphs, pools, banks) is
        released.  An engine-owned host tier is closed; a shared one is
        not."""
        if self._stop:
            return
        self._stop = True
        self._wake.set()
        if self._thread is not None:
            # a dead engine's thread is exiting, or stuck in a stalled
            # dispatch after abandon(): do not wait long for it
            self._thread.join(timeout=30 if self._dead is None else 5)
        with self._lock:
            queued, active = self._drop_all_locked()
            self._page_alloc.check()     # zero leaked pages at teardown
            if self._adapters is not None:
                self._adapters.check()   # zero leaked adapter pins
            self._gauges_locked()
            ledger_rows, self._ledger_rows = self._ledger_rows, []
            self._ledger_prefix = None
        if self._thread is None or not self._thread.is_alive():
            self._release_device()
        # this build's device memory goes with its pools and banks: a
        # leaked ledger row would mean leaked device bytes
        for row in ledger_rows:
            row.release()
        if self._own_host_tier:
            self._host_tier.close()
        _perfscope.record_memory_stats()
        err = EngineClosedError("engine shut down")
        for req in queued + active:
            req._finish(err)
        if self._was_training:
            self.model.train()

    close = shutdown

    def _release_device(self):
        """Free this build's device memory: the decode graphs (and their
        private pools), the KV pools, the adapter banks, the static inputs
        and the int8 serving copy."""
        if self._stream is not None:
            self._stream.synchronize()
        with _capture_lock:
            for entry in self._graphs.values():
                entry.graph.reset()
            self._graphs.clear()
        if self._stream is not None:
            _give_stream(self.device, self._stream)
            self._stream = None
        self._kpools, self._vpools = [], []
        self._kscales = self._vscales = []
        self._abank = self._bbank = self._ascale = None
        self._astage = self._bstage = None
        self._dec_in = ()
        self._net = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False

    # -- introspection -------------------------------------------------------
    def queue_depth(self) -> int:
        """Queued, unadmitted requests."""
        with self._lock:
            return len(self._queue)

    def slots_in_use(self) -> int:
        """Lanes owned by in-flight requests."""
        with self._lock:
            return self._pool.n_active

    def adapter_resident(self, name: str) -> bool:
        """True when the adapter occupies a bank row of this build (loaded
        or about to be)."""
        with self._lock:
            return (self._adapters is not None and
                    self._adapters.slot_of(name) is not None)

    def weight_bytes(self) -> int:
        """Device bytes of the serving weights as stored (int8 values and
        f32 scales under ``weight_dtype="int8"``)."""
        return self._weight_bytes

    def load(self) -> dict:
        """One-lock load snapshot for admission and routing."""
        with self._lock:
            return {"queue_depth": len(self._queue),
                    "slots_in_use": self._pool.n_active,
                    "max_slots": self.max_slots,
                    "max_queue": self.max_queue,
                    "max_len": self.max_len,
                    "alive": (self._dead is None and not self._stop and
                              not self._draining),
                    "draining": self._draining,
                    "kv_pages_free": self._page_alloc.n_free,
                    "kv_num_pages": self._page_alloc.num_pages}

    def health(self) -> dict:
        """Liveness: ``alive`` while the engine can take and make progress
        on requests; ``progress_age_s`` is the time since the scheduler
        last finished an iteration (growing with work pending: a stall);
        ``warm`` once the decode step is captured (a frozen age then means
        a stall, not a capture)."""
        with self._lock:
            active, depth = self._pool.n_active, len(self._queue)
            progress_age = time.perf_counter() - self._last_progress
            warm = len(self._sigs["decode"]) >= 1
        return {"alive": (self._dead is None and not self._stop and
                          not self._draining),
                "dead": self._dead is not None,
                "draining": self._draining,
                "error": (None if self._dead is None
                          else f"{type(self._dead).__name__}: {self._dead}"),
                "stopped": self._stop,
                "scheduler_running": (self._thread is not None and
                                      self._thread.is_alive()),
                "active_slots": active, "queue_depth": depth,
                "progress_age_s": progress_age, "warm": warm}

    def stats(self) -> dict:
        with self._lock:
            self._resolve_promotes_locked()
            out = dict(self._counts)
            out["active_slots"] = self._pool.n_active
            out["queue_depth"] = len(self._queue)
            out["slot_allocs"] = self._pool.alloc_total
            out["slot_reuses"] = self._pool.reuse_total
            out["prefix_entries"] = (0 if self._prefix is None
                                     else len(self._prefix))
            out["kv_pool_bytes"] = self._pool_bytes
            out["weight_bytes"] = self._weight_bytes
            if self._adapters is not None:
                out["adapters_resident"] = self._adapters.n_resident
                out["adapters_pinned"] = self._adapters.n_pinned
                out["adapter_bank_capacity"] = self._adapters.capacity
            out["kv_num_pages"] = self._page_alloc.num_pages
            out["kv_page_size"] = self._page_alloc.page_size
            out["kv_pages_free"] = self._page_alloc.n_free
            out["kv_pages_used"] = self._page_alloc.n_used
            out["kv_pages_active"] = self._active_pages
            out["kv_pages_cached"] = self._cached_pages
            out.update(self._compile_stats_locked())
        if self._host_tier is not None:
            out["host_prefix"] = self._host_tier.stats()
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

    def _add_sig(self, kind, sig) -> bool:
        """Book ``sig`` for entry point ``kind`` (under ``_lock``); True
        when it is new."""
        book = self._sigs[kind]
        if sig in book:
            return False
        book.add(sig)
        return True

    def _note_build(self, kind, sig, seconds):
        """A new signature of entry point ``kind``: a build for the
        retrace sentinel, under the JAX engine's names."""
        _retrace.note_compile(_RETRACE_NAMES[kind], sig, seconds,
                              len(self._sigs[kind]))

    def _compile_stats_locked(self) -> dict:
        return {"prefill_compiles": len(self._sigs["prefill"]),
                "decode_compiles": len(self._sigs["decode"]),
                "tail_prefill_compiles": len(self._sigs["tail"]),
                "prefix_copy_compiles": len(self._sigs["copy"])}

    # -- scheduler -----------------------------------------------------------
    def _loop(self):
        ctx = (torch.cuda.device(self.device) if self.device.type == "cuda"
               else nullcontext())
        with ctx, self._on_stream():
            while not self._stop and self._dead is None:
                try:
                    did = self._step_once()
                except _Retired:
                    return
                except Exception as e:  # noqa: BLE001 — fail loudly
                    # an OOM names the ledger's owners in a crash bundle
                    _perfscope.note_exception(e, program="serving")
                    self._fail_as_dead(e)
                    raise
                with self._lock:
                    # the progress heartbeat (health()): it freezes while a
                    # dispatch is stuck
                    self._last_progress = time.perf_counter()
                if not did:
                    self._wake.wait(0.02)
                    self._wake.clear()

    def _step_once(self) -> bool:
        """One iteration: sweep, admit (batched prefill), one batched
        decode step.  Returns whether any work happened."""
        faults.fault_point("serving.scheduler")
        self._sweep()
        did = self._admit()
        return self._decode_step() or did

    def _drop_all_locked(self):
        """Free every lane, page, adapter pin and prefix entry; returns
        the (queued, active) requests, to be finished by the caller."""
        queued = list(self._queue)
        active = list(self._pool.active().values())
        self._queue.clear()
        for slot in list(self._pool.active()):
            req = self._pool.free(slot)
            if req._prefix_src is not None:
                self._prefix.release(req._prefix_src)
                req._prefix_src = None
            self._release_pages_locked(req)
            if self._adapters is not None:
                self._unpin_adapter_locked(req)
        if self._prefix is not None:
            for e in self._prefix.drop_all():
                if e.pages:
                    for p in e.pages:
                        self._page_alloc.deref(p)
                    self._cached_pages -= len(e.pages)
        return queued, active

    def _fail_as_dead(self, cause: BaseException):
        """Death, from the dying scheduler thread or :meth:`abandon`: mark
        the engine dead, free its lanes and pages, and classify its
        requests by what reached a consumer.  Zero-token requests go to
        the redispatch hook (those it does not take fail with
        :class:`EngineDeadError`); streamed ones fail with
        :class:`RequestInterruptedError`."""
        with self._lock:
            if self._dead is not None:
                return
            self._dead = cause
            queued, active = self._drop_all_locked()
            for r in queued + active:
                # freeze the streams first: a stuck dispatch may still
                # come back and try to emit
                r._torn = True
            self._gauges_locked()
        flight.record("serving", "scheduler_error",
                      error=f"{type(cause).__name__}: {cause}",
                      queued=len(queued), active=len(active))
        fresh = [r for r in queued + active if not r._tokens]
        streamed = [r for r in active if r._tokens]
        taken: set = set()
        hook = self.redispatch_hook
        if hook is not None and fresh:
            try:
                taken = {id(r) for r in hook(list(fresh), cause)}
            except Exception:  # noqa: BLE001 — a broken hook must not
                taken = set()  # mask the death
        lost = [r for r in fresh if id(r) not in taken]
        with self._lock:
            self._counts["failed"] += len(lost) + len(streamed)
            self._counts["redispatched"] += len(taken)
            self._counts["interrupted"] += len(streamed)
        for r in lost:
            r._finish(EngineDeadError(cause))
        reg = registry()
        for r in streamed:
            flight.record("serving", "interrupted", request=r.request_id,
                          tokens=len(r._tokens))
            reg.counter(SERVING_INTERRUPTED,
                        "requests failed mid-stream by an engine death"
                        ).inc(1.0)
            r._finish(RequestInterruptedError(r.request_id, len(r._tokens),
                                              cause))
        if taken:
            flight.record("serving", "handoff", n=len(taken),
                          requests=",".join(str(r.request_id) for r in fresh
                                            if id(r) in taken))

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
                    self._evicted_counters_locked(req, outcome)
                    to_finish.append((req, outcome))
            for req in self._pool.active().values():
                if req._cancel_requested or (req.deadline is not None and
                                             now > req.deadline):
                    outcome = ("cancelled" if req._cancel_requested
                               else "deadline_expired")
                    self._evict_locked(req, outcome)
                    to_finish.append((req, outcome))
            if to_finish:
                self._gauges_locked()
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
                self._evicted_counters_locked(req, "cancelled")
                self._gauges_locked()
                req._finish(CancelledError())
                return True
        self._wake.set()
        return True

    # -- admission -----------------------------------------------------------
    def _pages_for(self, n_tokens: int) -> int:
        return -(-int(n_tokens) // self._page_alloc.page_size)

    @staticmethod
    def _req_ns(req: RequestHandle):
        """Prefix namespace of a request: its adapter, or ``(adapter,
        conversation)`` when it carries a conversation id."""
        return (req.adapter if req.conversation is None
                else (req.adapter, req.conversation))

    @staticmethod
    def _journey_admit_locked(req: RequestHandle, **attrs):
        """Close the request's engine-queue window on its journey: one
        ``engine_queue`` phase (queue entry -> admit), split at the stall
        boundary into an ``adapter_stall`` / ``page_stall`` phase when the
        head-of-line request spent part of the window blocked on bank pins
        or page exhaustion."""
        j = req.journey
        if j is None:
            return
        stall_t0, kind = req._stall_t0, req._stall_kind
        req._stall_t0 = None
        req._stall_kind = None
        if stall_t0 is not None and kind is not None and \
                stall_t0 > req.t_queue:
            j.phase("engine_queue", req.t_queue, stall_t0 - req.t_queue,
                    **attrs)
            j.phase(kind, stall_t0, req.t_admit - stall_t0)
        else:
            j.phase("engine_queue", req.t_queue,
                    req.t_admit - req.t_queue, **attrs)

    @staticmethod
    def _mark_stall_locked(req: RequestHandle, kind: str):
        """First time the head-of-line request blocks this episode:
        remember when, so the admit-time journey phase can attribute the
        stalled tail of the queue wait to its cause."""
        if req._stall_t0 is None:
            req._stall_t0 = time.perf_counter()
            req._stall_kind = kind

    def _pin_adapter_locked(self, req: RequestHandle) -> bool:
        """Make the request's adapter resident and pinned before its lane
        is taken, scheduling a cold bank load when needed.  False when
        every bank row is pinned by other in-flight work: the request
        stays queued (head-of-line backpressure, as page exhaustion)."""
        if req.adapter is None or req._adapter_pinned:
            return True
        res = self._adapters
        ev0 = res.evictions
        got = res.acquire(req.adapter)
        if got is None:
            self._mark_stall_locked(req, "adapter_stall")
            if not self._adapter_stalled:
                self._adapter_stalled = True
                self._counts["adapter_load_stalls"] += 1
                flight.record("serving", "adapter_load_stall",
                              request=req.request_id, adapter=req.adapter,
                              resident=res.n_resident)
                registry().counter(
                    SERVING_ADAPTER_STALLS,
                    "admissions stalled on a fully-pinned adapter bank"
                ).inc(1.0)
            return False
        slot, cold = got
        self._adapter_stalled = False
        req._adapter_slot = slot
        req._adapter_pinned = True
        dev = res.evictions - ev0
        if dev:
            self._counts["adapter_evictions"] += dev
            flight.record("serving", "adapter_evict", n=dev,
                          request=req.request_id, for_adapter=req.adapter)
            registry().counter(
                SERVING_ADAPTER_EVICTIONS,
                "refs-0 adapters evicted from the bank (LRU)").inc(
                float(dev))
        if cold:
            if req.adapter not in self._adapter_uploads:
                self._counts["adapter_loads"] += 1
                self._adapter_uploads[req.adapter] = slot
        else:
            self._counts["adapter_hits"] += 1
        return True

    def _unpin_adapter_locked(self, req: RequestHandle):
        """Drop the request's pin (the row stays resident at refs 0 for
        the next hit; only LRU pressure reclaims it)."""
        if req._adapter_pinned:
            self._adapters.release(req.adapter)
            req._adapter_pinned = False
        req._adapter_slot = 0

    def _demote_locked(self, e):
        """Hand an evicted prefix entry's pages to the host tier: gather
        them into fresh device tensors on the engine's stream now, before
        the pages are dereferenced (a later write to a reused page is
        ordered after the gather on the same stream); the tier copies
        them to pinned host memory on a side stream off this thread."""
        idx = torch.tensor(e.pages, dtype=torch.int64, device=self.device)
        gathered = [[pool.index_select(0, idx) for pool in grp]
                    for grp in self._pool_groups()]
        self._host_tier.demote_async(e.ns, e.tokens, gathered)

    def _admit_locked(self) -> list:
        """Head-of-queue requests admit while a lane, their adapter's bank
        row and their page reservation fit.  A request reserves every
        page it can ever write less the full pages a prefix hit shares (a
        match ending inside a page takes one copy-on-write page); when the
        free list is short, unreferenced prefix entries are evicted
        LRU-first (demoted to the host tier when there is one), sparing
        those this wave is about to hit.  Exhaustion keeps the head queued
        (FIFO backpressure; admitted work never waits)."""
        alloc = self._page_alloc
        P = alloc.page_size
        want = min(self.prefill_batch, len(self._queue))
        if want == 0 or self._dead is not None or self._stop:
            self._page_stalled = False
            self._adapter_stalled = False
            return []
        protect = set()
        if self._prefix is not None:
            for req in itertools.islice(self._queue, want):
                hit = self._prefix.lookup(req.prompt, peek=True,
                                          ns=self._req_ns(req))
                if hit is not None:
                    protect.add(id(hit[0]))
        batch = []
        while self._queue and len(batch) < want and self._pool.n_free > 0:
            req = self._queue[0]
            if not self._pin_adapter_locked(req):
                break
            ns = self._req_ns(req)
            total = self._pages_for(req.prompt.size + req.max_new_tokens)
            hit = (self._prefix.lookup(req.prompt, peek=True, ns=ns)
                   if self._prefix is not None else None)
            # a device miss probes the host tier: a host hit still takes
            # the whole reservation, the prefix uploads into its own pages
            promote = (self._host_tier.lookup(req.prompt, peek=True, ns=ns)
                       if hit is None and self._host_tier is not None
                       else None)
            need = total - (hit[1] // P if hit is not None else 0)
            while need > alloc.n_free and self._prefix is not None:
                victims = self._prefix.evict_lru(1, protect=protect)
                if not victims:
                    break
                e = victims[0]
                if self._host_tier is not None and e.pages:
                    self._demote_locked(e)
                for p in e.pages:
                    alloc.deref(p)
                self._cached_pages -= len(e.pages)
                self._counts["prefix_evictions"] += 1
                self._evicted_wave += 1
                flight.record("serving", "prefix_evict",
                              pages=len(e.pages), cached_tokens=e.n)
            pages = alloc.alloc(need)
            if pages is None:
                # the pin is dropped so a parked request holds no bank row;
                # the stall is flight-recorded once an episode
                self._unpin_adapter_locked(req)
                self._mark_stall_locked(req, "page_stall")
                if not self._page_stalled:
                    self._page_stalled = True
                    self._counts["page_alloc_stalls"] += 1
                    flight.record("serving", "page_alloc_stall",
                                  request=req.request_id, need=need,
                                  free=alloc.n_free,
                                  cached_pages=self._cached_pages)
                break
            self._page_stalled = False
            self._queue.popleft()
            req.slot = self._pool.alloc(req)
            req._state = "active"
            req.t_admit = time.perf_counter()
            self._journey_admit_locked(
                req, slot=req.slot, pages_reserved=len(pages),
                pages_shared=(hit[1] // P if hit is not None else 0))
            if hit is not None:
                entry, matched = hit
                self._prefix.touch(entry)      # count the peeked hit
                self._prefix.acquire(entry)
                req._prefix_src = entry
                req._prefix_match = matched
                req.prefix_hit = True
                self._counts["prefix_hits"] += 1
            elif promote is not None:
                hentry, matched = promote
                self._host_tier.touch(hentry)
                self._host_tier.acquire(hentry)   # not droppable meanwhile
                req._promote = (hentry, matched)
                self._counts["host_prefix_hits"] += 1
                self._prefix.miss()
                self._counts["prefix_misses"] += 1
            elif self._prefix is not None:
                self._prefix.miss()
                self._counts["prefix_misses"] += 1
                if self._host_tier is not None:
                    self._host_tier.miss()
            self._map_pages_locked(req, pages)
            self._aids[req.slot] = req._adapter_slot
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
            self._evicted_wave = 0
            batch = self._admit_locked()
            evicted = self._evicted_wave
            prefix_metrics = None
            if self._prefix is not None and batch:
                # a host-tier promote counts as a miss here (the JAX
                # engine's count: it becomes a hit only as it uploads)
                prefix_metrics = (sum(1 for r in batch if r.prefix_hit),
                                  sum(1 for r in batch if not r.prefix_hit))
            self._gauges_locked()
        if not batch:
            return False
        if evicted:
            registry().counter(
                SERVING_PREFIX_EVICTIONS,
                "prefix-cache rows evicted back to the free list").inc(
                float(evicted))
        if prefix_metrics is not None:
            reg = registry()
            hits, misses = prefix_metrics
            if hits:
                reg.counter(SERVING_PREFIX_HITS,
                            "admissions served from the prefix cache").inc(
                    float(hits))
            if misses:
                reg.counter(SERVING_PREFIX_MISSES,
                            "admissions with no usable cached prefix").inc(
                    float(misses))
        for req in batch:
            if req.temperature > 0:
                req._gen = torch.Generator(device=self.device)
                req._gen.manual_seed(req.seed)
        self._flush_adapter_uploads(batch)
        self._flush_promotes(batch)
        cold = [r for r in batch if r._prefix_src is None]
        hits = [r for r in batch if r._prefix_src is not None]
        if cold:
            self._prefill(cold)
        if hits:
            self._prefill_hits(hits)
        return True

    def _flush_adapter_uploads(self, batch=()):
        """Cold loads: write each scheduled adapter's zero-padded factors
        into its row of the pinned staging banks and copy the row into the
        device banks on the engine's stream, ahead of every forward that
        reads it (the admission's prefill then waits for the stream, so a
        staging row is never rewritten under its copy).  The mapping is
        checked again in case a stalled request's row was reused first.
        Every request of ``batch`` (the admission wave) waiting on a
        loaded adapter gets an ``adapter_load`` phase on its journey."""
        if self._adapters is None:
            return
        with self._lock:
            ups = [(name, slot) for name, slot in self._adapter_uploads.items()
                   if self._adapters.slot_of(name) == slot]
            self._adapter_uploads.clear()
        for name, slot in ups:
            self._check_live()
            t0 = time.perf_counter()
            with span("serving.adapter_load", adapter=name, bank_slot=slot):
                ad = self.adapter_registry.get(name)
                a = self._astage[slot].numpy()
                b = self._bstage[slot].numpy()
                a[...] = 0.0
                b[...] = 0.0
                for i in range(ad.num_layers):
                    a[i, :, :ad.rank] = ad.a[i]
                    b[i, :ad.rank, :] = ad.b[i]
                self._abank[slot].copy_(self._astage[slot],
                                        non_blocking=True)
                self._bbank[slot].copy_(self._bstage[slot],
                                        non_blocking=True)
                self._ascale[slot].fill_(ad.scale)
            dt = time.perf_counter() - t0
            with self._lock:
                if self._adapters.slot_of(name) == slot:
                    self._adapters.mark_loaded(name)
                self._counts["adapter_load_seconds"] += dt
            registry().counter(
                SERVING_ADAPTER_LOADS,
                "cold adapter loads into the device bank").inc(1.0)
            flight.record("serving", "adapter_load", adapter=name,
                          bank_slot=slot, load_ms=round(dt * 1e3, 3))
            for req in batch:
                if req.adapter == name and req.journey is not None:
                    req.journey.phase("adapter_load", t0, dt, adapter=name,
                                      bank_slot=slot)

    def _flush_promotes(self, batch):
        """Host-tier promotion: upload each promoted request's cached
        prefix into the fresh pages admission reserved for it (one
        ``index_copy_`` a pool, from pinned host memory, on the engine's
        stream), then insert the prefix into the device index, so the
        request proceeds as a zero-copy hit (tail prefill only) and the
        next turn hits on the device.  The bytes land as they were
        demoted (int8 payloads and f32 scales alike)."""
        if self._host_tier is None:
            return
        tier = self._host_tier
        with self._lock:
            todo = [(req,) + req._promote for req in batch
                    if req._promote is not None]
        P = self._page_alloc.page_size
        for req, hentry, m in todo:
            self._check_live()
            q = -(-m // P)                       # pages holding m tokens
            pids = req._pages[:q]
            t0 = time.perf_counter()
            try:
                payload = tier.payload(hentry, q)
            except KeyError:
                # the entry went (tier closed elsewhere): the request keeps
                # its whole reservation and prefills cold
                with self._lock:
                    req._promote = None
                    tier.release(hentry)
                continue
            idx = torch.tensor(pids, dtype=torch.int64, device=self.device)
            timed = self._stream is not None
            if timed:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            for grp, host_grp in zip(self._pool_groups(), payload):
                for pool, arr in zip(grp, host_grp):
                    pool.index_copy_(0, idx, arr.to(self.device,
                                                    non_blocking=True))
            if timed:
                ev[1].record()
            with self._lock:
                if timed:
                    self._promote_events.append(ev + (q,))
                else:
                    self._counts["host_prefix_promote_seconds"] += \
                        time.perf_counter() - t0
                    self._counts["host_prefix_promoted_pages"] += q
                req._promote = None
                entry = self._prefix.insert(None, hentry.tokens[:m],
                                            pages=list(pids), ns=hentry.ns)
                if entry is not None:
                    # the index and this request each hold a page ref
                    for p in pids:
                        self._page_alloc.share(p)
                    self._cached_pages += q
                else:
                    # a duplicate already owns (ns, tokens[:m]): ride the
                    # hit path on a detached entry (no page sharing)
                    entry = PrefixEntry(None, hentry.tokens[:m], 0,
                                        pages=None, ns=hentry.ns)
                self._prefix.acquire(entry)
                req._prefix_src = entry
                req._prefix_match = m
                req._cow = None                  # page-aligned by block
                req.prefix_hit = True
                dt = req.promote_s = time.perf_counter() - t0
                self._counts["host_prefix_promotes"] += 1
                # the upload may still read the slab: the tier rewrites the
                # entry's range only after it
                tier.release(hentry, ev[1] if timed else None)
            # the wall of the upload's enqueue and the re-index (the
            # device time is host_prefix_promote_seconds in stats())
            reg = registry()
            reg.counter(
                SERVING_HOST_PREFIX_HITS,
                "admissions whose prefix was found in the host tier").inc(
                1.0)
            reg.counter(
                SERVING_HOST_PREFIX_PROMOTES,
                "host-tier prefixes re-uploaded into device pages").inc(1.0)
            reg.histogram(
                SERVING_HOST_PREFIX_PROMOTE_SECONDS,
                "host->device promote wall seconds (upload + re-index)"
            ).observe(dt)
            nbytes = q * self._page_bytes
            flight.record("serving", "host_prefix_promote",
                          request=req.request_id, cached_tokens=m,
                          pages=q, bytes=nbytes,
                          promote_ms=round(dt * 1e3, 3))
            if req.journey is not None:
                req.journey.phase("prefix_promote", t0, dt,
                                  cached_tokens=m, pages=q, bytes=nbytes)

    def _resolve_promotes_locked(self):
        """Fold the finished promotes' CUDA-event times into the counts."""
        left = []
        for start, end, pages in self._promote_events:
            if end.query():
                self._counts["host_prefix_promote_seconds"] += \
                    1e-3 * start.elapsed_time(end)
                self._counts["host_prefix_promoted_pages"] += pages
            else:
                left.append((start, end, pages))
        self._promote_events = left

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
        aids = np.zeros(n, np.int64)
        with self._lock:
            for i, req in enumerate(batch):
                ids[i, :req.prompt.size] = req.prompt
                plens[i] = req.prompt.size
                tables[i] = self._page_tables[req.slot]
                aids[i] = req._adapter_slot
                flight.record("serving", "admit", request=req.request_id,
                              slot=req.slot,
                              prompt_len=int(req.prompt.size),
                              queue_wait_ms=round(
                                  1e3 * (req.t_admit - req.t_submit), 3))
        # host-side scatter plan: prompt positions map through the lane's
        # table; padding positions and padding lanes are not written
        pos = np.arange(bucket)
        pid = np.where(pos[None, :] < plens[:, None],
                       tables[:, np.minimum(pos // P, n_pt - 1)], NP)
        lane, col = np.nonzero(pid < NP)
        dev = self.device
        H, D = self._heads, self._head_dim
        t0 = time.perf_counter()
        # the watchdog's window covers the seam: a stalled dispatch (or a
        # fault that stalls it) dumps while the thread is still stuck
        with self._deadline("serving.prefill"):
            faults.fault_point("serving.prefill", n=len(batch))
            self._check_live()
            with torch.no_grad(), span("serving.prefill", n=len(batch),
                                       bucket=bucket):
                caches = [(torch.zeros((n, bucket, H, D), device=dev),
                           torch.zeros((n, bucket, H, D), device=dev), 0)
                          for _ in self._kpools]
                with self._scope(torch.from_numpy(aids).to(dev)):
                    x, new_caches = self._net.gpt(
                        torch.from_numpy(ids).to(dev), caches=caches)
                h_last = x[torch.arange(n, device=dev),
                           torch.from_numpy(plens - 1).to(dev)]
                logits = self._net.lm_head(h_last)
                idx = (torch.from_numpy(pid[lane, col]).long().to(dev),
                       torch.from_numpy(col % P).long().to(dev))
                src = (torch.from_numpy(lane).to(dev),
                       torch.from_numpy(col).to(dev))
                for i, (kb, vb, _) in enumerate(new_caches):
                    self._write_pages(i, idx, kb[src], vb[src])
                toks = self._sample(logits, batch)
        dt = time.perf_counter() - t0
        with self._lock:
            self._counts["prefill_batches"] += 1
            self._counts["prefill_seconds"] += dt
            fresh = self._add_sig("prefill", (n, bucket))
        if fresh:
            self._note_build("prefill", (n, bucket), dt)
        registry().histogram(SERVING_BATCH_SECONDS,
                             "prefill/decode batch wall time").observe(
            dt, labels={"phase": "prefill"})
        for req in batch:
            if req.journey is not None:
                req.journey.phase("prefill", t0, dt, n=len(batch),
                                  bucket=bucket,
                                  prompt=int(req.prompt.size))
        self._emit_first_tokens(batch, toks)

    def _deadline(self, name: str):
        """The crash-dump watchdog armed around one dispatch (nothing
        without ``decode_timeout_s``)."""
        if self._decode_timeout_s is None:
            return nullcontext()
        return _armed(name, self._decode_timeout_s)

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
        cow_ids: list = []           # requests whose boundary page COWs
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
                    cow_ids.append(req.request_id)
                    req._cow = None
                m = req._prefix_match
                tail = req.prompt[m:]
                ids[req.slot, :tail.size] = tail
                lens[req.slot] = m
                gidx[req.slot] = tail.size - 1
                flight.record("serving", "prefix_admit",
                              request=req.request_id, slot=req.slot,
                              src_slot=-1, cached_tokens=m,
                              tail=int(tail.size),
                              queue_wait_ms=round(
                                  1e3 * (req.t_admit - req.t_submit), 3))
            tables = np.array(self._page_tables)
            aids = np.array(self._aids)
        dev = self.device
        t0 = time.perf_counter()
        with self._deadline("serving.tail_prefill"):
            faults.fault_point("serving.prefill", n=len(hits))
            self._check_live()
            with torch.no_grad():
                if n_copy:
                    with span("serving.prefix_copy", n=n_copy):
                        self._copy_pages(torch.from_numpy(src).to(dev),
                                         torch.from_numpy(dst).to(dev))
                    registry().counter(
                        SERVING_KV_COW_COPIES,
                        "shared KV pages cloned for a diverging writer"
                    ).inc(float(n_copy))
                    flight.record("serving", "page_cow", copies=n_copy,
                                  requests=",".join(map(str, cow_ids)))
                t_copy_end = time.perf_counter()
                with span("serving.tail_prefill", n=len(hits), bucket=tb):
                    caches = self._caches(torch.from_numpy(lens).to(dev),
                                          torch.from_numpy(tables).to(dev))
                    with self._scope(torch.from_numpy(aids).to(dev)):
                        x, _ = self._net.gpt(torch.from_numpy(ids).to(dev),
                                             caches=caches)
                    h_last = x[torch.arange(n_rows, device=dev),
                               torch.from_numpy(gidx).to(dev)]
                    rows = [None] * n_rows
                    for req in hits:
                        rows[req.slot] = req
                    toks = self._sample(self._net.lm_head(h_last), rows)
        t_end = time.perf_counter()
        registry().histogram(SERVING_BATCH_SECONDS,
                             "prefill/decode batch wall time").observe(
            t_end - t0, labels={"phase": "tail_prefill"})
        cow_set = set(cow_ids)
        for req in hits:
            if req.journey is None:
                continue
            m = req._prefix_match
            # paged hits share pages by reference (zero copy) unless a
            # boundary page was cloned
            if req.request_id in cow_set:
                req.journey.phase("prefix_copy", t0, t_copy_end - t0,
                                  cached_tokens=m)
            req.journey.phase("tail_prefill", t_copy_end,
                              t_end - t_copy_end, cached_tokens=m,
                              tail=int(req.prompt.size - m),
                              zero_copy=req.request_id not in cow_set)
        with self._lock:
            self._counts["prefill_batches"] += 1
            self._counts["prefill_seconds"] += t_end - t0
            self._counts["page_cow_copies"] += n_copy
            self._counts["tail_prefill_read_groups"] += len(
                _pa.paged_groups(tb))
            fresh = [("tail", (n_rows, tb), t_end - t_copy_end)
                     ] if self._add_sig("tail", (n_rows, tb)) else []
            if n_copy and self._add_sig("copy", (lanes,)):
                fresh.append(("copy", (lanes,), t_copy_end - t0))
        for kind, sig, dt in fresh:
            self._note_build(kind, sig, dt)
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
        """Shared tail of both admission paths: record TTFT and emit each
        request's first token."""
        now = time.perf_counter()
        finishers = []
        reg = registry()
        ttft_hist = reg.histogram(SERVING_TTFT, "time to first token")
        for i, req in enumerate(batch):
            req.ttft_s = now - req.t_submit
            req._t_last_token = now
            ttft_hist.observe(req.ttft_s)
            if req.adapter is not None:
                reg.histogram(
                    SERVING_ADAPTER_TTFT,
                    "time to first token, per adapter").observe(
                    req.ttft_s, labels={"adapter": req.adapter})
            if req.done() or req._torn or req._engine is not self:
                continue
            token = int(toks[req.slot] if by_slot else toks[i])
            if req.journey is not None:
                req.journey.mark_first_token(now)
            finished = self._emit_one(req, token)
            if req.adapter is not None:
                reg.counter(SERVING_ADAPTER_TOKENS,
                            "tokens served, per adapter").inc(
                    1.0, labels={"adapter": req.adapter})
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
        the paged cache (with each row's adapter), the LM head at every
        position and the argmax.  What the graph captures; on the CPU it
        runs as it is."""
        ids, lengths, tables = self._dec_in[:3]
        with self._scope(self._dec_in[3] if self._adapters is not None
                         else None):
            x, _ = self._net.gpt(ids, caches=self._caches(lengths, tables))
        logits = self._net.lm_head(x)                 # [n_rows, W, V]
        return logits, logits.argmax(dim=-1)

    def _decode_signature(self) -> tuple:
        return (tuple((tuple(t.shape), t.dtype) for t in self._dec_in),
                self._kpools[0].dtype, _ln.fused_layernorm_mode())

    def _stage(self, *arrays):
        """Copy one step's inputs (ids, lengths, tables and, with
        adapters, the bank ids) into the static buffers (through the
        pinned staging arrays on the card)."""
        for dev_t, host_t, arr in zip(self._dec_in, self._dec_host, arrays):
            host_t.numpy()[...] = arr
            dev_t.copy_(host_t, non_blocking=True)

    def _capture(self, sig) -> _DecodeGraph:
        """Warm up on the engine's stream with every lane parked (the
        writes land on the spare page), then capture the step there.  The
        pools and banks are never reallocated while the graph lives: the
        kernels' tensor maps hold their addresses."""
        NP = self._page_alloc.num_pages
        park = (np.zeros(self._ids.shape, np.int64),
                np.full(self._lengths.shape, self._park, np.int32),
                np.full(self._page_tables.shape, NP, np.int32),
                np.zeros(self._aids.shape, np.int64))
        self._stage(*park)
        side = self._stream
        with _capture_lock:
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                for _ in range(2):
                    self._decode_forward()
            torch.cuda.current_stream(self.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            before = _kernel_launches()
            # the graph's private pool: the device memory the capture
            # reserves (the capture empties the cache first; so does this,
            # so the warm-up's freed blocks are not counted)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(self.device)
            with torch.cuda.graph(graph, stream=side,
                                  capture_error_mode="thread_local"):
                logits, toks = self._decode_forward()
            reserved = torch.cuda.memory_reserved(self.device) - reserved
            launches = {k: v - before[k]
                        for k, v in _kernel_launches().items()}
        entry = _DecodeGraph(graph, logits, toks, launches)
        self._graphs[sig] = entry
        with self._lock:
            self._counts["decode_graph_reserved_bytes"] += reserved
        return entry

    def _decode_cost(self, lengths) -> dict:
        """perfscope's cost of one decode step whose rows start at
        ``lengths``: the GEMMs' operations (2 x the linears' and the tied
        head's parameters x the rows' tokens) and the paged reads'
        (``paged_cost`` a layer), the weights read once, the reads' bytes
        and the logits written."""
        n_rows, W = self._ids.shape
        P = self._page_alloc.page_size
        f_att, b_att = _pa.paged_cost(lengths, W, self._heads,
                                      self._head_dim, P,
                                      self._max_pages_per_slot, self._quant)
        L = len(self._kpools)
        V = self.model.gpt.config.vocab_size
        tokens = n_rows * W
        return {"flops": 2.0 * tokens * self._gemm_params + L * f_att,
                "bytes accessed": (self._weight_bytes + L * b_att
                                   + 4.0 * tokens * V),
                "dtype": "float32"}

    def _register_decode_cost(self, sig):
        """The signature's cost, as registered once per signature: every
        lane but the scratch one live at its longest start."""
        n_rows, W = self._ids.shape
        full = self._park - W
        lengths = [full] * (n_rows - 1) + [self._park]
        _perfscope.register_cost(PROGRAM_DECODE, sig,
                                 self._decode_cost(lengths))

    def _run_decode(self, *inputs):
        """One decode step over ``inputs`` (see :meth:`_stage`): ``(logits
        [n_rows, W, V] on the device, argmax ids [n_rows, W] numpy)``.  On
        the card: replay the step's graph (captured at the first step of a
        new signature; the capture's (start, seconds) is left in
        ``_build`` for the step's journeys).
        With perfscope sampling on, every Nth step's device time is booked
        against its cost: CUDA events around the replay, read after the
        step's one device-to-host copy (so sampling adds no wait; the
        copy's wait goes through ``perfscope.block_ready``)."""
        self._check_live()
        sig = self._decode_signature()
        sample = (_perfscope.poll_sample(PROGRAM_DECODE)
                  if _perfscope.sampling_active() else False)
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            self._stage(*inputs)
            logits, toks = self._decode_forward()
            with self._lock:
                fresh = self._add_sig("decode", sig)
            if fresh:
                self._note_build("decode", sig, time.perf_counter() - t0)
                self._register_decode_cost(sig)
            if sample:
                _perfscope.block_ready(toks)
                _perfscope.record_sample(PROGRAM_DECODE, sig,
                                         time.perf_counter() - t0,
                                         cost=self._decode_cost(inputs[1]))
            return logits, toks.numpy()
        entry = self._graphs.get(sig)
        if entry is None:
            t_b0 = time.perf_counter()
            entry = self._capture(sig)
            self._build = (t_b0, time.perf_counter() - t_b0)
            with self._lock:
                self._add_sig("decode", sig)
                self._counts["decode_capture_seconds"] += self._build[1]
            self._note_build("decode", sig, self._build[1])
            self._register_decode_cost(sig)
        self._stage(*inputs)
        t0, t1, t2 = self._events
        t0.record()
        entry.graph.replay()
        t1.record()
        self._toks_host.copy_(entry.toks, non_blocking=True)
        t2.record()
        if sample:
            _perfscope.block_ready(t2)
        else:
            t2.synchronize()
        device_s = 1e-3 * t0.elapsed_time(t1)
        with self._lock:
            c = self._counts
            c["decode_graph_replays"] += 1
            c["replayed_paged_launches"] += entry.launches["paged"]
            c["replayed_ln_fwd_launches"] += entry.launches["ln_fwd"]
            c["decode_device_seconds"] += device_s
        if sample:
            _perfscope.record_sample(PROGRAM_DECODE, sig, device_s,
                                     cost=self._decode_cost(inputs[1]))
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
            inputs = (np.array(self._ids), np.array(self._lengths),
                      np.array(self._page_tables), np.array(self._aids))
        lengths = inputs[1]
        t0 = time.perf_counter()
        with self._deadline("serving.decode"):
            faults.fault_point("serving.decode", active=len(active))
            with torch.no_grad(), span("serving.decode", active=len(active)):
                logits, toks = self._run_decode(*inputs)
                toks = np.array(toks)
                for slot, req in active.items():
                    if req.temperature > 0 and not req.done():
                        toks[slot, 0] = _sample_row(
                            logits[slot, 0], req.temperature, req.top_k,
                            req._gen)
        now = time.perf_counter()
        dt = now - t0
        build, self._build = self._build, None
        with self._lock:
            self._counts["decode_steps"] += 1
            self._counts["decode_seconds"] += dt
        registry().histogram(SERVING_BATCH_SECONDS,
                             "prefill/decode batch wall time").observe(
            dt, labels={"phase": "decode"})
        tok_hist = registry().histogram(SERVING_TOKEN_LATENCY,
                                        "per-token decode latency")
        drafted = accepted = 0
        finishers = []
        for slot, req in active.items():
            if req.done() or req._torn or req._engine is not self:
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
            # one pool read emitted `emitted` tokens: split the wall time
            # so the per-token histogram stays sum-preserving
            req.token_latencies_s.extend([lat / emitted] * emitted)
            for _ in range(emitted):
                tok_hist.observe(lat / emitted)
            if req.adapter is not None:
                registry().counter(
                    SERVING_ADAPTER_TOKENS,
                    "tokens served, per adapter").inc(
                    float(emitted), labels={"adapter": req.adapter})
            if req.journey is not None:
                # one phase per batched dispatch the request rode, from
                # its launch to the end of the token copy; on a cold start
                # the step's head up to the end of the graph's capture is
                # a ``build`` phase instead (attributed, not a gap)
                t_dec = t0
                if build is not None:
                    t_dec = build[0] + build[1]
                    req.journey.phase("build", t0, t_dec - t0)
                attrs = {"emitted": emitted, "active": len(active)}
                if d is not None:
                    attrs["drafted"] = W - 1
                    attrs["accepted"] = len(run) - 1
                req.journey.phase("decode", t_dec, now - t_dec, **attrs)
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
            reg = registry()
            reg.counter(SERVING_SPEC_DRAFTED,
                        "speculative tokens drafted").inc(float(drafted))
            if accepted:
                reg.counter(SERVING_SPEC_ACCEPTED,
                            "speculative tokens accepted").inc(
                    float(accepted))
            flight.record("serving", "spec_verify", drafted=drafted,
                          accepted=accepted, rejected=drafted - accepted)
        for req in finishers:
            req._finish(None)
        with self._lock:
            self._gauges_locked()
        return True

    def _emit_one(self, req: RequestHandle, token: int) -> bool:
        """Stream one token; returns whether the request is finished."""
        faults.fault_point("serving.stream", request=req.request_id)
        req._emit(token)
        registry().counter(SERVING_TOKENS, "tokens generated").inc(1.0)
        return (len(req._tokens) >= req.max_new_tokens or
                (req.eos_token_id is not None and
                 token == req.eos_token_id))

    # -- eviction / retention ------------------------------------------------
    def _release_pages_locked(self, req: RequestHandle):
        if req._promote is not None:
            # a promote that never ran: unpin the tier entry
            self._host_tier.release(req._promote[0])
            req._promote = None
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
                                         pages=req._pages[:keep],
                                         ns=self._req_ns(req))
                     if keep > 0 else None)
            if entry is not None:
                for p in req._pages[keep:]:
                    self._page_alloc.deref(p)
                self._active_pages -= len(req._pages)
                self._cached_pages += keep
                req._pages = None
                self._counts["prefix_inserts"] += 1
                flight.record("serving", "prefix_insert", pages=keep,
                              request=req.request_id, cached_tokens=n)
        self._release_pages_locked(req)
        self._pool.free(req.slot)
        if self._adapters is not None:
            self._unpin_adapter_locked(req)
            self._aids[req.slot] = 0
        self._evicted_counters_locked(req, outcome)

    def _evicted_counters_locked(self, req: RequestHandle, outcome: str):
        self._counts[outcome] += 1
        flight.record("serving", "evict", request=req.request_id,
                      slot=-1 if req.slot is None else req.slot,
                      outcome=outcome, tokens=len(req._tokens))
        registry().counter(SERVING_REQUESTS,
                           "serving requests by outcome").inc(
            1.0, labels={"outcome": outcome})

    def _gauges_locked(self):
        reg = registry()
        if self._ledger_prefix is not None:
            # the cached pages' bytes: a sub-account of the kv_pool owner
            self._ledger_prefix.update(self._cached_pages * self._page_bytes)
        reg.gauge(SERVING_ACTIVE_SLOTS,
                  "slots currently owned by requests").set(
            float(self._pool.n_active))
        reg.gauge(SERVING_QUEUE_DEPTH, "queued, unadmitted requests").set(
            float(len(self._queue)))
        if self._adapters is not None:
            reg.gauge(SERVING_ADAPTERS_RESIDENT,
                      "adapters resident in the device bank").set(
                float(self._adapters.n_resident))
        reg.gauge(SERVING_KV_PAGES_FREE,
                  "KV pages on the free list").set(
            float(self._page_alloc.n_free))
        reg.gauge(SERVING_KV_PAGES_ACTIVE,
                  "KV pages referenced by in-flight requests "
                  "(shared pages count once per reference)").set(
            float(self._active_pages))
        reg.gauge(SERVING_KV_PAGES_CACHED,
                  "KV pages referenced by prefix-cache entries "
                  "(shared pages count once per reference)").set(
            float(self._cached_pages))
