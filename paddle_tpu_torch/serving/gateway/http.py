"""HTTP front door — stdlib ``http.server`` over the Gateway core.

The port's copy of ``paddle_tpu/serving/gateway/http.py``: the same
routes, status codes, headers and JSON bodies.  Endpoints:

* ``POST /v1/completions`` — OpenAI-compatible completions; with
  ``"stream": true`` the response is ``text/event-stream`` carried over
  chunked transfer encoding, one SSE ``data:`` event per token and a
  final ``data: [DONE]``.
* ``POST /v1/chat/completions`` — the conversation-first door:
  ``messages`` flatten to one prompt, an optional ``conversation`` id
  namespaces the prefix cache per (adapter, conversation) so a returning
  user's turn N+1 costs tail-prefill only.  Same admission / streaming /
  journey machinery as completions; responses frame as
  ``chat.completion[.chunk]``.
* ``GET /healthz`` — liveness JSON (200 while any replica is alive,
  503 otherwise).
* ``GET /metrics`` — the process-wide Prometheus exposition (serving +
  gateway series from the paddle_tpu_torch.observability registry);
  scraping it refreshes the ``paddle_tpu_gateway_window_*`` gauges from
  the rolling :class:`~paddle_tpu_torch.observability.journey.
  TelemetryWindow` AND the ``paddle_tpu_device_memory_bytes`` allocator
  gauges (``perfscope.record_memory_stats``; absent without a card).
* ``GET /debug/requests?last=N&tenant=&outcome=`` — the newest N
  finished request journeys as JSON timelines (phase-level latency
  attribution).  ``tenant=`` and ``outcome=`` filter the whole ring
  before the ``last`` tail, so a busy multi-tenant ring stays navigable.
* ``GET /debug/requests/<id>`` — one journey by id (live or finished).
* ``GET /debug/capture?last=N&tenant=&outcome=&conversation=`` — the
  traffic-capture ring: one entry per request the gateway saw, admitted
  or shed, with arrival offset, tenant/priority, lengths, sampling
  params, conversation id and the journey id.
* ``GET /debug/window`` — ``Gateway.window_stats()`` as JSON (the
  autoscaler feed: windowed TTFT/queue-wait/per-token percentiles,
  shed rate, phase shares).
* ``GET /debug/fleet`` — ``Gateway.fleet_stats()`` as JSON: per-replica
  alive/draining/restarting state and, with an
  :class:`~paddle_tpu_torch.serving.autoscaler.Autoscaler` attached, the
  fleet bounds, desired count, in-flight scale op, cold-build EWMA and
  recent scale events (``rollout``: a
  :class:`~paddle_tpu_torch.serving.rollout.RolloutController`'s block).
* ``GET /debug/perf`` — the perfscope roofline table as JSON: per
  program, dispatch/sample counts, sampled device time (CUDA events),
  MFU and memory-bandwidth fractions.
* ``GET /debug/memory`` — the device memory ledger as JSON: per-owner
  device bytes, the allocator's ``bytes_in_use``
  (``torch.cuda.memory_allocated``), and the unattributed remainder.
* ``GET /debug/slo`` — the SLO engine's objectives, alert states,
  firing set and transition tail; ``GET /debug/incidents[/<id>]`` — its
  incident ring, or one bundle (404 ``no_slo_engine`` without an SLO
  engine, ``incident_not_found`` for an id the ring no longer holds).

Every completion handler mints a request **journey** — adopting the
client's ``X-Request-Id`` header when present — threads it through
admission, dispatch and the engine, echoes the id back as an
``X-Request-Id`` response header (and in the SSE finish event), and
finishes the journey when the response is fully on the wire, so the
timeline partitions the client-observed wall time.

One OS thread per in-flight HTTP request (``ThreadingHTTPServer``): the
handler parses and admits, then *blocks* on the gateway item while the
single dispatcher thread feeds the engines — request concurrency is
already bounded by the admission layer's queue + concurrency caps, so the
thread count is too.  The engine's stream callback only enqueues; the
handler thread writes the socket.

429 responses (queue caps and SLO sheds) carry a ``Retry-After`` header
and the OpenAI error envelope with a machine-readable ``code``.
"""
from __future__ import annotations

import json
import signal
import threading
import time
from concurrent.futures import CancelledError
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from queue import Empty

from ...observability import flight, registry
from ...observability import journey as journey_mod
from ...observability import perfscope
from ..engine import (DeadlineExceededError, EngineClosedError,
                      EngineDeadError, RequestInterruptedError)
from .admission import AdmissionError
from .gateway import Gateway, GatewayClosedError
from .protocol import (SSE_DONE, ProtocolError, chat_chunk_body,
                       chat_completion_body, chunk_body, completion_body,
                       error_body, parse_chat_request,
                       parse_completion_request, sse_event,
                       tenant_from_headers)
from .router import NoEngineAvailableError

__all__ = ["GatewayHTTPServer", "start_gateway", "GatewayStack"]

GATEWAY_HTTP = "paddle_tpu_gateway_http_responses_total"

_JSON = "application/json"
# streamed responses poll the token queue at this period so an engine-side
# failure/deadline mid-stream is noticed promptly
_STREAM_POLL_S = 0.05


class GatewayHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer bound to a Gateway instance."""

    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, address, gateway: Gateway,
                 request_timeout_s: float = 600.0):
        self.gateway = gateway
        self.request_timeout_s = float(request_timeout_s)
        super().__init__(address, _Handler)

    @property
    def port(self) -> int:
        return self.server_address[1]


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "paddle-tpu-gateway/1.0"

    # requests land in the metrics/flight layers; stderr stays quiet
    def log_message(self, format, *args):  # noqa: A002
        pass

    @property
    def gateway(self) -> Gateway:
        return self.server.gateway

    # -- plumbing ------------------------------------------------------------
    def _send_json(self, status: int, payload: dict, headers=()):
        body = json.dumps(payload).encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", _JSON)
        self.send_header("Content-Length", str(len(body)))
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)
        registry().counter(GATEWAY_HTTP, "gateway HTTP responses by code"
                           ).inc(1.0, labels={"code": status})

    @staticmethod
    def _error_wire(err: Exception):
        """(status, body, extra_headers, outcome-code) for one mapped
        error — the journey finishes with the same code the wire
        carries."""
        if isinstance(err, ProtocolError):
            return err.status, err.body(), [], (err.code or "protocol")
        if isinstance(err, AdmissionError):
            body = error_body(str(err), etype="rate_limit_exceeded",
                              code=err.reason)
            if err.est_ttft_s is not None:
                body["error"]["est_ttft_ms"] = round(err.est_ttft_s * 1e3, 1)
            return err.status, body, [
                ("Retry-After", str(max(1, round(err.retry_after_s))))], \
                err.reason
        if isinstance(err, DeadlineExceededError):
            return 504, error_body(str(err), etype="timeout_error",
                                   code="deadline_exceeded"), [], \
                "deadline_exceeded"
        if isinstance(err, RequestInterruptedError):
            # the engine died mid-generation and the retry budget could
            # not absorb it; tokens may have been produced, none are
            # delivered — the client decides whether to re-send
            return 503, error_body(str(err), etype="server_error",
                                   code="interrupted"), [], "interrupted"
        if isinstance(err, (NoEngineAvailableError, GatewayClosedError,
                            EngineClosedError, EngineDeadError)):
            return 503, error_body(str(err), etype="server_error",
                                   code="unavailable"), [], "unavailable"
        if isinstance(err, CancelledError):
            return 500, error_body("request was cancelled",
                                   etype="server_error",
                                   code="cancelled"), [], "cancelled"
        if isinstance(err, TimeoutError):
            return 504, error_body(str(err), etype="timeout_error",
                                   code="timeout"), [], "timeout"
        return 500, error_body(f"{type(err).__name__}: {err}",
                               etype="server_error",
                               code="internal"), [], "internal"

    def _send_error_obj(self, err: Exception, request_id: str | None = None):
        status, body, headers, _ = self._error_wire(err)
        if request_id:
            headers = list(headers) + [("X-Request-Id", request_id)]
        self._send_json(status, body, headers=headers)

    # -- GET -----------------------------------------------------------------
    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        try:
            path, _, query = self.path.partition("?")
            if path == "/healthz":
                health = self.gateway.healthz()
                self._send_json(200 if health["alive"] else 503, health)
            elif path == "/metrics":
                # a scrape also refreshes the windowed-feed gauges so
                # paddle_tpu_gateway_window_* export current values, and
                # the allocator's device-memory gauges
                try:
                    self.gateway.window_stats()
                except Exception:  # noqa: BLE001 — never break a scrape
                    pass
                try:
                    perfscope.record_memory_stats()
                except Exception:  # noqa: BLE001 — never break a scrape
                    pass
                text = registry().to_prometheus_text().encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(text)))
                self.end_headers()
                self.wfile.write(text)
                registry().counter(
                    GATEWAY_HTTP, "gateway HTTP responses by code").inc(
                    1.0, labels={"code": 200})
            elif path == "/debug/window":
                self._send_json(200, self.gateway.window_stats())
            elif path == "/debug/fleet":
                self._send_json(200, self.gateway.fleet_stats())
            elif path == "/debug/perf":
                self._send_json(200, perfscope.perf_report())
            elif path == "/debug/memory":
                self._send_json(200, perfscope.memory_report())
            elif path == "/debug/slo":
                slo = self.gateway.slo_engine
                if slo is None:
                    self._send_json(404, error_body(
                        "no SLO engine attached to this gateway",
                        code="no_slo_engine"))
                else:
                    self._send_json(200, slo.debug_state())
            elif path == "/debug/incidents" or \
                    path.startswith("/debug/incidents/"):
                slo = self.gateway.slo_engine
                if slo is None:
                    self._send_json(404, error_body(
                        "no SLO engine attached to this gateway",
                        code="no_slo_engine"))
                elif path == "/debug/incidents":
                    self._send_json(200, {
                        "incidents": slo.store.list()})
                else:
                    inc_id = path[len("/debug/incidents/"):]
                    bundle = slo.store.get(inc_id)
                    if bundle is None:
                        self._send_json(404, error_body(
                            f"no incident {inc_id!r} (ring holds "
                            f"{len(slo.store.list())})",
                            code="incident_not_found"))
                    else:
                        self._send_json(200, bundle)
            elif path == "/debug/capture":
                last = 64
                tenant = outcome = conversation = None
                for part in query.split("&"):
                    if part.startswith("last="):
                        try:
                            last = max(0, int(part[5:]))
                        except ValueError:
                            pass
                    elif part.startswith("tenant="):
                        tenant = part[7:]
                    elif part.startswith("outcome="):
                        outcome = part[8:]
                    elif part.startswith("conversation="):
                        conversation = part[13:]
                self._send_json(200, self.gateway.capture.debug_state(
                    last=last, tenant=tenant, outcome=outcome,
                    conversation=conversation))
            elif path == "/debug/requests":
                last = 32
                tenant = outcome = None
                for part in query.split("&"):
                    if part.startswith("last="):
                        try:
                            last = max(0, int(part[5:]))
                        except ValueError:
                            pass
                    elif part.startswith("tenant="):
                        tenant = part[7:]
                    elif part.startswith("outcome="):
                        outcome = part[8:]
                if tenant is None and outcome is None:
                    requests = journey_mod.recent(last)
                else:
                    # filter over the WHOLE ring, then tail: on a busy
                    # multi-tenant ring the newest N unfiltered entries
                    # may hold none of the tenant you're hunting
                    requests = [
                        j for j in journey_mod.recent(10 ** 9)
                        if (tenant is None
                            or j.attrs.get("tenant") == tenant)
                        and (outcome is None or j.outcome == outcome)
                    ][-last:] if last else []
                self._send_json(200, {
                    "requests": [j.timeline() for j in requests],
                    "active": [j.id for j in journey_mod.active()],
                })
            elif path.startswith("/debug/requests/"):
                jid = path[len("/debug/requests/"):]
                j = journey_mod.get(jid)
                if j is None:
                    self._send_json(404, error_body(
                        f"no journey {jid!r} (ring holds the newest "
                        f"{len(journey_mod.recent(10 ** 9))})",
                        code="journey_not_found"))
                else:
                    self._send_json(200, j.timeline())
            else:
                self._send_json(404, error_body(
                    f"no such endpoint: {self.path}", code="not_found"))
        except (BrokenPipeError, ConnectionResetError):
            pass

    # -- POST ----------------------------------------------------------------
    def do_POST(self):  # noqa: N802
        try:
            if self.path not in ("/v1/completions", "/v1/chat/completions"):
                self._send_json(404, error_body(
                    f"no such endpoint: {self.path}", code="not_found"))
                return
            parse = (parse_chat_request
                     if self.path == "/v1/chat/completions"
                     else parse_completion_request)
            gw = self.gateway
            # journey start == client-observed request start; the id is
            # adopted from the client's X-Request-Id when present and
            # echoed back on every response (header + SSE finish event)
            j = journey_mod.adopt_or_begin(
                self.headers.get("X-Request-Id"))
            try:
                try:
                    tenant = tenant_from_headers(self.headers, gw.api_keys)
                    length = int(self.headers.get("Content-Length") or 0)
                    raw = self.rfile.read(length)
                    creq = parse(
                        raw, has_tokenizer=gw.tokenizer is not None)
                    j.phase("parse", j.t0, time.perf_counter() - j.t0,
                            body_bytes=len(raw))
                    item = gw.admit(creq, tenant, journey=j)
                except (ProtocolError, AdmissionError, GatewayClosedError,
                        NoEngineAvailableError) as e:
                    outcome = self._error_wire(e)[3]
                    self._send_error_obj(e, request_id=j.id)
                    j.finish(outcome)
                    return
                if creq.stream:
                    self._stream_completion(gw, item)
                else:
                    self._blocking_completion(gw, item)
            finally:
                # a torn socket (or an unexpected handler error) must
                # not leak a live journey in the active table
                if not j.done:
                    j.finish("aborted")
        except (BrokenPipeError, ConnectionResetError):
            pass

    def _model_name(self, creq) -> str:
        return creq.model or self.gateway.model_name

    def _body_for(self, item, text, token_ids, finish, prompt_tokens,
                  request_id=None) -> dict:
        """Final-response envelope: ``chat.completion`` for the chat
        door, ``text_completion`` otherwise."""
        creq = item.creq
        if getattr(creq, "chat", False):
            return chat_completion_body(
                item.id, self._model_name(creq), text, token_ids, finish,
                prompt_tokens, request_id=request_id,
                conversation=creq.conversation)
        return completion_body(
            item.id, self._model_name(creq), text, token_ids, finish,
            prompt_tokens, request_id=request_id)

    def _chunk_for(self, item, text, token_ids, finish,
                   request_id=None) -> dict:
        """One SSE delta: ``chat.completion.chunk`` or the completions
        chunk, matching the door the request came through."""
        creq = item.creq
        if getattr(creq, "chat", False):
            return chat_chunk_body(
                item.id, self._model_name(creq), text, token_ids, finish,
                request_id=request_id, conversation=creq.conversation)
        return chunk_body(item.id, self._model_name(creq), text,
                          token_ids, finish, request_id=request_id)

    def _text(self, tokens) -> str:
        tok = self.gateway.tokenizer
        if tok is None:
            return ""
        return tok.decode([int(t) for t in tokens])

    def _blocking_completion(self, gw: Gateway, item):
        j = item.journey
        try:
            tokens, finish = gw.result(
                item, timeout=self.server.request_timeout_s)
        except Exception as e:  # noqa: BLE001 — mapped to wire errors
            self._send_error_obj(e, request_id=j.id if j else None)
            if j is not None:
                gw.finish_journey(item, self._error_wire(e)[3])
            return
        t_r0 = time.perf_counter()
        body = self._body_for(
            item, self._text(tokens),
            [int(t) for t in tokens], finish, int(item.prompt.size),
            request_id=j.id if j else None)
        self._send_json(200, body, headers=[
            ("X-Paddle-Tpu-Engine", item.engine_name or "")]
            + ([("X-Request-Id", j.id)] if j else []))
        if j is not None:
            j.phase("respond", t_r0, time.perf_counter() - t_r0,
                    tokens=len(tokens))
            gw.finish_journey(item, "ok")

    # -- streaming -----------------------------------------------------------
    def _write_chunk(self, data: bytes):
        self.wfile.write(f"{len(data):x}\r\n".encode("ascii"))
        self.wfile.write(data)
        self.wfile.write(b"\r\n")

    def _end_chunks(self):
        self.wfile.write(b"0\r\n\r\n")

    def _stream_completion(self, gw: Gateway, item):
        j = item.journey
        # wait for dispatch (or early failure) before committing to 200 —
        # sheds and routing failures still map to clean HTTP errors
        if not item.ready.wait(self.server.request_timeout_s):
            e = TimeoutError(f"request {item.id} was not dispatched in time")
            self._send_error_obj(e, request_id=j.id if j else None)
            if j is not None:
                gw.finish_journey(item, "timeout")
            return
        if item.error is not None:
            self._send_error_obj(item.error,
                                 request_id=j.id if j else None)
            if j is not None:
                gw.finish_journey(item, self._error_wire(item.error)[3])
            return
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        self.send_header("X-Paddle-Tpu-Engine", item.engine_name or "")
        if j is not None:
            self.send_header("X-Request-Id", j.id)
        self.end_headers()
        registry().counter(GATEWAY_HTTP, "gateway HTTP responses by code"
                           ).inc(1.0, labels={"code": 200})
        sent = 0
        outcome = "ok"
        try:
            # final outcome comes from item.done_ev / item.final_error,
            # never the raw handle: a supervisor or the gateway reaper
            # may transparently replace the handle while re-dispatching
            # a zero-token engine death
            while True:
                try:
                    tok = item.token_q.get(timeout=_STREAM_POLL_S)
                except Empty:
                    if item.done_ev.is_set():
                        break
                    continue
                sent += 1
                self._write_chunk(sse_event(self._chunk_for(
                    item, self._text([tok]), [int(tok)], None)))
            t_done = time.perf_counter()
            # drain tokens that raced the done check
            while not item.token_q.empty():
                tok = item.token_q.get_nowait()
                sent += 1
                self._write_chunk(sse_event(self._chunk_for(
                    item, self._text([tok]), [int(tok)], None)))
            err = item.final_error
            if err is None:
                handle = item.handle
                eos = handle.eos_token_id
                toks = handle.tokens
                finish = ("stop" if eos is not None and toks and
                          toks[-1] == eos else "length")
                self._write_chunk(sse_event(self._chunk_for(
                    item, "", [], finish,
                    request_id=j.id if j else None)))
            else:
                outcome = ("stream_interrupted"
                           if isinstance(err, RequestInterruptedError)
                           else "stream_aborted")
                payload = {
                    "id": item.id,
                    "error": error_body(
                        f"{type(err).__name__}: {err}",
                        etype="server_error", code=outcome)["error"]}
                if j is not None:
                    payload["request_id"] = j.id
                self._write_chunk(sse_event(payload))
            self._write_chunk(SSE_DONE)
            self._end_chunks()
            if j is not None:
                # token writes overlap decode (already attributed); the
                # post-completion flush + finish frames are the stream's
                # own cost
                j.phase("stream", t_done, time.perf_counter() - t_done,
                        tokens_sent=sent)
        except (BrokenPipeError, ConnectionResetError):
            # client went away mid-stream: free the slot immediately
            outcome = "client_disconnect"
            item.handle.cancel()
        if j is not None:
            gw.finish_journey(item, outcome)


# -- convenience stack --------------------------------------------------------

class GatewayStack:
    """Gateway + HTTP server + serving thread, torn down in order.

    Graceful shutdown (the serving analogue of
    ``framework/preemption.py``): :meth:`install_sigterm_drain` converts
    SIGTERM into shed-new-traffic-with-``Retry-After`` -> drain -> clean
    exit — the signal handler only sets an Event; a waiter thread runs
    the actual drain (flight events, locks and socket teardown are not
    async-signal-safe)."""

    def __init__(self, gateway: Gateway, server: GatewayHTTPServer,
                 thread: threading.Thread, own_engines: bool = False):
        self.gateway = gateway
        self.server = server
        self.thread = thread
        self.own_engines = own_engines
        self.slo_engine = None          # set by start_gateway(slo_*)
        self._lock = threading.Lock()
        self._sigterm_ev = threading.Event()
        self._terminated_ev = threading.Event()
        self._drain_deadline_s = 30.0
        self._drain_result: bool | None = None
        self._waiter: threading.Thread | None = None
        self._prev_sigterm = None

    @property
    def port(self) -> int:
        return self.server.port

    @property
    def address(self) -> str:
        host, port = self.server.server_address[:2]
        return f"http://{host}:{port}"

    def drain(self, deadline_s: float = 30.0) -> bool:
        """Graceful teardown: the HTTP listener keeps answering (new
        completions get 429 + ``Retry-After``) while the gateway runs its
        queued and in-flight work dry, then the owned engines drain their
        decode work, then everything closes.  Returns True when nothing
        was dropped."""
        t0 = time.perf_counter()
        ok = self.gateway.drain(deadline_s)
        if self.own_engines:
            for eng in self.gateway.router.engines:
                remaining = max(
                    0.5, deadline_s - (time.perf_counter() - t0))
                ok = eng.drain(remaining) and ok
        self.close()
        return ok

    def install_sigterm_drain(self, deadline_s: float = 30.0):
        """Arm the SIGTERM -> drain -> clean-exit path.  Call from the
        main thread (signal installation is impossible elsewhere)."""
        with self._lock:
            self._drain_deadline_s = float(deadline_s)
        ev = self._sigterm_ev

        def _handler(sig, frame):
            # async-signal-safe by construction: ONLY flips the Event;
            # the waiter thread does the lock/IO-heavy drain
            ev.set()

        prev = signal.getsignal(signal.SIGTERM)
        signal.signal(signal.SIGTERM, _handler)
        with self._lock:
            self._prev_sigterm = prev
        self._waiter = threading.Thread(
            target=self._drain_on_signal, daemon=True,
            name="paddle-tpu-gateway-drain")
        self._waiter.start()

    def _drain_on_signal(self):
        self._sigterm_ev.wait()
        if self._terminated_ev.is_set():
            return                    # already closed normally
        with self._lock:
            deadline_s = self._drain_deadline_s
        flight.record("gateway", "sigterm_drain", deadline_s=deadline_s)
        ok = self.drain(deadline_s)
        with self._lock:
            self._drain_result = ok

    @property
    def drain_result(self) -> bool | None:
        """Outcome of the signal-triggered drain (None before one ran)."""
        with self._lock:
            return self._drain_result

    def wait_terminated(self, timeout: float | None = None) -> bool:
        """Block until the stack is fully closed (normal close() or the
        SIGTERM drain path)."""
        return self._terminated_ev.wait(timeout)

    def close(self):
        """Stop accepting, fail queued work, (optionally) stop engines."""
        # the SLO evaluator thread polls gateway window state: stop it
        # FIRST so no tick races the teardown below
        if self.slo_engine is not None:
            self.slo_engine.shutdown()
        self.server.shutdown()
        self.server.server_close()
        self.gateway.shutdown()
        if self.own_engines:
            for eng in self.gateway.router.engines:
                eng.shutdown()
        self.thread.join(timeout=10)
        with self._lock:
            prev, self._prev_sigterm = self._prev_sigterm, None
        if prev is not None:
            try:
                signal.signal(signal.SIGTERM, prev)
            except (ValueError, OSError):   # not the main thread
                pass
        self._terminated_ev.set()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def start_gateway(engines, host: str = "127.0.0.1", port: int = 0, *,
                  own_engines: bool = False, request_timeout_s: float = 600.0,
                  slo_objectives=None, slo_tick_s: float = 1.0,
                  slo_incident_dir: str | None = None,
                  slo_max_incidents: int = 32,
                  **gateway_kwargs) -> GatewayStack:
    """Boot the full front door: Gateway core + threaded HTTP server on
    ``host:port`` (port 0 = ephemeral; read ``stack.port``).  Extra
    keyword args go to :class:`Gateway`.

    ``slo_objectives`` (a list of :class:`~paddle_tpu_torch.observability.
    slo.SloObjective`) attaches an :class:`~paddle_tpu_torch.observability.
    slo.SloEngine` evaluating them every ``slo_tick_s`` — burn-rate alerts
    on ``/debug/slo``, incident bundles (ring-bounded at
    ``slo_max_incidents`` under ``slo_incident_dir``) on
    ``/debug/incidents``.

    Traffic capture rides the passthrough: ``capture_mode=``
    (``shape``/``full``), ``capture_entries=`` and
    ``capture_spill_dir=`` build a gateway-local
    :class:`~paddle_tpu_torch.observability.capture.TrafficCapture` (or
    pass ``capture=`` an instance); with none set the gateway records
    into the process default.  Either way ``GET /debug/capture`` serves
    the ring and incident bundles gain the ``capture_tail`` section."""
    gateway = (engines if isinstance(engines, Gateway)
               else Gateway(engines, **gateway_kwargs))
    server = GatewayHTTPServer((host, port), gateway,
                               request_timeout_s=request_timeout_s)
    thread = threading.Thread(target=server.serve_forever,
                              name="paddle-tpu-gateway-http", daemon=True)
    thread.start()
    stack = GatewayStack(gateway, server, thread, own_engines=own_engines)
    if slo_objectives:
        from ...observability.slo import SloEngine
        stack.slo_engine = SloEngine(
            gateway, slo_objectives, tick_s=slo_tick_s,
            incident_dir=slo_incident_dir,
            max_incidents=slo_max_incidents)
    return stack
