"""Wire protocol — OpenAI-compatible completions parsing and framing.

The port's copy of ``paddle_tpu/serving/gateway/protocol.py``: the same
bodies give the same parsed fields, or the same ``ProtocolError`` text
and status.  Pure functions over bytes/dicts: no engine, no threads, no
device.  The HTTP layer (http.py) calls :func:`parse_completion_request`
on the raw body and maps :class:`ProtocolError` to a structured 4xx; the
response functions emit the OpenAI completions JSON shape so stock clients
(``openai.Completion``-era, ``curl`` recipes, load generators) speak to
the gateway unchanged.

Extensions beyond the OpenAI schema (all optional, ignored by stock
clients): ``top_k`` (the engine's sampler knob), ``seed`` (per-request
sampling seed), ``deadline_ms`` (end-to-end SLO — the shed layer rejects
early when the TTFT estimate blows it), ``priority``
(``interactive | standard | batch``), and integer ``stop`` (an eos token
id; the engine is tokenizer-optional so string stop sequences are only
accepted when a tokenizer is attached).
"""
from __future__ import annotations

import json
import time

__all__ = ["ProtocolError", "CompletionRequest", "PRIORITIES",
           "parse_completion_request", "parse_chat_request",
           "tenant_from_headers",
           "completion_body", "chunk_body", "chat_completion_body",
           "chat_chunk_body", "sse_event", "SSE_DONE",
           "error_body"]

# priority classes, strictly ordered: a lower value preempts a higher one
# in the fair-share scheduler (admission.py)
PRIORITIES = {"interactive": 0, "standard": 1, "batch": 2}

_MAX_BODY_BYTES = 1 << 20          # 1 MiB request-body cap (413 beyond)


class ProtocolError(Exception):
    """A request the wire layer rejects — carries the HTTP status and the
    OpenAI-style error object fields."""

    def __init__(self, status: int, message: str, *, code: str | None = None,
                 etype: str = "invalid_request_error",
                 param: str | None = None):
        super().__init__(message)
        self.status = int(status)
        self.code = code
        self.etype = etype
        self.param = param

    def body(self) -> dict:
        return error_body(str(self), etype=self.etype, code=self.code,
                          param=self.param)


def error_body(message: str, *, etype: str = "invalid_request_error",
               code: str | None = None, param: str | None = None) -> dict:
    """The OpenAI error envelope: ``{"error": {...}}``."""
    return {"error": {"message": message, "type": etype,
                      "param": param, "code": code}}


class CompletionRequest:
    """Validated /v1/completions payload (wire form; the gateway resolves
    string prompts to ids with the engine's tokenizer)."""

    __slots__ = ("prompt", "max_tokens", "temperature", "top_k", "seed",
                 "stream", "stop", "deadline_s", "priority", "model",
                 "conversation", "chat")

    def __init__(self, prompt, max_tokens, temperature, top_k, seed,
                 stream, stop, deadline_s, priority, model,
                 conversation=None, chat=False):
        self.prompt = prompt              # str | list[int]
        self.max_tokens = max_tokens
        self.temperature = temperature
        self.top_k = top_k
        self.seed = seed
        self.stream = stream
        self.stop = stop                  # int eos id | str | None
        self.deadline_s = deadline_s
        self.priority = priority          # key of PRIORITIES | None
        self.model = model
        self.conversation = conversation  # prefix-cache namespace id
        self.chat = chat                  # respond in chat.completion shape


def _field(payload: dict, name: str, types, default, *, validate=None):
    v = payload.get(name, default)
    if v is default:
        return default
    if not isinstance(v, types) or isinstance(v, bool) and bool not in (
            types if isinstance(types, tuple) else (types,)):
        raise ProtocolError(
            400, f"'{name}' must be of type "
            f"{getattr(types, '__name__', types)}", param=name,
            code="invalid_type")
    if validate is not None and not validate(v):
        raise ProtocolError(400, f"'{name}' is out of range", param=name,
                            code="out_of_range")
    return v


def parse_completion_request(raw: bytes, *, has_tokenizer: bool
                             ) -> CompletionRequest:
    """bytes -> validated CompletionRequest; raises ProtocolError (400/413)
    on anything malformed.  Unknown fields are ignored (OpenAI-tolerant)."""
    if len(raw) > _MAX_BODY_BYTES:
        raise ProtocolError(413, "request body exceeds 1 MiB",
                            code="body_too_large")
    try:
        payload = json.loads(raw.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ProtocolError(400, f"request body is not valid JSON: {e}",
                            code="invalid_json") from e
    if not isinstance(payload, dict):
        raise ProtocolError(400, "request body must be a JSON object",
                            code="invalid_json")

    prompt = payload.get("prompt")
    if prompt is None:
        raise ProtocolError(400, "'prompt' is required", param="prompt",
                            code="missing_field")
    if isinstance(prompt, str):
        if not has_tokenizer:
            raise ProtocolError(
                400, "string prompts need a tokenizer on the serving side; "
                "send a list of token ids", param="prompt",
                code="no_tokenizer")
        if not prompt:
            raise ProtocolError(400, "'prompt' is empty", param="prompt",
                                code="empty_prompt")
    elif isinstance(prompt, list):
        if not prompt or not all(
                isinstance(t, int) and not isinstance(t, bool) and t >= 0
                for t in prompt):
            raise ProtocolError(
                400, "'prompt' must be a non-empty list of non-negative "
                "token ids (or a string, with a tokenizer)",
                param="prompt", code="invalid_prompt")
    else:
        raise ProtocolError(400, "'prompt' must be a string or a list of "
                            "token ids", param="prompt", code="invalid_type")

    max_tokens = _field(payload, "max_tokens", int, 16,
                        validate=lambda v: 1 <= v <= 1 << 20)
    temperature = _field(payload, "temperature", (int, float), 0.0,
                         validate=lambda v: v >= 0)
    top_k = _field(payload, "top_k", int, 0, validate=lambda v: v >= 0)
    seed = _field(payload, "seed", int, 0)
    stream = _field(payload, "stream", bool, False)
    model = _field(payload, "model", str, None)

    stop = payload.get("stop")
    if stop is not None:
        if isinstance(stop, list) and len(stop) == 1:
            stop = stop[0]
        if isinstance(stop, bool) or not isinstance(stop, (int, str)):
            raise ProtocolError(
                400, "'stop' must be a token id (int) or, with a "
                "tokenizer, a string", param="stop", code="invalid_type")
        if isinstance(stop, str) and not has_tokenizer:
            raise ProtocolError(
                400, "string 'stop' needs a tokenizer on the serving side",
                param="stop", code="no_tokenizer")

    deadline_ms = _field(payload, "deadline_ms", (int, float), None,
                         validate=lambda v: v > 0)
    priority = payload.get("priority")
    if priority is not None and priority not in PRIORITIES:
        raise ProtocolError(
            400, f"'priority' must be one of {sorted(PRIORITIES)}",
            param="priority", code="invalid_priority")
    conversation = _field(payload, "conversation", str, None,
                          validate=lambda v: 0 < len(v) <= 256)

    return CompletionRequest(
        prompt=prompt, max_tokens=int(max_tokens),
        temperature=float(temperature), top_k=int(top_k), seed=int(seed),
        stream=bool(stream), stop=stop,
        deadline_s=None if deadline_ms is None else float(deadline_ms) / 1e3,
        priority=priority, model=model, conversation=conversation)


def parse_chat_request(raw: bytes, *, has_tokenizer: bool
                       ) -> CompletionRequest:
    """bytes -> validated /v1/chat/completions request.

    The chat surface is the conversation-first door: ``messages``
    flatten to one prompt and an
    optional ``conversation`` id namespaces the prefix cache so turn
    N+1 of the same conversation re-uses turn N's KV.  Flattening is
    deliberately trivial — role header + content per message — because
    the engine is tokenizer-optional: string contents need a tokenizer
    (they flatten to one string), while integer-list contents
    concatenate tokenizer-free (the load generator / capture-replay
    form).  Mixing the two in one request is a 400.  Everything else
    (sampling, deadline, priority, stream) parses exactly like
    /v1/completions; the returned request carries ``chat=True`` so the
    HTTP layer frames responses as ``chat.completion[.chunk]``.
    """
    if len(raw) > _MAX_BODY_BYTES:
        raise ProtocolError(413, "request body exceeds 1 MiB",
                            code="body_too_large")
    try:
        payload = json.loads(raw.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ProtocolError(400, f"request body is not valid JSON: {e}",
                            code="invalid_json") from e
    if not isinstance(payload, dict):
        raise ProtocolError(400, "request body must be a JSON object",
                            code="invalid_json")
    msgs = payload.get("messages")
    if not isinstance(msgs, list) or not msgs:
        raise ProtocolError(400, "'messages' must be a non-empty list",
                            param="messages", code="missing_field")
    parts, kinds = [], set()
    for i, m in enumerate(msgs):
        if not isinstance(m, dict) or not isinstance(m.get("role"), str) \
                or not m["role"]:
            raise ProtocolError(
                400, f"messages[{i}] needs a string 'role'",
                param="messages", code="invalid_message")
        content = m.get("content")
        if isinstance(content, str) and content:
            kinds.add("str")
            parts.append((m["role"], content))
        elif (isinstance(content, list) and content and all(
                isinstance(t, int) and not isinstance(t, bool) and t >= 0
                for t in content)):
            kinds.add("ids")
            parts.append((m["role"], content))
        else:
            raise ProtocolError(
                400, f"messages[{i}].content must be a non-empty string "
                "or a non-empty list of non-negative token ids",
                param="messages", code="invalid_message")
    if len(kinds) > 1:
        raise ProtocolError(
            400, "messages must be all-string or all-token-ids, not "
            "mixed", param="messages", code="invalid_message")
    if "str" in kinds:
        if not has_tokenizer:
            raise ProtocolError(
                400, "string message contents need a tokenizer on the "
                "serving side; send token-id lists", param="messages",
                code="no_tokenizer")
        # deterministic flattening: identical histories produce the
        # IDENTICAL prompt string, byte for byte — that equality is what
        # the prefix cache keys on, so format drift = cache miss
        prompt = "".join(f"<|{role}|>{content}\n"
                         for role, content in parts) + "<|assistant|>"
    else:
        prompt = [t for _, content in parts for t in content]

    body = dict(payload)
    body["prompt"] = prompt
    body.pop("messages", None)
    creq = parse_completion_request(
        json.dumps(body).encode("utf-8"), has_tokenizer=has_tokenizer)
    creq.chat = True
    return creq


def tenant_from_headers(headers, api_keys: dict | None = None) -> str:
    """Resolve the tenant identity for one request.

    With an ``api_keys`` map ({key: tenant}) the gateway is in strict
    mode: an unknown/missing key is a 401.  Without one, the bearer
    token / ``X-Api-Key`` / ``X-Tenant`` header names the tenant directly
    (first match wins) and unauthenticated requests fall into the
    ``anonymous`` tenant — every tenant still gets its own fair-share
    queue either way.
    """
    auth = headers.get("Authorization") or ""
    key = auth[7:].strip() if auth.startswith("Bearer ") else \
        (headers.get("X-Api-Key") or "").strip()
    if api_keys is not None:
        tenant = api_keys.get(key)
        if not key or tenant is None:
            raise ProtocolError(
                401, "missing or unknown API key",
                etype="authentication_error", code="invalid_api_key")
        return tenant
    return (headers.get("X-Tenant") or "").strip() or key or "anonymous"


# -- response bodies -----------------------------------------------------------

def _choice(text: str, token_ids, finish_reason):
    return {"text": text, "index": 0, "logprobs": None,
            "finish_reason": finish_reason, "token_ids": list(token_ids)}


def completion_body(req_id: str, model: str, text: str, token_ids,
                    finish_reason: str, prompt_tokens: int,
                    request_id: str | None = None) -> dict:
    """``request_id`` is the journey id (adopted ``X-Request-Id``) —
    echoed in the body next to the response header so log pipelines can
    correlate without header access."""
    n = len(token_ids)
    out = {
        "id": req_id, "object": "text_completion",
        "created": int(time.time()), "model": model,
        "choices": [_choice(text, token_ids, finish_reason)],
        "usage": {"prompt_tokens": int(prompt_tokens),
                  "completion_tokens": n,
                  "total_tokens": int(prompt_tokens) + n},
    }
    if request_id is not None:
        out["request_id"] = request_id
    return out


def chunk_body(req_id: str, model: str, text: str, token_ids,
               finish_reason: str | None,
               request_id: str | None = None) -> dict:
    """One streamed delta (an SSE ``data:`` payload).  The finish event
    (``finish_reason`` set) carries ``request_id`` — the journey id a
    client quotes at ``GET /debug/requests/<id>``."""
    out = {"id": req_id, "object": "text_completion",
           "created": int(time.time()), "model": model,
           "choices": [_choice(text, token_ids, finish_reason)]}
    if request_id is not None:
        out["request_id"] = request_id
    return out


def chat_completion_body(req_id: str, model: str, text: str, token_ids,
                         finish_reason: str, prompt_tokens: int,
                         request_id: str | None = None,
                         conversation: str | None = None) -> dict:
    """The ``chat.completion`` envelope: the completion payload framed
    as one assistant message.  ``conversation`` is echoed so a client
    can confirm which prefix-cache namespace served it."""
    n = len(token_ids)
    out = {
        "id": req_id, "object": "chat.completion",
        "created": int(time.time()), "model": model,
        "choices": [{"index": 0, "logprobs": None,
                     "finish_reason": finish_reason,
                     "message": {"role": "assistant", "content": text,
                                 "token_ids": list(token_ids)}}],
        "usage": {"prompt_tokens": int(prompt_tokens),
                  "completion_tokens": n,
                  "total_tokens": int(prompt_tokens) + n},
    }
    if request_id is not None:
        out["request_id"] = request_id
    if conversation is not None:
        out["conversation"] = conversation
    return out


def chat_chunk_body(req_id: str, model: str, text: str, token_ids,
                    finish_reason: str | None,
                    request_id: str | None = None,
                    conversation: str | None = None) -> dict:
    """One streamed ``chat.completion.chunk`` delta."""
    out = {"id": req_id, "object": "chat.completion.chunk",
           "created": int(time.time()), "model": model,
           "choices": [{"index": 0, "finish_reason": finish_reason,
                        "delta": ({"role": "assistant", "content": text,
                                   "token_ids": list(token_ids)}
                                  if finish_reason is None or token_ids
                                  else {})}]}
    if request_id is not None:
        out["request_id"] = request_id
    if conversation is not None:
        out["conversation"] = conversation
    return out


def sse_event(payload: dict) -> bytes:
    return b"data: " + json.dumps(payload).encode("utf-8") + b"\n\n"


SSE_DONE = b"data: [DONE]\n\n"
