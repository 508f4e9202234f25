"""OpenAI chat-completions wire schema and SSE framing, stdlib-only.

The front-end speaks the `/v1/chat/completions` request/response shape any
OpenAI SDK emits; routing metadata the schema has no slot for (which pool
member served, the judged utility, the billed cost share, cache/batch state)
rides in a ``robatch`` extension object on every response.

Query resolution maps a chat message onto the workload the gateway was fitted
on.  The serving plane routes by *workload index* (the router embedding, cost
columns and calibrations are all indexed), so free-text ingress must land on
an index; the ladder, first match wins:

1. an explicit integer ``query_idx`` field in the request body,
2. exact text match against the pool's :class:`repro_torch.serving.pool.TextTask`
   queries (real engine pools),
3. ``#N`` / ``qN`` in the message content — an explicit index reference,
4. a stable content hash onto the serving universe — arbitrary curl text
   exercises the full plane deterministically.

SSE framing follows the OpenAI streaming contract: ``data: {chunk}\\n\\n``
frames with ``object: chat.completion.chunk``, a first frame carrying the
assistant role, one frame per content delta, a terminal frame with
``finish_reason``, then the literal ``data: [DONE]`` sentinel.
"""
from __future__ import annotations

import json
import re
import zlib
from typing import Optional

__all__ = ["ApiError", "parse_chat_body", "resolve_query_idx",
           "completion_response", "chunk_frame", "role_frame", "finish_frame",
           "sse_event", "SSE_DONE", "models_response", "usage_for"]

SSE_DONE = b"data: [DONE]\n\n"

_IDX_RE = re.compile(r"^\s*(?:#|q)?(\d+)\s*$", re.IGNORECASE)


class ApiError(Exception):
    """Maps to an OpenAI-style error envelope with an HTTP status."""

    def __init__(self, status: int, message: str, err_type: str = "invalid_request_error"):
        super().__init__(message)
        self.status = status
        self.err_type = err_type

    def body(self) -> dict:
        return {"error": {"message": str(self), "type": self.err_type,
                          "code": self.status}}


# OpenAI chat-completions fields this plane cannot honor: the batch-prompt
# engine produces exactly one choice per query and exposes no token-level
# logprobs, and penalty/bias knobs have no analogue in the fused sampler.
# Sending one is a structured 400, not a silent ignore (docs/architecture.md
# documents the supported subset).
_UNSUPPORTED_FIELDS = ("logprobs", "top_logprobs", "logit_bias", "tools",
                      "tool_choice", "functions", "function_call", "stop",
                      "presence_penalty", "frequency_penalty")


def _number(body: dict, key: str, lo: float, hi: float, default):
    v = body.get(key)
    if v is None:
        return default
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise ApiError(400, f"'{key}' must be a number")
    if not lo <= float(v) <= hi:
        raise ApiError(400, f"'{key}' must be in [{lo}, {hi}], got {v}")
    return float(v)


def parse_chat_body(raw: bytes) -> dict:
    """Decode and structurally validate a chat-completions request body;
    returns ``{"content", "stream", "model", "query_idx", "gen"}`` where
    ``gen`` is a :class:`repro_torch.serving.generation.GenerationConfig` when the
    request carries any sampling field (``temperature``/``top_p``/``seed``/
    ``max_tokens``) and ``None`` otherwise (server-default generation).
    Unsupported OpenAI fields are rejected with a structured 400."""
    try:
        body = json.loads(raw.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ApiError(400, f"request body is not valid JSON: {e}")
    if not isinstance(body, dict):
        raise ApiError(400, "request body must be a JSON object")
    for key in _UNSUPPORTED_FIELDS:
        if body.get(key) is not None:
            raise ApiError(400, f"'{key}' is not supported by this server; "
                                "see docs/architecture.md for the supported "
                                "request subset", "unsupported_field_error")
    n = body.get("n")
    if n is not None and n != 1:
        raise ApiError(400, "'n' must be 1: the batch-prompt plane returns "
                            "exactly one choice per query",
                       "unsupported_field_error")
    messages = body.get("messages")
    if not isinstance(messages, list) or not messages:
        raise ApiError(400, "'messages' must be a non-empty array")
    content: Optional[str] = None
    for msg in reversed(messages):
        if isinstance(msg, dict) and msg.get("role") == "user":
            content = msg.get("content")
            break
    if not isinstance(content, str) or not content:
        raise ApiError(400, "need at least one user message with string content")
    query_idx = body.get("query_idx")
    if query_idx is not None and not isinstance(query_idx, int):
        raise ApiError(400, "'query_idx' must be an integer when present")
    temperature = _number(body, "temperature", 0.0, 2.0, None)
    top_p = _number(body, "top_p", 0.0, 1.0, None)
    if top_p == 0.0:
        raise ApiError(400, "'top_p' must be > 0")
    seed = body.get("seed")
    if seed is not None and (isinstance(seed, bool) or not isinstance(seed, int)):
        raise ApiError(400, "'seed' must be an integer when present")
    max_tokens = body.get("max_tokens", body.get("max_completion_tokens"))
    if max_tokens is not None and (isinstance(max_tokens, bool)
                                   or not isinstance(max_tokens, int)
                                   or max_tokens < 1):
        raise ApiError(400, "'max_tokens' must be a positive integer")
    gen = None
    if any(v is not None for v in (temperature, top_p, seed, max_tokens)):
        from repro_torch.serving.generation import GenerationConfig

        gen = GenerationConfig(
            max_new=max_tokens if max_tokens is not None else 32,
            temperature=temperature if temperature is not None else 0.0,
            top_p=top_p if top_p is not None else 1.0,
            seed=seed if seed is not None else 0)
    return {"content": content, "stream": bool(body.get("stream", False)),
            "model": body.get("model"), "query_idx": query_idx, "gen": gen}


def resolve_query_idx(parsed: dict, universe, text_index: dict) -> int:
    """The resolution ladder above; ``universe`` is the serving index array,
    ``text_index`` maps exact TextTask query strings to workload indices."""
    n = len(universe)
    if n == 0:
        raise ApiError(503, "server has no serving universe", "server_error")
    if parsed["query_idx"] is not None:
        q = parsed["query_idx"]
        if not 0 <= q < n:
            raise ApiError(400, f"query_idx {q} outside the serving universe "
                                f"[0, {n})")
        return int(universe[q])
    content = parsed["content"]
    hit = text_index.get(content)
    if hit is None:
        hit = text_index.get(content.strip())
    if hit is not None:
        return int(hit)
    m = _IDX_RE.match(content)
    if m and int(m.group(1)) < n:
        return int(universe[int(m.group(1))])
    return int(universe[zlib.crc32(content.strip().encode("utf-8")) % n])


def usage_for(wl, query_idx: int) -> dict:
    """Token accounting from the workload's calibrated counts (the serving
    plane bills batch-amortized tokens; this is the per-query view)."""
    prompt = int(wl.sys_tokens + wl.in_tokens[query_idx])
    completion = int(wl.out_tokens[query_idx])
    return {"prompt_tokens": prompt, "completion_tokens": completion,
            "total_tokens": prompt + completion}


def _robatch_ext(req, model_name: Optional[str]) -> dict:
    return {"query_idx": req.query_idx, "model_idx": req.model,
            "model": model_name, "batch": req.batch,
            "utility": req.utility, "cost": req.cost,
            "cache_hit": req.cache_hit, "n_reroutes": req.n_reroutes,
            "latency_s": round(req.latency, 6)}


def completion_response(req, model_name: Optional[str], wl,
                        created: int = 0) -> dict:
    """Non-streamed ``chat.completion`` body for a completed OnlineRequest.

    ``id`` is deterministic in the request id and ``created`` defaults to 0:
    responses are bit-comparable across serving paths and runs (the parity
    guarantee the tests pin); a wall timestamp would be the only nondeterminism.
    """
    return {
        "id": f"chatcmpl-{req.rid}",
        "object": "chat.completion",
        "created": created,
        "model": model_name or "robatch",
        "choices": [{
            "index": 0,
            "message": {"role": "assistant", "content": req.content or ""},
            "finish_reason": "stop",
        }],
        "usage": usage_for(wl, req.query_idx),
        "robatch": _robatch_ext(req, model_name),
    }


def sse_event(payload: dict) -> bytes:
    return b"data: " + json.dumps(payload, separators=(",", ":")).encode() + b"\n\n"


def _chunk(req, model_name: Optional[str], delta: dict,
           finish_reason: Optional[str], created: int = 0) -> dict:
    return {
        "id": f"chatcmpl-{req.rid}",
        "object": "chat.completion.chunk",
        "created": created,
        "model": model_name or "robatch",
        "choices": [{"index": 0, "delta": delta,
                     "finish_reason": finish_reason}],
    }


def role_frame(req, model_name: Optional[str] = None) -> bytes:
    return sse_event(_chunk(req, model_name, {"role": "assistant"}, None))


def chunk_frame(req, delta_text: str, model_name: Optional[str] = None) -> bytes:
    return sse_event(_chunk(req, model_name, {"content": delta_text}, None))


def finish_frame(req, model_name: Optional[str], wl) -> bytes:
    body = _chunk(req, model_name, {}, "stop")
    body["usage"] = usage_for(wl, req.query_idx)
    body["robatch"] = _robatch_ext(req, model_name)
    return sse_event(body)


def models_response(pool) -> dict:
    """``GET /v1/models``: pool members with their per-token prices."""
    return {"object": "list", "data": [{
        "id": m.name, "object": "model", "owned_by": "robatch",
        "context_len": int(m.context_len),
        "pricing": {"input_per_1m_tokens": float(m.c_in),
                    "output_per_1m_tokens": float(m.c_out)},
        "replicas": int(getattr(m, "n_replicas", 1)),
    } for m in pool]}
