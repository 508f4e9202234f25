"""OpenAI-compatible HTTP front-end over the online serving plane.

Stdlib-only by design (``http.server.ThreadingHTTPServer`` — no FastAPI or
uvicorn, ``requirements-ci.txt`` stays lean).  One :class:`HttpFrontend`
fronts one :class:`repro_torch.serving.online.OnlineRobatchServer`:

* a **serving-loop thread** runs :meth:`~repro_torch.serving.online.
  OnlineRobatchServer.run_bridge` — one scheduling round per wall-clock
  window, requests arriving concurrently from handler threads;
* **handler threads** (one per connection) translate the wire protocol:
  ``POST /v1/chat/completions`` submits through the live ingress bridge
  (``submit_request``) and either blocks on the request's ``done_event``
  (non-streamed) or relays its :class:`~repro_torch.serving.online.StreamSink`
  events as SSE ``chat.completion.chunk`` frames (streamed — deltas arrive at
  the engine's ``decode_block`` cadence via the batch-prompt demultiplexer);
* ``GET /v1/models`` lists pool members with per-token prices,
  ``GET /healthz`` reports breaker state and replica availability, and
  ``GET /metrics`` renders the bound :class:`repro_torch.http.metrics.
  MetricsRegistry` in Prometheus text exposition format.

Streamed responses are sent with ``Connection: close`` framing (the client
reads until EOF), which every SSE consumer — curl, the OpenAI SDKs, browsers
— handles; non-streamed responses carry a normal ``Content-Length``.
"""
from __future__ import annotations

import json
import queue
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from repro_torch.http.metrics import MetricsRegistry, bind_server_metrics
from repro_torch.http.protocol import (SSE_DONE, ApiError, chunk_frame,
                                       completion_response, finish_frame,
                                       models_response, parse_chat_body,
                                       resolve_query_idx, role_frame, sse_event)
from repro_torch.serving.fault import CircuitState

__all__ = ["HttpFrontend"]


def _pool_text_index(pool) -> dict:
    """Exact query-text -> workload index map from any TextTask the pool's
    members (or their replicas) carry; simulated pools yield an empty map."""
    for member in pool:
        task = getattr(member, "task", None)
        if task is None:
            task = getattr(getattr(member, "replicas", [None])[0], "task", None)
        if task is not None and getattr(task, "queries", None) is not None:
            return {str(q): i for i, q in enumerate(task.queries)}
    return {}


class _HttpServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    frontend: "HttpFrontend"


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server: _HttpServer

    # ------------------------------------------------------------- plumbing
    def log_message(self, fmt, *args):   # noqa: A002 — stdlib signature
        if self.server.frontend.verbose:
            super().log_message(fmt, *args)

    def _observe(self, path: str, code: int) -> None:
        fe = self.server.frontend
        fe.n_http_requests += 1
        if fe._http_requests is not None:
            fe._http_requests.labels(path=path, code=str(code)).inc()

    def _send_json(self, code: int, payload: dict, path: str) -> None:
        body = json.dumps(payload, indent=1).encode() + b"\n"
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)
        self._observe(path, code)

    def _send_text(self, code: int, text: str, path: str,
                   content_type: str) -> None:
        body = text.encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)
        self._observe(path, code)

    # ------------------------------------------------------------ GET routes
    def do_GET(self):   # noqa: N802 — stdlib handler name
        fe = self.server.frontend
        path = self.path.split("?", 1)[0]
        try:
            if path == "/v1/models":
                self._send_json(200, models_response(fe.server.pool), path)
            elif path == "/healthz":
                self._send_json(200, fe.health(), path)
            elif path == "/metrics":
                self._send_text(200, fe.metrics.render(), path,
                                "text/plain; version=0.0.4; charset=utf-8")
            else:
                self._send_json(404, ApiError(404, f"no route {path}").body(),
                                path)
        except (BrokenPipeError, ConnectionResetError):
            pass

    # ----------------------------------------------------------- POST routes
    def do_POST(self):  # noqa: N802 — stdlib handler name
        fe = self.server.frontend
        path = self.path.split("?", 1)[0]
        if path != "/v1/chat/completions":
            self._send_json(404, ApiError(404, f"no route {path}").body(), path)
            return
        t0 = time.perf_counter()
        try:
            length = int(self.headers.get("Content-Length") or 0)
            parsed = parse_chat_body(self.rfile.read(length))
            q = resolve_query_idx(parsed, fe.universe, fe.text_index)
            if parsed["stream"]:
                self._stream_completion(q, path, t0, parsed["gen"])
            else:
                self._unary_completion(q, path, t0, parsed["gen"])
        except ApiError as e:
            self._send_json(e.status, e.body(), path)
        except (BrokenPipeError, ConnectionResetError):
            pass
        except Exception as e:   # noqa: BLE001 — wire boundary
            self._send_json(500, ApiError(500, f"internal error: {e}",
                                          "server_error").body(), path)

    def _model_name(self, req) -> Optional[str]:
        fe = self.server.frontend
        return fe.server.pool[req.model].name if req.model is not None else None

    def _unary_completion(self, q: int, path: str, t0: float,
                          gen=None) -> None:
        fe = self.server.frontend
        req = fe.server.submit_request(q, stream=False, gen=gen)
        if not req.done_event.wait(fe.request_timeout_s):
            raise ApiError(504, "request timed out in the serving queue",
                           "timeout_error")
        if req.dropped:
            raise ApiError(429, "request shed (budget or reroute limit)",
                           "rate_limit_error")
        body = completion_response(req, self._model_name(req), fe.server.wl)
        self._send_json(200, body, path)
        if fe._http_latency is not None:
            fe._http_latency.labels(mode="unary").observe(time.perf_counter() - t0)

    def _stream_completion(self, q: int, path: str, t0: float,
                           gen=None) -> None:
        fe = self.server.frontend
        req = fe.server.submit_request(q, stream=True, gen=gen)
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.end_headers()
        self.close_connection = True
        self._observe(path, 200)
        first_chunk_at: Optional[float] = None
        try:
            self.wfile.write(role_frame(req))
            self.wfile.flush()
            deadline = time.perf_counter() + fe.request_timeout_s
            while True:
                timeout = max(0.0, deadline - time.perf_counter())
                try:
                    kind, payload = req.stream.q.get(timeout=timeout)
                except queue.Empty:
                    self.wfile.write(sse_event(
                        ApiError(504, "stream timed out", "timeout_error").body()))
                    break
                if kind == "delta":
                    if first_chunk_at is None:
                        first_chunk_at = time.perf_counter()
                    self.wfile.write(chunk_frame(req, payload))
                    self.wfile.flush()
                elif kind == "error":
                    self.wfile.write(sse_event(
                        ApiError(429, payload, "rate_limit_error").body()))
                else:       # ("done", None): the seal — emit the final frame
                    self.wfile.write(finish_frame(req, self._model_name(req),
                                                  fe.server.wl))
                    break
            self.wfile.write(SSE_DONE)
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            return          # client went away mid-stream; serving completes anyway
        if fe._http_latency is not None:
            now = time.perf_counter()
            fe._http_latency.labels(mode="stream").observe(now - t0)
            if first_chunk_at is not None and fe._http_ttfc is not None:
                fe._http_ttfc.observe(first_chunk_at - t0)


class HttpFrontend:
    """Threaded HTTP facade over one online server; see the module docstring.

    ``port=0`` binds an ephemeral port — read the actual one from
    :attr:`port` after :meth:`start` (the CLI prints it).  ``universe``
    defaults to the workload's test split: the index space chat requests
    resolve into.
    """

    def __init__(self, server, *, host: str = "127.0.0.1", port: int = 0,
                 metrics: Optional[MetricsRegistry] = None, universe=None,
                 request_timeout_s: float = 120.0, verbose: bool = False):
        self.server = server
        self.host = host
        self.universe = (server.wl.subset_indices("test")
                         if universe is None else universe)
        self.text_index = _pool_text_index(server.pool)
        self.request_timeout_s = float(request_timeout_s)
        self.verbose = verbose
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        bind_server_metrics(self.metrics, server)
        self._http_requests = self.metrics.counter(
            "robatch_http_requests_total",
            "HTTP requests by path and status code", ("path", "code"))
        self._http_latency = self.metrics.histogram(
            "robatch_http_request_seconds",
            "wall time per HTTP completion request", ("mode",))
        self._http_ttfc = self.metrics.histogram(
            "robatch_http_time_to_first_chunk_seconds",
            "wall time from request to first streamed content chunk")
        self.n_http_requests = 0
        self._httpd = _HttpServer((host, port), _Handler)
        self._httpd.frontend = self
        self._stop = threading.Event()
        self._loop: Optional[threading.Thread] = None
        self._serve: Optional[threading.Thread] = None
        self.threads_leaked: list[str] = []   # set by stop(); [] == clean exit

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def health(self) -> dict:
        srv = self.server
        members = []
        degraded = False
        for m, br in zip(srv.pool, srv.breakers):
            n_rep = int(getattr(m, "n_replicas", 1))
            avail_fn = getattr(m, "n_available", None)
            avail = int(avail_fn()) if avail_fn is not None else n_rep
            state = br.state.name.lower()
            if br.state != CircuitState.CLOSED or avail < n_rep:
                degraded = True
            members.append({"name": m.name, "breaker": state,
                            "replicas": n_rep, "available": avail,
                            "pending_builds": int(getattr(m, "n_pending_builds", 0))})
        return {"status": "degraded" if degraded else "ok",
                "pending": len(srv.pending), "windows": len(srv.windows),
                "completed": len(srv.completed),
                "last_window": srv.windows[-1].summary() if srv.windows else None,
                "members": members}

    # --------------------------------------------------------------- lifecycle
    def start(self) -> "HttpFrontend":
        assert self._loop is None, "frontend already started"
        self._loop = threading.Thread(target=self.server.run_bridge,
                                      args=(self._stop,), daemon=True,
                                      name="robatch-serving-loop")
        self._serve = threading.Thread(target=self._httpd.serve_forever,
                                       daemon=True, name="robatch-http")
        self._loop.start()
        self._serve.start()
        return self

    def stop(self, timeout_s: float = 10.0) -> None:
        """Graceful shutdown: stop accepting connections, wake the serving
        loop (which drains pending requests so no waiter hangs), join both
        threads.  A thread that outlives its join lands in
        :attr:`threads_leaked` (and a stderr warning) instead of being
        silently abandoned — the launcher's shutdown marker reports it."""
        self._httpd.shutdown()
        self._httpd.server_close()
        self._stop.set()
        if self._serve is not None:
            self._serve.join(timeout=timeout_s)
        if self._loop is not None:
            self._loop.join(timeout=timeout_s)
        self.threads_leaked = [t.name for t in (self._serve, self._loop)
                               if t is not None and t.is_alive()]
        if self.threads_leaked:
            print(f"HttpFrontend.stop: WARNING threads still alive "
                  f"{timeout_s}s after shutdown: {self.threads_leaked}",
                  file=sys.stderr)
        self.server.close()

    def __enter__(self) -> "HttpFrontend":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
