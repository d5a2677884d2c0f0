"""Streaming HTTP ingress for the serving stack — stdlib-only.

Counterpart of mxnet_tpu/serving/frontend.py over one port
`ServingEngine` or a `ServingRouter` fleet of them. `ServingFrontend`
turns the backend into a servable endpoint on the same
ThreadingHTTPServer stack as telemetry/server.py:

    POST /v1/generate   generate from a JSON body; the default
                        response is an SSE stream (`tokens` events as
                        they land, a structured `error` event on
                        overflow, one final `done` event), or a single
                        JSON body with "stream": false
    GET  /healthz       process liveness (shared with telemetry)
    GET  /readyz        readiness — flips 503 the moment shutdown()
                        starts draining (?component= scoping works)
    GET  /metrics       Prometheus text exposition of the registry

Three robustness properties anchor the design:

* **Backpressure maps to HTTP.** The engine's structured rejections
  become status codes — `QueueFullError`/`TenantQuotaError` -> 429,
  `ShedError` (overload, draining, infeasible deadline) -> 503 — and
  every rejection carries a `Retry-After` header from the engine's
  drain-rate estimate plus the full structured body (reason,
  queue_depth, active_slots, priority, tenant, retry_after_s).

* **Disconnects cancel.** Every write to the client doubles as a
  liveness probe (idle streams get `: keepalive` SSE comments); a
  failed write means the client hung up, and the handler routes
  `cancel(request_id)` onto the serving thread — slot, page, and
  adapter leases release immediately. Cancellation is idempotent, so
  the disconnect vs natural-finish race is harmless.

* **Bounded memory end to end.** Tokens flow through a bounded
  `TokenStream`; when a slow client lets it fill, the engine cancels
  the request (`_overflow_cancel`) instead of buffering unboundedly,
  and the client gets a structured `overflow` error event.

A CUDA or kernel error out of `step()` (the engine's fatal class,
`engine._fatal`) is not retried: the frontend latches not ready
(/readyz 503 for it and, since the engine latches too, for the
engine), ends every open stream with a `backend_failed` error event,
answers new POSTs 503 and stops its serving loop. Any other exception
out of `step()` is recorded and the loop steps again, as the
reference's does.

Threading model: HTTP handler threads NEVER touch the engine. They
parse, enqueue a submit/cancel command, and read the Request + its
TokenStream. One serving-loop thread owns every backend mutation —
it drains the command queue between `step()` calls, which is exactly
the "call from the serving thread" contract engine.cancel() states.
A frontend fronting a ServingRouter inherits the fleet's failover: a
replica kill mid-stream migrates the Request (stream attached) via
export/adopt, and the client's stream continues bit-identically. A
CUDA or kernel error leaves the router's step() like an engine's and
fails the frontend as above.
"""
from __future__ import annotations

import itertools
import json
import math
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler
from urllib.parse import parse_qs, urlparse

from ..base import MXNetError
from ..analysis import assertions_enabled, claim_ownership, thread_safe
from .. import telemetry
from ..telemetry import server as _tserver
from .engine import _fatal
from .scheduler import (Request, RejectedError, QueueFullError,
                        TERMINAL_STATUSES)

__all__ = ["ServingFrontend", "TokenStream"]

_frontend_ids = itertools.count()
_F = ("frontend",)

# socket errors that mean "the client hung up" (ConnectionResetError
# and BrokenPipeError are OSError subclasses; ValueError covers a
# write on a handler-closed file object)
_DISCONNECT_ERRORS = (OSError, ValueError)


def _frontend_metrics(fid):
    c, g, h = telemetry.counter, telemetry.gauge, telemetry.histogram
    m = {
        "active_streams": g(
            "http_active_streams",
            "response streams currently open on /v1/generate", _F),
        "disconnects": c(
            "http_disconnects_total",
            "client disconnects detected mid-request (each one routes "
            "a cancel onto the serving thread)", _F),
        "overflows": c(
            "http_stream_overflows_total",
            "streams whose bounded token buffer overflowed (slow "
            "client) — the engine cancelled the request rather than "
            "buffer unboundedly", _F),
        "ttfb": h(
            "http_ttfb_seconds",
            "request arrival at the frontend -> first token event "
            "written to the socket (client-observable first byte of "
            "generated output)", _F),
    }
    _code_family()
    return {k: inst.labels(fid) for k, inst in m.items()}


def _code_family():
    return telemetry.counter(
        "http_requests_total",
        "requests answered on /v1/generate, by final HTTP status code "
        "(200 stream/body, 400 invalid, 429 queue-full/quota, 503 "
        "overload/draining, 500 internal)", ("frontend", "code"))


class TokenStream:
    """Bounded bridge from the engine's dispatch loop to one HTTP
    response thread. The engine calls emit()/close() (duck-typed via
    `Request.stream`); the handler thread blocks in take(). emit()
    returns False — and latches `overflowed` — when the buffer can't
    absorb a dispatch's tokens: the engine's slow-client policy then
    cancels the request. close() is first-wins and idempotent."""

    def __init__(self, capacity=256):
        self.capacity = int(capacity)
        self.overflowed = False
        self.emitted = 0            # tokens accepted into the buffer
        self._buf = []
        self._closed = None         # terminal status string once closed
        self._cv = threading.Condition()

    def emit(self, tokens):
        tokens = list(tokens)
        with self._cv:
            if self._closed is not None:
                return True         # late emit after close: drop quietly
            if not tokens:
                return True
            if len(self._buf) + len(tokens) > self.capacity:
                self.overflowed = True
                self._cv.notify_all()
                return False
            self._buf.extend(tokens)
            self.emitted += len(tokens)
            self._cv.notify_all()
            return True

    def close(self, status):
        with self._cv:
            if self._closed is None:
                self._closed = str(status)
            self._cv.notify_all()

    @property
    def closed(self):
        with self._cv:
            return self._closed

    def take(self, timeout=None):
        """Block until tokens arrive or the stream closes (or
        `timeout` elapses — the handler's keepalive cadence). Returns
        (tokens, closed_status_or_None); buffered tokens always drain
        before/alongside the close."""
        with self._cv:
            if not self._buf and self._closed is None:
                self._cv.wait(timeout)
            toks, self._buf = self._buf, []
            return toks, self._closed


class _Handler(BaseHTTPRequestHandler):
    server_version = "mx-serving/1.0"
    protocol_version = "HTTP/1.0"   # close-delimited: SSE needs no
                                    # Content-Length and no chunk framing

    def log_message(self, fmt, *args):
        pass                        # traffic must not spam stderr

    @property
    def fe(self):
        return self.server.owner.frontend

    # -- plumbing ----------------------------------------------------------
    def _reply(self, body, code=200, ctype="application/json",
               headers=()):
        if isinstance(body, (dict, list)):
            body = json.dumps(body, sort_keys=True, default=str)
        if isinstance(body, str):
            body = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_event(self, event, data):
        self.wfile.write(
            (f"event: {event}\ndata: {json.dumps(data, default=str)}"
             "\n\n").encode("utf-8"))
        self.wfile.flush()

    # -- GET: health/readiness/metrics reuse the telemetry surface ---------
    def do_GET(self):               # noqa: N802 (stdlib handler name)
        url = urlparse(self.path)
        q = parse_qs(url.query)
        try:
            if url.path == "/healthz":
                self._reply(_tserver.healthz_body(),
                            ctype="text/plain; charset=utf-8")
            elif url.path == "/readyz":
                body, code = _tserver.readyz_body(
                    q.get("component", [None])[0])
                self._reply(body, code=code)
            elif url.path == "/metrics":
                self._reply(telemetry.render_prometheus(),
                            ctype="text/plain; version=0.0.4; "
                                  "charset=utf-8")
            elif url.path in ("/", "/index.html"):
                self._reply({"endpoints": ["/v1/generate", "/healthz",
                                           "/readyz", "/metrics"]})
            else:
                self._reply({"error": "not found", "path": url.path},
                            code=404)
        except _DISCONNECT_ERRORS:
            pass                    # scraper hung up: nothing to do
        except Exception as e:      # noqa: BLE001 — must answer
            self._reply({"error": f"{type(e).__name__}: {e}"}, code=500)

    # -- POST /v1/generate -------------------------------------------------
    def do_POST(self):              # noqa: N802 (stdlib handler name)
        fe = self.fe
        url = urlparse(self.path)
        if url.path != "/v1/generate":
            self._counted_reply(
                {"error": {"type": "NotFound", "reason": "not_found",
                           "message": url.path}}, 404)
            return
        t0 = time.perf_counter()
        try:
            raw = self.rfile.read(
                int(self.headers.get("Content-Length") or 0))
        except OSError:
            return                  # client hung up mid-upload
        except ValueError as e:     # malformed Content-Length
            self._counted_reply(_invalid_body(e), 400)
            return
        try:
            body = json.loads(raw or b"{}")
            if not isinstance(body, dict):
                raise ValueError("request body must be a JSON object")
        except Exception as e:      # noqa: BLE001 — malformed request
            self._counted_reply(_invalid_body(e), 400)
            return
        if fe.failed is not None:
            self._counted_reply(_failed_body(fe), 503)
            return
        if fe.draining:
            self._reject_reply(_drain_rejection(fe), 503)
            return
        try:
            req = fe._build_request(body)
        except (MXNetError, TypeError, ValueError, KeyError) as e:
            self._counted_reply(_invalid_body(e), 400)
            return
        # W3C trace context: adopt the caller's trace id (invalid
        # headers are ignored per spec, never 400), else mint one —
        # the id rides the Request through router/engine/migration
        # and comes back on the response's own traceparent header
        tp = telemetry.parse_traceparent(self.headers.get("traceparent"))
        if tp is not None:
            req.trace = {"trace_id": tp[0], "parent_span": tp[1]}
        else:
            req.trace = {"trace_id": telemetry.new_trace_id()}
        want_stream = bool(body.get("stream", True))
        if want_stream:
            # the client may advertise a SMALLER buffer than the
            # server default (a flow-control window: "cancel me rather
            # than buffer more than this on my behalf"); the server's
            # bound stays the ceiling
            cap = fe.stream_buffer
            try:
                asked = body.get("stream_buffer")
                if asked is not None:
                    cap = max(1, min(int(asked), cap))
            except (TypeError, ValueError) as e:
                self._counted_reply(_invalid_body(e), 400)
                return
        else:
            # non-stream responses drain the buffer only at the end,
            # so the bound must cover the request's whole token
            # budget — still finite, still the request's own number
            cap = max(fe.stream_buffer, req.max_new_tokens + 8)
        stream = TokenStream(capacity=cap)
        req.stream = stream
        outcome, err = fe._submit_via_loop(req)
        if outcome == "rejected":
            code = 429 if isinstance(err, QueueFullError) else 503
            self._reject_reply(_rejection_body(err), code)
            return
        if outcome == "invalid":
            self._counted_reply(_invalid_body(err), 400)
            return
        if outcome == "failed":
            self._counted_reply(_failed_body(fe), 503)
            return
        if outcome != "ok":
            self._counted_reply(
                {"error": {"type": "Internal", "reason": "internal",
                           "message": str(err)}}, 500)
            return
        fe._register(req, stream)
        try:
            if want_stream:
                self._stream_response(fe, req, stream, t0)
            else:
                self._json_response(fe, req, stream)
        finally:
            fe._unregister(req)

    def _counted_reply(self, body, code, headers=()):
        self.fe._code_inc(code)
        try:
            self._reply(body, code=code, headers=headers)
        except _DISCONNECT_ERRORS:
            pass                    # client gone before the reply

    def _reject_reply(self, body, code):
        """429/503 with Retry-After (integer seconds, >= 1) alongside
        the structured JSON rejection body."""
        wait = body["error"].get("retry_after_s")
        retry = max(1, math.ceil(wait)) if wait else 1
        self._counted_reply(body, code,
                            headers=(("Retry-After", str(retry)),))

    def _stream_response(self, fe, req, stream, t0):
        try:
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/event-stream; charset=utf-8")
            self.send_header("Cache-Control", "no-store")
            self.send_header("X-Request-Id", req.id)
            if req.trace:
                self.send_header("traceparent", telemetry.format_traceparent(
                    req.trace["trace_id"]))
            self.send_header("Connection", "close")
            self.end_headers()
        except _DISCONNECT_ERRORS:
            fe._on_disconnect(req)
            return
        fe._code_inc(200)
        sent = 0
        first = True
        while True:
            toks, closed = stream.take(timeout=fe.keepalive_s)
            try:
                if toks:
                    self._send_event("tokens",
                                     {"tokens": toks, "index": sent})
                    if first:
                        fe._observe_ttfb(time.perf_counter() - t0)
                        first = False
                    sent += len(toks)
                if closed is not None:
                    status = req.status \
                        if req.status in TERMINAL_STATUSES else closed
                    if closed == "error" and fe.failed is not None:
                        self._send_event("error", {
                            "error": "backend_failed",
                            "message": fe.failed, "sent": sent})
                    elif stream.overflowed:
                        fe._note_overflow()
                        self._send_event("error", {
                            "error": "overflow",
                            "message": "client fell behind: the "
                                       "bounded stream buffer "
                                       f"({stream.capacity} tokens) "
                                       "overflowed and the request "
                                       "was cancelled",
                            "sent": sent})
                    else:
                        # terminal reconciliation: tokens that reached
                        # the Request but not the buffer (hedge-won
                        # graft, close racing the last dispatch)
                        tail = [int(t) for t
                                in req.output_tokens[sent:]]
                        if tail:
                            self._send_event(
                                "tokens",
                                {"tokens": tail, "index": sent})
                            if first:
                                fe._observe_ttfb(
                                    time.perf_counter() - t0)
                                first = False
                            sent += len(tail)
                    self._send_event("done", {
                        "request_id": req.id, "status": status,
                        "emitted": len(req.output_tokens),
                        "sent": sent})
                    return
                if not toks:
                    self.wfile.write(b": keepalive\n\n")
                    self.wfile.flush()
            except _DISCONNECT_ERRORS:
                fe._on_disconnect(req)
                return

    def _json_response(self, fe, req, stream):
        while True:
            _, closed = stream.take(timeout=fe.keepalive_s)
            if closed is not None:
                break
        status = req.status if req.status in TERMINAL_STATUSES \
            else closed
        if status == "error" and fe.failed is not None:
            self._counted_reply(_failed_body(fe), 503)
            return
        body = {
            "request_id": req.id,
            "status": status,
            "output_tokens": [int(t) for t in req.output_tokens],
            "usage": {"prompt_tokens": req.prompt_len,
                      "completion_tokens": len(req.output_tokens)},
        }
        fe._code_inc(200)
        hdrs = [("X-Request-Id", req.id)]
        if req.trace:
            hdrs.append(("traceparent", telemetry.format_traceparent(
                req.trace["trace_id"])))
        try:
            self._reply(body, code=200, headers=tuple(hdrs))
        except _DISCONNECT_ERRORS:
            fe._on_disconnect(req)


def _rejection_body(exc):
    return {"error": {
        "type": type(exc).__name__,
        "reason": getattr(exc, "reason", None),
        "message": str(exc),
        "queue_depth": getattr(exc, "queue_depth", None),
        "active_slots": getattr(exc, "active_slots", None),
        "retry_after_s": getattr(exc, "retry_after_s", None),
        "priority": getattr(exc, "priority", None),
        "tenant": getattr(exc, "tenant", None),
    }}


def _invalid_body(exc):
    return {"error": {"type": type(exc).__name__,
                      "reason": "invalid_request",
                      "message": str(exc)}}


def _failed_body(fe):
    return {"error": {
        "type": "BackendFailed", "reason": "backend_failed",
        "message": fe.failed}}


def _drain_rejection(fe):
    wait = fe._drain_estimate()
    return {"error": {
        "type": "ShedError", "reason": "draining",
        "message": "frontend is draining: not accepting new requests",
        "queue_depth": None, "active_slots": None,
        "retry_after_s": wait, "priority": None, "tenant": None,
    }}


class _FrontendServer(_tserver.HttpServerThread):
    handler_class = _Handler
    name_prefix = "mx-serving-http"

    def __init__(self, frontend, port=0, host="127.0.0.1"):
        self.frontend = frontend
        super().__init__(port, host)


class _Box:
    """One submit command's result slot, handed between the handler
    thread and the serving loop."""
    __slots__ = ("outcome", "error", "event")

    def __init__(self):
        self.outcome = None
        self.error = None
        self.event = threading.Event()


class ServingFrontend:
    """The HTTP ingress plus the serving loop that owns the backend.

    `backend` is a ServingEngine or a ServingRouter (duck-typed:
    submit/cancel/step/has_work; an engine's estimated_drain_wait, or
    a router's `replicas`). The constructor starts both the
    listener and the serving-loop thread; `close()` is deterministic
    and idempotent (loop joined, port released) and the instance is a
    context manager. `shutdown()` is the graceful path: admission
    flips to 503 + Retry-After (and the registered /readyz probe flips
    not-ready), open streams drain, then everything closes."""

    server_class = _FrontendServer  # the fleet worker adds its routes

    def __init__(self, backend, port=0, host="127.0.0.1", *,
                 stream_buffer=256, keepalive_s=0.25,
                 step_idle_s=0.01, submit_timeout_s=30.0):
        self._backend = backend
        self._fid = next(_frontend_ids)
        self.stream_buffer = int(stream_buffer)
        self.keepalive_s = float(keepalive_s)
        self.step_idle_s = float(step_idle_s)
        self.submit_timeout_s = float(submit_timeout_s)
        self._metrics = _frontend_metrics(self._fid)
        self._codes_family = _code_family()
        self._lock = threading.Lock()
        self._codes = {}            # status code -> count (host mirror)
        self._disconnects = 0
        self._overflows = 0
        self._cancels_issued = 0
        self._cancels_noop = 0
        self._live = {}             # request id -> (Request, TokenStream)
        self._rid_counter = itertools.count()
        self._cmd_q = queue.Queue()
        self._wake = threading.Event()
        self._stop_evt = threading.Event()
        self._draining = False
        self._closed = False
        self._failed = None         # the fatal error that stopped the loop
        self._probe_name = f"frontend{self._fid}"
        _tserver.register_ready_probe(self._probe_name,
                                      self._ready_probe)
        telemetry.register_status_provider(self._probe_name,
                                           self._statusz)
        self._loop_thread = threading.Thread(
            target=self._serving_loop,
            name=f"mx-serving-loop:{self._fid}", daemon=True)
        self._server = self.server_class(self, port, host)
        self._loop_thread.start()

    # -- lifecycle ---------------------------------------------------------
    @property
    def url(self):
        return self._server.url

    @property
    def host(self):
        return self._server.host

    @property
    def port(self):
        return self._server.port

    @property
    def draining(self):
        return self._draining

    @property
    def failed(self):
        """None, or the CUDA or kernel error that stopped the serving
        loop (the frontend is then not ready for good)."""
        return self._failed

    @thread_safe
    def begin_drain(self):
        """Stop accepting new requests: /v1/generate answers 503 with
        a drain-estimate Retry-After and the registered /readyz probe
        flips not-ready. Admitted requests and open streams keep
        being served. Idempotent."""
        if self._draining:
            return
        self._draining = True
        telemetry.flight.record("frontend_draining", frontend=self._fid)

    def shutdown(self, timeout=30.0):
        """Graceful drain: begin_drain(), let the serving loop finish
        every admitted request and every open stream drain to its
        client, then close deterministically. `timeout` bounds the
        wait — whatever is still open when it expires is force-closed
        by close()."""
        self.begin_drain()
        deadline = time.monotonic() + float(timeout)
        while time.monotonic() < deadline:
            with self._lock:
                busy = bool(self._live)
            if self._failed is not None or (
                    not busy and self._cmd_q.empty()
                    and not self._backend.has_work):
                break
            time.sleep(0.02)
        self.close()

    def close(self):
        """Deterministic teardown: serving loop joined (pending
        submits failed, not leaked), any still-open streams force-
        closed, listener closed (port released), telemetry
        registrations dropped. Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._draining = True
        self._stop_evt.set()
        self._wake.set()
        self._loop_thread.join(timeout=10)
        with self._lock:
            live = list(self._live.values())
        for _req, st in live:
            try:
                st.close("aborted")
            except Exception:       # noqa: BLE001 — teardown
                pass
        self._server.close()
        _tserver.unregister_ready_probe(self._probe_name)
        _tserver.clear_degraded(self._probe_name)
        telemetry.unregister_status_provider(self._probe_name)
        self._metrics["active_streams"].set(0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __repr__(self):
        return (f"ServingFrontend({self.url}, "
                f"draining={self._draining})")

    # -- serving loop: the ONLY thread that touches the backend ------------
    def _serving_loop(self):
        if assertions_enabled():
            # warm-up ran on the constructing thread; this loop owns
            # the backend from here
            claim_ownership(self._backend)
        try:
            while not self._stop_evt.is_set():
                self._drain_cmds()
                try:
                    if self._backend.has_work:
                        self._backend.step()
                        continue
                except Exception as e:  # noqa: BLE001 — keep serving
                    if _fatal(e):
                        self._fail(e)
                        return
                    telemetry.flight.record(
                        "frontend_step_error", frontend=self._fid,
                        error=str(e)[:200])
                self._wake.wait(self.step_idle_s)
                self._wake.clear()
        finally:
            self._drain_cmds(fail=True)

    def _fail(self, exc):
        """The backend raised a CUDA or kernel error: latch not ready,
        end every open stream with an error (the handlers send
        `backend_failed`); the caller stops the serving loop."""
        self._failed = f"{type(exc).__name__}: {exc}"[:200]
        _tserver.set_degraded(self._probe_name, "fatal")
        telemetry.flight.record("frontend_fatal", frontend=self._fid,
                                error=self._failed)
        with self._lock:
            live = list(self._live.values())
        for _req, st in live:
            st.close("error")

    def _drain_cmds(self, fail=False):
        while True:
            try:
                kind, payload = self._cmd_q.get_nowait()
            except queue.Empty:
                return
            if kind == "submit":
                req, box = payload
                if fail:
                    if self._failed is not None:
                        box.outcome = "failed"
                    else:
                        box.outcome = "error"
                        box.error = MXNetError("frontend closed")
                    box.event.set()
                    continue
                self._do_submit(req, box)
            elif self._failed is None:      # never touch a failed backend
                self._do_cancel(payload)

    def _do_submit(self, req, box):
        try:
            self._backend.submit(req)
            box.outcome = "ok"
        except RejectedError as e:
            box.outcome, box.error = "rejected", e
        except MXNetError as e:
            box.outcome, box.error = "invalid", e
        except Exception as e:      # noqa: BLE001 — surface, don't die
            box.outcome, box.error = "error", e
        box.event.set()

    def _do_cancel(self, request_id):
        try:
            got = self._backend.cancel(request_id)
        except Exception:           # noqa: BLE001 — replica may be dead
            got = None
        with self._lock:
            if got:
                self._cancels_issued += 1
            else:
                self._cancels_noop += 1

    # -- handler-thread entry points ---------------------------------------
    def _build_request(self, body):
        prompt = body.get("prompt")
        if not isinstance(prompt, (list, tuple)) or not prompt:
            raise MXNetError(
                "'prompt' must be a non-empty list of token ids")
        kw = {}
        for k in ("do_sample", "temperature", "top_k", "top_p", "seed",
                  "eos_token_id", "priority", "deadline_ms",
                  "adapter_id", "tenant"):
            if body.get(k) is not None:
                kw[k] = body[k]
        rid = str(body.get("request_id")
                  or f"http{self._fid}-{next(self._rid_counter)}")
        return Request([int(t) for t in prompt],
                       int(body.get("max_new_tokens", 16)),
                       request_id=rid, **kw)

    @thread_safe
    def _submit_via_loop(self, req):
        """Hand the request to the serving thread and wait for the
        admission verdict: ("ok"|"rejected"|"invalid"|"error", exc)."""
        if self._failed is not None:
            return "failed", None
        box = _Box()
        self._cmd_q.put(("submit", (req, box)))
        self._wake.set()
        deadline = time.monotonic() + self.submit_timeout_s
        while not box.event.wait(timeout=0.05):
            if self._failed is not None:
                return "failed", None
            if not self._loop_thread.is_alive():
                return "error", MXNetError("frontend closed")
            if time.monotonic() > deadline:
                return "error", MXNetError("submission timed out")
        return box.outcome, box.error

    @thread_safe
    def cancel(self, request_id):
        """Route a cancel onto the serving thread (handler threads and
        external callers must never call the backend directly)."""
        self._cmd_q.put(("cancel", request_id))
        self._wake.set()

    @thread_safe
    def _on_disconnect(self, req):
        self._metrics["disconnects"].inc()
        with self._lock:
            self._disconnects += 1
        self.cancel(req.id)

    def _note_overflow(self):
        self._metrics["overflows"].inc()
        with self._lock:
            self._overflows += 1

    def _observe_ttfb(self, dt):
        self._metrics["ttfb"].observe(dt)

    def _register(self, req, stream):
        with self._lock:
            self._live[req.id] = (req, stream)
            n = len(self._live)
        self._metrics["active_streams"].set(n)
        if self._failed is not None:    # registered after _fail's sweep
            stream.close("error")

    def _unregister(self, req):
        with self._lock:
            self._live.pop(req.id, None)
            n = len(self._live)
        self._metrics["active_streams"].set(n)

    def _code_inc(self, code):
        self._codes_family.labels(self._fid, str(code)).inc()
        with self._lock:
            self._codes[str(code)] = self._codes.get(str(code), 0) + 1

    def _drain_estimate(self):
        """Seconds until in-flight work drains — the Retry-After a
        draining frontend attaches. Router backends report their
        slowest up replica (the drain completes when IT does)."""
        reps = getattr(self._backend, "replicas", None)
        if reps is None:
            return self._backend.estimated_drain_wait()
        waits = []
        for rep in reps:
            if rep.state != "up":
                continue
            try:
                w = rep.engine.estimated_drain_wait()
            except Exception:       # noqa: BLE001 — dead replica
                w = None
            if w is not None:
                waits.append(w)
        return max(waits) if waits else None

    # -- observability -----------------------------------------------------
    @thread_safe
    def _ready_probe(self):
        return {"warmed": True,
                "degraded": "fatal" if self._failed else False,
                "draining": self._draining or self._closed}

    @property
    def stats(self):
        with self._lock:
            return {
                "requests_by_code": dict(self._codes),
                "active_streams": len(self._live),
                "disconnects": self._disconnects,
                "stream_overflows": self._overflows,
                "cancels_issued": self._cancels_issued,
                "cancels_noop": self._cancels_noop,
                "draining": self._draining,
                "failed": self._failed,
            }

    @thread_safe
    def _statusz(self):
        return {"url": self.url, "stats": self.stats}
