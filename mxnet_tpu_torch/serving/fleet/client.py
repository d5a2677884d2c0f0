"""HTTP stubs for talking to fleet workers — stdlib-only.

Counterpart of mxnet_tpu/serving/fleet/client.py. `WorkerClient` wraps
one worker's base URL with the RPC surface the router needs: generate
(proxied SSE), prefill/adopt (the disaggregated handoff), cancel,
drain/undrain, health and stats. The failure taxonomy is the point of
this module:

* `WorkerGone` — connection-level evidence the worker process is gone
  or wedged: refused, reset, timed out, or the response stream hit EOF
  before its `done` event. The router treats it as replica-down and
  fails the work over.
* `WorkerRejected` — the worker ANSWERED with a structured rejection
  (429 queue-full/quota, 503 overload/draining, 409 wire-version
  mismatch, 400 invalid). The structured body fields ride on the
  exception so the router can re-raise the engine-shaped error at its
  own admission edge.

Every RPC has a finite timeout (a socket timeout on connect and on each
read, so a wedged worker surfaces as WorkerGone). Retries are bounded
with exponential backoff and apply to CONNECT failures only — a request
that may have reached the worker is never replayed blindly (the router
owns replay, via the migration contract, where it is deterministic).
"""
from __future__ import annotations

import http.client
import json
import time
from urllib.parse import urlparse

from ...base import MXNetError
from . import wire

__all__ = ["WorkerClient", "WorkerGone", "WorkerRejected", "SSEStream"]


class WorkerGone(MXNetError):
    """Connection-level failure: the worker is unreachable or its
    stream died before completing. Replica-down evidence."""


class WorkerRejected(MXNetError):
    """The worker answered with an HTTP error and (when well-formed) a
    structured JSON body {"error": {type, reason, message, ...}}."""

    def __init__(self, code, body=None):
        body = body if isinstance(body, dict) else {}
        err = body.get("error") or {}
        if not isinstance(err, dict):
            err = {"message": str(err)}
        super().__init__(
            f"worker rejected ({code}): "
            f"{err.get('reason') or err.get('type') or 'error'}: "
            f"{err.get('message')}")
        self.code = int(code)
        self.body = body
        self.type = err.get("type")
        self.reason = err.get("reason")
        self.retry_after_s = err.get("retry_after_s")
        self.queue_depth = err.get("queue_depth")
        self.active_slots = err.get("active_slots")


class SSEStream:
    """Iterator over one close-delimited SSE response: yields
    (event, data_dict) pairs, skipping keepalive comments. EOF before
    the stream's `done` event — or any socket error — raises
    WorkerGone, because a close-delimited stream that ends early IS
    the worker dying mid-request."""

    def __init__(self, conn, resp):
        self._conn = conn
        self._resp = resp
        self.done = False

    def __iter__(self):
        event, data = None, None
        while True:
            try:
                line = self._resp.readline()
            except (OSError, http.client.HTTPException) as e:
                self.close()
                raise WorkerGone(f"worker stream died mid-read: "
                                 f"{type(e).__name__}: {e}")
            if not line:            # EOF — the close that delimits
                self.close()
                if not self.done:
                    raise WorkerGone(
                        "worker stream ended before its 'done' event")
                return
            line = line.decode("utf-8", "replace").rstrip("\r\n")
            if not line:            # frame boundary
                if event is not None:
                    if event == "done":
                        self.done = True
                    yield event, data
                    if self.done:
                        self.close()
                        return
                    event, data = None, None
                continue
            if line.startswith(":"):
                continue            # keepalive comment
            if line.startswith("event:"):
                event = line[len("event:"):].strip()
            elif line.startswith("data:"):
                try:
                    data = json.loads(line[len("data:"):].strip())
                except ValueError:
                    data = None

    def close(self):
        try:
            self._conn.close()
        except Exception:           # noqa: BLE001 — teardown
            pass


class WorkerClient:
    """One worker's RPC surface. Connection-per-RPC (HTTP/1.0 on the
    worker side anyway); per-RPC timeouts; bounded connect retries."""

    def __init__(self, url, timeout_s=30.0, connect_retries=2,
                 backoff_s=0.05):
        u = urlparse(url if "://" in url else "http://" + url)
        if not u.hostname or not u.port:
            raise MXNetError(f"worker url needs host:port, got {url!r}")
        self.host = u.hostname
        self.port = int(u.port)
        self.url = f"http://{self.host}:{self.port}"
        self.timeout_s = float(timeout_s)
        self.connect_retries = int(connect_retries)
        self.backoff_s = float(backoff_s)

    def __repr__(self):
        return f"WorkerClient({self.url})"

    # -- plumbing ----------------------------------------------------------
    def _open(self, timeout=None):
        """Connect with bounded retries + exponential backoff. Only
        the connect is retried: once bytes may have reached the
        worker, a blind replay could double-submit."""
        last = None
        for attempt in range(self.connect_retries + 1):
            conn = http.client.HTTPConnection(
                self.host, self.port,
                timeout=self.timeout_s if timeout is None else timeout)
            try:
                conn.connect()
                return conn
            except OSError as e:
                conn.close()
                last = e
                if attempt < self.connect_retries:
                    time.sleep(self.backoff_s * (2 ** attempt))
        raise WorkerGone(f"{self.url}: connect failed: "
                         f"{type(last).__name__}: {last}")

    def _request(self, method, path, body=None, timeout=None,
                 headers=()):
        conn = self._open(timeout)
        try:
            data = None
            hdrs = dict(headers)
            if body is not None:
                data = body if isinstance(body, bytes) \
                    else json.dumps(body).encode("utf-8")
                hdrs.setdefault("Content-Type", "application/json")
            conn.request(method, path, body=data, headers=hdrs)
            return conn, conn.getresponse()
        except (OSError, http.client.HTTPException) as e:
            conn.close()
            raise WorkerGone(f"{self.url}{path}: "
                             f"{type(e).__name__}: {e}")

    def _json(self, method, path, body=None, timeout=None, headers=()):
        conn, resp = self._request(method, path, body, timeout, headers)
        try:
            try:
                raw = resp.read()
            except (OSError, http.client.HTTPException) as e:
                raise WorkerGone(f"{self.url}{path}: read failed: {e}")
        finally:
            conn.close()
        try:
            obj = json.loads(raw) if raw else {}
        except ValueError:
            obj = {"raw": raw[:200].decode("utf-8", "replace")}
        if resp.status >= 400:
            raise WorkerRejected(resp.status, obj)
        return obj

    def _sse(self, path, body, timeout=None, headers=()):
        conn, resp = self._request("POST", path, body, timeout, headers)
        if resp.status != 200:
            try:
                raw = resp.read()
                obj = json.loads(raw) if raw else {}
            except (OSError, ValueError, http.client.HTTPException):
                obj = {}
            finally:
                conn.close()
            raise WorkerRejected(resp.status, obj)
        return SSEStream(conn, resp)

    # -- data plane --------------------------------------------------------
    def generate(self, body, traceparent=None, timeout=None):
        """POST /v1/generate with "stream": true -> SSEStream. The
        traceparent header carries the router-owned trace id so the
        worker's timeline joins the request's single trace."""
        hdrs = (("traceparent", traceparent),) if traceparent else ()
        return self._sse("/v1/generate", dict(body, stream=True),
                         timeout=timeout, headers=hdrs)

    def prefill(self, body, traceparent=None, timeout=None):
        """POST /fleet/prefill: submit, run prefill to the first
        token, export with KV payload. Returns the wire blob dict
        (blob["final"] set when the request went terminal during
        prefill and there is nothing to hand off)."""
        hdrs = (("traceparent", traceparent),) if traceparent else ()
        blob = self._json("POST", "/fleet/prefill", body,
                          timeout=timeout or self.timeout_s, headers=hdrs)
        wire.check_version(blob)
        return blob

    def adopt(self, blob, timeout=None):
        """POST /fleet/adopt with a wire blob -> SSEStream of the
        continuation (an `adopted` event, then `tokens` events indexed
        from the blob's token count)."""
        return self._sse("/fleet/adopt", wire.dumps(blob),
                         timeout=timeout)

    def cancel(self, request_id, timeout=5.0):
        return self._json("POST", "/fleet/cancel",
                          {"request_id": request_id}, timeout=timeout)

    def export(self, timeout=None):
        """POST /fleet/export: drain-style export of every in-flight
        request as replay blobs (no KV payloads)."""
        out = self._json("POST", "/fleet/export", {}, timeout=timeout)
        return out.get("requests", [])

    # -- control plane -----------------------------------------------------
    def drain(self, timeout=5.0):
        return self._json("POST", "/fleet/drain", {}, timeout=timeout)

    def undrain(self, timeout=5.0):
        return self._json("POST", "/fleet/undrain", {}, timeout=timeout)

    def stats(self, timeout=10.0):
        return self._json("GET", "/fleet/stats", timeout=timeout)

    def requests(self, n=None, timeout=10.0):
        """GET /fleet/requests — the worker's recent request
        timelines; `n` bounds the pull (the collector caps it so a
        scrape cycle's cost stays flat as the log fills)."""
        path = "/fleet/requests" if n is None \
            else f"/fleet/requests?n={int(n)}"
        return self._json("GET", path, timeout=timeout)

    def sloz(self, timeout=10.0):
        """GET /fleet/sloz — the worker's SLO snapshot + clock stamp."""
        return self._json("GET", "/fleet/sloz", timeout=timeout)

    def flightz(self, timeout=10.0):
        """GET /fleet/flightz — the worker's flight-recorder state
        (latched reasons, dump paths, breadcrumb tail)."""
        return self._json("GET", "/fleet/flightz", timeout=timeout)

    def healthz(self, timeout=2.0):
        try:
            self._json("GET", "/healthz", timeout=timeout)
            return True
        except (WorkerGone, WorkerRejected):
            return False

    def metrics_text(self, timeout=10.0):
        conn, resp = self._request("GET", "/metrics", timeout=timeout)
        try:
            raw = resp.read()
        except (OSError, http.client.HTTPException) as e:
            raise WorkerGone(f"{self.url}/metrics: read failed: {e}")
        finally:
            conn.close()
        if resp.status >= 400:
            raise WorkerRejected(resp.status, {})
        return raw.decode("utf-8", "replace")
