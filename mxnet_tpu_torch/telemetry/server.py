"""Live introspection HTTP server — stdlib-only, daemon-threaded.

Counterpart of mxnet_tpu/telemetry/server.py. `telemetry.serve(port)`
exposes a running process to curl, a Prometheus scraper, and
ui.perfetto.dev without adding a dependency or a thread the process
must manage:

    /            tiny HTML index of the endpoints
    /healthz     200 "ok" — liveness; "degraded: <reasons>" (still
                 200, flagged body) while the flight recorder holds a
                 latched dump OR a component flagged itself degraded
                 via set_degraded() (the serving engine does under
                 sustained overload)
    /readyz      readiness, distinct from liveness: components
                 register a probe (register_ready_probe) reporting
                 {warmed, degraded, draining}; a component is ready
                 when warmed AND not degraded AND not draining. 200
                 while at least one registered component is ready
                 (or none registered), 503 otherwise — so ONE
                 intentionally-draining replica never flips the whole
                 process not-ready. ?component=<name> scopes the
                 answer to one component (503 when it is not ready or
                 unknown). External LBs and the ServingRouter consume
                 this; /healthz stays pure liveness.
    /metrics     Prometheus text exposition (0.0.4) of the registry
    /statusz     JSON: process info (uptime, RSS, python/torch
                 versions), registered component status (engine
                 config/occupancy/hit-rates), device-memory watermarks
    /requests    recent request timelines as JSON (?n=50)
    /trace       Chrome trace_event JSON of timelines + spans
                 (?last_ms=N) — load the response in ui.perfetto.dev
    /compilez    JSON: per-program compile attribution (kernel library
                 builds and loads) + model-formula cost + MFU/roofline
                 placement (telemetry.cost)
    /memz        JSON: the HBM ledger reconciled against the CUDA
                 allocator's live bytes (telemetry.ledger)
    /sloz        JSON: declared SLO objectives + multi-window burn
                 rates (fast/slow windows, Google-SRE style) and which
                 objectives are currently fast-burning (telemetry.slo)
    /fleetz      JSON: the fleet collector's view — per-worker health/
                 role/staleness, fleet tokens/sec and tokens/sec/chip,
                 the fleet-global SLO snapshot (404 until a
                 collector registers via register_fleetz_provider:
                 serving/fleet/observe.py FleetCollector.start())

Every read is a snapshot under the instrument locks, so concurrent
scrapes during serving never tear. Components publish into `/statusz`
and flight-recorder dumps by registering a status provider; the
registry holds weak references, so a garbage-collected engine silently
drops out.

One departure from the reference: `register_ready_probe` builds its
weak reference BEFORE it takes `_ready_lock`, and the lock is
reentrant. In the reference a garbage collection triggered inside the
lock can run a dead engine's `weakref.finalize`, which calls
`unregister_ready_probe` and waits on the same lock forever.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

__all__ = ["serve", "stop_server", "get_server", "IntrospectionServer",
           "HttpServerThread",
           "register_status_provider", "unregister_status_provider",
           "collect_status", "set_degraded", "clear_degraded",
           "degraded_reasons", "register_ready_probe",
           "unregister_ready_probe", "readiness", "component_ready",
           "healthz_body", "readyz_body",
           "register_fleetz_provider", "unregister_fleetz_provider",
           "fleetz_payload"]

_T0 = time.time()
_providers_lock = threading.Lock()
_providers = {}            # name -> weakref-able callable () -> dict
_server = None             # the default server started by serve()
_server_lock = threading.Lock()
_degraded_lock = threading.Lock()
_degraded = {}             # component name -> reason
# reentrant: a finalizer that unregisters a probe may run (through a
# garbage collection) on a thread that already holds the lock
_ready_lock = threading.RLock()
_ready_probes = {}         # name -> weakref-able callable () -> dict


def set_degraded(name, reason="overload"):
    """Flag a component as gracefully degraded: /healthz answers
    `degraded: <name>=<reason>` (still 200 — the process is alive and
    serving, just not at full service) and /statusz grows a
    `degraded` block. Cleared with clear_degraded(name)."""
    with _degraded_lock:
        _degraded[str(name)] = str(reason)


def clear_degraded(name):
    """Remove a component's degradation flag (no-op when absent)."""
    with _degraded_lock:
        _degraded.pop(str(name), None)


def degraded_reasons():
    """{component: reason} of currently degraded components."""
    with _degraded_lock:
        return dict(_degraded)


def _weakly(fn):
    """Hold `fn` via WeakMethod when it is a bound method, so a dead
    owner drops its registration instead of leaking it."""
    if hasattr(fn, "__self__"):
        ref = weakref.WeakMethod(fn)
        return lambda: ref()
    return lambda: fn


def register_ready_probe(name, fn):
    """Publish a readiness probe for one component under `name`:
    `fn() -> {"warmed": bool, "degraded": bool-or-reason,
    "draining": bool}`. The component is READY when warmed and not
    degraded and not draining — /readyz serves the per-component
    conjunctions. Bound methods are held weakly (see
    register_status_provider)."""
    # the weak reference is built outside the lock: building it may
    # collect garbage, and a collected engine's finalizer unregisters
    # its own probe under this lock
    get = _weakly(fn)
    key = str(name)
    with _ready_lock:
        _ready_probes[key] = get


def unregister_ready_probe(name):
    with _ready_lock:
        _ready_probes.pop(str(name), None)


def readiness():
    """{component: {"warmed", "degraded", "draining", "ready"}} for
    every registered probe. Dead weakrefs drop out; a probe that
    raises reports ready=False with the error (a broken component is
    not ready, but must not break the endpoint)."""
    with _ready_lock:
        items = list(_ready_probes.items())
    out = {}
    dead = []
    for name, get in items:
        fn = get()
        if fn is None:
            dead.append(name)
            continue
        try:
            st = dict(fn())
            st["ready"] = bool(st.get("warmed")
                               and not st.get("degraded")
                               and not st.get("draining"))
        except Exception as e:
            st = {"ready": False,
                  "error": f"{type(e).__name__}: {e}"}
        out[name] = st
    if dead:
        with _ready_lock:
            for name in dead:
                _ready_probes.pop(name, None)
    return out


def component_ready(name):
    """One component's readiness (None when no such probe)."""
    st = readiness().get(str(name))
    return None if st is None else st["ready"]


def healthz_body():
    """The /healthz text body — shared by every HTTP surface (the
    introspection server and serving/frontend.py): 'ok' when nothing
    is flagged, else the degraded components and latched flight
    reasons. Always 200 — this is liveness, not readiness."""
    from . import flight
    reasons = list(flight.latched_reasons())
    reasons.extend(f"{n}={r}" for n, r
                   in sorted(degraded_reasons().items()))
    return "ok\n" if not reasons else \
        "degraded: " + ",".join(reasons) + "\n"


def readyz_body(component=None):
    """The /readyz JSON body and status code — (dict, 200|503) —
    shared by every HTTP surface. `component` scopes the answer to one
    registered probe (503 when it is not ready or unknown)."""
    comps = readiness()
    if component is not None:
        st = comps.get(component)
        ready = bool(st and st["ready"])
        body = {"component": component, "ready": ready, "state": st}
    else:
        ready = (not comps) or any(c["ready"] for c in comps.values())
        body = {"ready": ready, "components": comps}
    return body, (200 if ready else 503)


_fleetz_lock = threading.Lock()
_fleetz_provider = None    # () -> weakref-able callable () -> dict


def register_fleetz_provider(fn):
    """Publish `fn() -> dict` as the /fleetz payload — the fleet
    collector registers its `fleetz` bound method here (held weakly,
    like status providers, so a dead collector drops out). One
    provider per process: the latest registration wins."""
    global _fleetz_provider
    with _fleetz_lock:
        _fleetz_provider = _weakly(fn)


def unregister_fleetz_provider(fn=None):
    """Drop the /fleetz provider. With `fn` given, only drop it when
    it is still the registered one (a newer collector's registration
    survives an older collector's close)."""
    global _fleetz_provider
    with _fleetz_lock:
        if fn is not None and _fleetz_provider is not None \
                and _fleetz_provider() not in (fn, None):
            return
        _fleetz_provider = None


def fleetz_payload():
    """The /fleetz body, or None when no collector is registered (or
    the registered one has been garbage-collected)."""
    global _fleetz_provider
    with _fleetz_lock:
        get = _fleetz_provider
    if get is None:
        return None
    fn = get()
    if fn is None:
        with _fleetz_lock:
            if _fleetz_provider is get:
                _fleetz_provider = None
        return None
    return fn()


def register_status_provider(name, fn):
    """Publish `fn() -> dict` under `name` in /statusz and in flight
    dumps. Bound methods are held via WeakMethod — a dead owner drops
    the provider instead of leaking it."""
    if hasattr(fn, "__self__"):
        fn = weakref.WeakMethod(fn)
        get = lambda ref=fn: ref()                       # noqa: E731
    else:
        get = lambda f=fn: f                             # noqa: E731
    with _providers_lock:
        _providers[str(name)] = get


def unregister_status_provider(name):
    with _providers_lock:
        _providers.pop(str(name), None)


def collect_status():
    """{provider name: its dict} — dead weakrefs dropped, provider
    exceptions surfaced as {"error": ...} so one broken component
    can't blank the whole page."""
    with _providers_lock:
        items = list(_providers.items())
    out = {}
    dead = []
    for name, get in items:
        fn = get()
        if fn is None:
            dead.append(name)
            continue
        try:
            out[name] = fn()
        except Exception as e:
            out[name] = {"error": f"{type(e).__name__}: {e}"}
    if dead:
        with _providers_lock:
            for name in dead:
                _providers.pop(name, None)
    return out


def _rss_bytes():
    """Current resident set size. /proc on linux; ru_maxrss (the PEAK,
    in KiB on linux) as the portable fallback; None when unknowable."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGESIZE")
    except Exception:
        pass
    try:
        import resource
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except Exception:
        return None


def _versions():
    """Interpreter + key-library versions — only libraries this process
    already imported (probing must never initialize a backend)."""
    out = {"python": sys.version.split()[0]}
    for mod in ("torch", "numpy"):
        m = sys.modules.get(mod)
        if m is not None:
            out[mod] = getattr(m, "__version__", "unknown")
    return out


def _statusz():
    from . import default_registry, flight, memory

    def _counter(name):
        inst = default_registry.get(name)
        return None if inst is None else inst.value

    status = {
        "time": time.time(),
        "uptime_seconds": round(time.time() - _T0, 3),
        "argv": list(sys.argv),
        "pid": os.getpid(),
        "rss_bytes": _rss_bytes(),
        "versions": _versions(),
        "python": sys.version.split()[0],
        "cuda_initialized": memory.cuda_live() is not None,
        "flight_latched": flight.latched_reasons(),
        "degraded": degraded_reasons(),
        "readiness": readiness(),
        "components": collect_status(),
        "jit_cache": {
            "retraces": _counter("jit_cache_retraces_total"),
            "evictions": _counter("jit_cache_evictions_total"),
        },
    }
    # device-memory watermarks: sample only when CUDA is already live —
    # /statusz must never be the thing that initializes the card
    if memory.cuda_live() is not None:
        try:
            status["memory"] = memory.sample()
        except Exception as e:
            status["memory"] = {"error": str(e)}
    return status


_INDEX = """<!doctype html><title>mx.telemetry</title>
<h1>mx.telemetry introspection</h1><ul>
<li><a href="/metrics">/metrics</a> — Prometheus text exposition</li>
<li><a href="/statusz">/statusz</a> — engine/process status JSON</li>
<li><a href="/requests">/requests</a> — recent request timelines</li>
<li><a href="/trace">/trace</a> — Chrome trace JSON
 (open in <a href="https://ui.perfetto.dev">ui.perfetto.dev</a>;
 ?last_ms=N for the trailing window)</li>
<li><a href="/compilez">/compilez</a> — per-program kernel builds
 and loads + MFU/roofline</li>
<li><a href="/memz">/memz</a> — HBM ledger vs CUDA live bytes</li>
<li><a href="/sloz">/sloz</a> — SLO objectives + multi-window
 burn rates</li>
<li><a href="/fleetz">/fleetz</a> — fleet collector view: per-worker
 health/staleness, fleet tokens/sec(/chip), fleet SLO (404 until a
 collector registers)</li>
<li><a href="/healthz">/healthz</a> — liveness (degraded while a
 flight dump is latched)</li>
<li><a href="/readyz">/readyz</a> — readiness (warmed &and; not
 degraded &and; not draining, per component; ?component=name)</li>
</ul>"""


class _Handler(BaseHTTPRequestHandler):
    server_version = "mx-telemetry/1.0"

    def log_message(self, fmt, *args):
        pass                        # scrapes must not spam stderr

    def _reply(self, body, ctype="application/json", code=200):
        if isinstance(body, str):
            body = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):              # noqa: N802 (stdlib handler name)
        from . import render_prometheus, snapshot  # noqa: F401
        from .request_trace import chrome_trace, request_log

        url = urlparse(self.path)
        q = parse_qs(url.query)
        try:
            if url.path in ("/", "/index.html"):
                self._reply(_INDEX, "text/html; charset=utf-8")
            elif url.path == "/healthz":
                self._reply(healthz_body(), "text/plain; charset=utf-8")
            elif url.path == "/readyz":
                body, code = readyz_body(q.get("component", [None])[0])
                self._reply(json.dumps(body, sort_keys=True), code=code)
            elif url.path == "/metrics":
                self._reply(render_prometheus(),
                            "text/plain; version=0.0.4; charset=utf-8")
            elif url.path == "/statusz":
                self._reply(json.dumps(_statusz(), indent=1,
                                       sort_keys=True, default=str))
            elif url.path == "/requests":
                n = int(q.get("n", ["50"])[0])
                self._reply(json.dumps(
                    {"requests": request_log.recent(n)}, default=str))
            elif url.path == "/trace":
                last_ms = q.get("last_ms", [None])[0]
                tr = chrome_trace(
                    last_ms=float(last_ms) if last_ms else None)
                self._reply(json.dumps(tr))
            elif url.path == "/compilez":
                from . import cost
                self._reply(json.dumps(cost.report(), indent=1,
                                       sort_keys=True, default=str))
            elif url.path == "/memz":
                from . import ledger
                self._reply(json.dumps(ledger.snapshot(), indent=1,
                                       sort_keys=True, default=str))
            elif url.path == "/sloz":
                from . import slo
                self._reply(json.dumps(slo.snapshot(), indent=1,
                                       sort_keys=True, default=str))
            elif url.path == "/fleetz":
                body = fleetz_payload()
                if body is None:
                    self._reply(json.dumps(
                        {"error": "no fleet collector registered in "
                                  "this process",
                         "hint": "FleetRouter.observe() or "
                                 "FleetCollector.start() registers "
                                 "one (not ported yet)"}), code=404)
                else:
                    self._reply(json.dumps(body, indent=1,
                                           sort_keys=True, default=str))
            else:
                self._reply(json.dumps({"error": "not found",
                                        "path": url.path}), code=404)
        except Exception as e:   # a broken read must answer, not hang
            self._reply(json.dumps(
                {"error": f"{type(e).__name__}: {e}"}), code=500)


class HttpServerThread:
    """A ThreadingHTTPServer on a daemon thread — the shared lifecycle
    for every HTTP surface in the package (this introspection server,
    serving/frontend.py's ingress). port=0 picks a free port (read it
    back from `.port`). `close()` is DETERMINISTIC and idempotent: it
    stops the accept loop, releases the listening port, and joins the
    server thread, so tests never leak listeners; `stop()` is an alias
    and the instance is a context manager. Handlers reach the owning
    wrapper through `self.server.owner` (set before the thread
    starts, so the first request can never race it)."""

    handler_class = None            # subclasses set the handler
    name_prefix = "mx-http"

    def __init__(self, port=0, host="127.0.0.1"):
        self._httpd = ThreadingHTTPServer((host, int(port)),
                                          self.handler_class)
        self._httpd.daemon_threads = True
        self._httpd.owner = self
        self.host = host
        self.port = self._httpd.server_address[1]
        self._closed = False
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.1},
            name=f"{self.name_prefix}:{self.port}", daemon=True)
        self._thread.start()

    @property
    def url(self):
        return f"http://{self.host}:{self.port}"

    def close(self):
        if self._closed:
            return
        self._closed = True
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)

    def stop(self):
        self.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __repr__(self):
        return f"{type(self).__name__}({self.url})"


class IntrospectionServer(HttpServerThread):
    """The telemetry surface on the shared HttpServerThread lifecycle
    (see the module docstring for the endpoints)."""

    handler_class = _Handler
    name_prefix = "mx-telemetry-http"


def serve(port=0, host="127.0.0.1"):
    """Start (or return) the process's introspection server. Idempotent
    per process: a second call returns the live server (a port mismatch
    raises — two registries' worth of servers is never what you want;
    construct IntrospectionServer directly for that)."""
    global _server
    with _server_lock:
        if _server is not None:
            if port not in (0, _server.port):
                from ..base import MXNetError
                raise MXNetError(
                    f"introspection server already on port {_server.port}; "
                    f"stop_server() first to move it to {port}")
            return _server
        _server = IntrospectionServer(port, host)
        return _server


def get_server():
    return _server


def stop_server():
    """Stop the default server (no-op when none is running)."""
    global _server
    with _server_lock:
        srv, _server = _server, None
    if srv is not None:
        srv.stop()
