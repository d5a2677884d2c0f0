"""Per-request lifecycle tracing with Chrome/Perfetto export.

A copy of mxnet_tpu/telemetry/request_trace.py (stdlib only; the port
keeps its own so that it never imports the JAX package).

Every serving request gets a structured event timeline — enqueued →
admitted → prefix_match → prefill → each decode/verify dispatch (with
emitted/drafted/accepted counts) → finished/cancelled/rejected —
recorded by the engine into a bounded in-memory ring
(`telemetry.request_log`, docs/OBSERVABILITY.md "Request timelines").
Recording is a dict append under one lock (~1 µs) against
multi-millisecond compiled dispatches, so it stays on by default; the
live server's `/requests` endpoint serves the ring as JSON and
`/trace` (or `chrome_trace()` here) exports it as Chrome `trace_event`
JSON that loads directly in ui.perfetto.dev or chrome://tracing.

Timestamps come from one process-wide clock: `perf_counter` offsets
re-anchored to the wall clock captured at import. That keeps every
`ts` **monotonic** (perf_counter never steps backwards the way
`time.time` can under NTP) while still reading as wall time, which is
what makes the exported `ts`/`dur` pairs internally consistent — a
child dispatch slice always nests inside its request's lifetime slice.

Distributed context (docs/OBSERVABILITY.md "Trace propagation"): every
trace carries a W3C trace-context id. The HTTP edge parses an incoming
`traceparent` header (or mints a fresh id) and the id rides the
Request through router placement, hedged clones, and
export/adopt migration — `begin(trace_id=..., t_begin=...,
phases=...)` re-opens a migrated request's timeline as a CONTINUATION
(same trace id, preserved start, accumulated phase budget) instead of
an orphan restart.

TTFT phase budget (docs/OBSERVABILITY.md "Phase taxonomy"): `phase()`
records one of the declared `PHASES` with a measured duration;
per-trace accumulation makes a request's time-to-first-token decompose
into queue_wait + prefix_match + host_pagein + prefill_chunks +
first_decode (+ handoff when a disaggregated fleet ships the finished
prefill to a decode worker). Phase names are CLOSED — an undeclared
name raises here (the reference's graftlint `phases` pass also flags
the literal statically in `mxnet_tpu`).

Zero dependencies: stdlib only, like the rest of `mx.telemetry`.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque

__all__ = ["RequestTrace", "RequestTraceLog", "request_log",
           "chrome_trace", "now", "PHASES", "new_trace_id",
           "new_span_id", "parse_traceparent", "format_traceparent"]

# one monotonic wall clock for every lifecycle/span timestamp
_EPOCH = time.time() - time.perf_counter()


def now():
    """Monotonic unix-epoch seconds (perf_counter re-anchored once)."""
    return _EPOCH + time.perf_counter()


#: The closed set of TTFT phase names. A request's time-to-first-token
#: decomposes into exactly these (docs/OBSERVABILITY.md "Phase
#: taxonomy"); `RequestTraceLog.phase()` rejects anything else.
#: `handoff` is cross-process only: the export->scatter gap when a
#: finished prefill ships its KV pages to a decode worker
#: (serving/fleet, docs/SERVING.md "Disaggregated prefill/decode").
PHASES = ("queue_wait", "prefix_match", "host_pagein",
          "prefill_chunks", "first_decode", "handoff")

# -- W3C trace-context (traceparent) helpers ----------------------------------
# Header shape: "00-<32 hex trace-id>-<16 hex span-id>-<2 hex flags>".
# This is the wire contract the HTTP edge speaks; the cross-process
# fleet reuses it verbatim.


def new_trace_id():
    """Fresh 32-hex-char W3C trace id (never all zeros)."""
    while True:
        t = os.urandom(16).hex()
        if t != "0" * 32:
            return t


def new_span_id():
    """Fresh 16-hex-char W3C span id (never all zeros)."""
    while True:
        s = os.urandom(8).hex()
        if s != "0" * 16:
            return s


def _is_hex(s):
    try:
        int(s, 16)
        return True
    except ValueError:
        return False


def parse_traceparent(header):
    """(trace_id, span_id) from a `traceparent` header value, or None
    when the header is absent/malformed (per spec, an invalid header is
    IGNORED — the edge then starts a fresh trace, never 400s)."""
    if not header or not isinstance(header, str):
        return None
    parts = header.strip().lower().split("-")
    if len(parts) < 4:
        return None
    version, trace_id, span_id = parts[0], parts[1], parts[2]
    if len(version) != 2 or not _is_hex(version) or version == "ff":
        return None
    if len(trace_id) != 32 or not _is_hex(trace_id) \
            or trace_id == "0" * 32:
        return None
    if len(span_id) != 16 or not _is_hex(span_id) \
            or span_id == "0" * 16:
        return None
    if len(parts[3]) != 2 or not _is_hex(parts[3]):
        return None
    return trace_id, span_id


def format_traceparent(trace_id, span_id=None, sampled=True):
    """Render a `traceparent` header value for `trace_id` (a fresh
    span id is minted when none is given)."""
    flags = "01" if sampled else "00"
    return f"00-{trace_id}-{span_id or new_span_id()}-{flags}"


class RequestTrace:
    """One request's event timeline. Events are dicts with at least
    {"event", "ts"}; dispatch events carry "dur" (seconds) and counts.
    `status` is None while live, then finished/cancelled/rejected.

    `trace_id` is the W3C id correlating this timeline across hops
    (minted here when the caller has none). `phases` accumulates the
    TTFT phase budget (phase name -> total seconds); a migrated
    request's continuation is seeded with both so the stitched trace
    reads as ONE request, not two."""

    __slots__ = ("request_id", "engine", "t_begin", "t_end", "status",
                 "events", "attrs", "trace_id", "phases")

    def __init__(self, request_id, engine="", trace_id=None,
                 t_begin=None, phases=None, **attrs):
        self.request_id = request_id
        self.engine = str(engine)
        self.trace_id = trace_id or new_trace_id()
        self.t_begin = now()
        self.t_end = None
        self.status = None
        self.attrs = attrs
        self.phases = dict(phases) if phases else {}
        self.events = [{"event": "enqueued", "ts": self.t_begin}]
        if t_begin is not None:
            # continuation of a migrated/re-homed timeline: keep the
            # ORIGINAL start so queue->finish reads as one lifetime
            self.t_begin = float(t_begin)
            self.events[0]["ts"] = self.t_begin
            self.events[0]["resumed_at"] = now()

    def to_dict(self):
        out = {"request_id": self.request_id, "engine": self.engine,
               "trace_id": self.trace_id,
               "t_begin": self.t_begin, "t_end": self.t_end,
               "status": self.status, "phases": dict(self.phases),
               "events": list(self.events)}
        if self.attrs:
            out.update(self.attrs)
        return out


class RequestTraceLog:
    """Bounded ring of request timelines (live + most recent finished).

    The engine drives it: begin() at submit, event() per lifecycle
    step, end() at the terminal event. Keys are (engine, request_id) so
    multiple engines (and a request id reused across engines) never
    collide. Thread-safe; disabled() turns every call into a no-op for
    A/B overhead runs."""

    def __init__(self, capacity=512):
        self._lock = threading.Lock()
        self._live = {}                       # (engine, id) -> trace
        self._done = deque(maxlen=int(capacity))
        self._hooks = []
        self.enabled = True

    # -- recording ---------------------------------------------------------
    def begin(self, request_id, engine="", trace_id=None, t_begin=None,
              phases=None, **attrs):
        """Open a timeline. `trace_id`/`t_begin`/`phases` stitch a
        migrated request's continuation onto its original trace
        (export_requests packs them, adopt passes them back)."""
        if not self.enabled:
            return None
        tr = RequestTrace(request_id, engine, trace_id=trace_id,
                          t_begin=t_begin, phases=phases, **attrs)
        with self._lock:
            self._live[(tr.engine, request_id)] = tr
        self._fire(tr, tr.events[0])
        return tr

    def phase(self, request_id, engine="", phase="", dur=0.0, **attrs):
        """Record one TTFT phase span (name MUST be in `PHASES` —
        a typo'd phase would otherwise vanish silently into the ring)
        and accumulate it into the trace's phase budget."""
        if phase not in PHASES:
            raise ValueError(f"unknown phase {phase!r} (declared: "
                             f"{', '.join(PHASES)})")
        if not self.enabled:
            return None
        dur = max(float(dur), 0.0)
        ev = dict(event="phase", phase=phase, ts=now(), dur=dur, **attrs)
        with self._lock:
            tr = self._live.get((str(engine), request_id))
            if tr is None:
                return None
            tr.phases[phase] = tr.phases.get(phase, 0.0) + dur
            tr.events.append(ev)
        self._fire(tr, ev)
        return ev

    def live_trace(self, request_id, engine=""):
        """The live RequestTrace for (engine, request_id), or None —
        export_requests reads trace_id/t_begin/phases off it to pack
        the stitch context onto the migrating Request."""
        with self._lock:
            return self._live.get((str(engine), request_id))

    def event(self, request_id, engine="", event="", **attrs):
        if not self.enabled:
            return None
        ev = dict(event=event, ts=now(), **attrs)
        with self._lock:
            tr = self._live.get((str(engine), request_id))
            if tr is None:
                return None
            tr.events.append(ev)
        self._fire(tr, ev)
        return ev

    def end(self, request_id, engine="", status="finished", **attrs):
        """Terminal event: stamps `status`, moves the trace to the done
        ring. Unknown ids are ignored (e.g. trace ring cleared while
        the request was in flight)."""
        if not self.enabled:
            return None
        ev = dict(event=status, ts=now(), **attrs)
        with self._lock:
            tr = self._live.pop((str(engine), request_id), None)
            if tr is None:
                return None
            tr.events.append(ev)
            tr.status = status
            tr.t_end = ev["ts"]
            self._done.append(tr)
        self._fire(tr, ev)
        return tr

    def terminal(self, request_id, engine="", status="rejected", **attrs):
        """One-shot trace for a request that never got a timeline —
        e.g. a queue-full rejection: begin + terminal event in one call,
        so `/requests` shows rejected traffic, not just admitted."""
        if not self.enabled:
            return None
        tr = RequestTrace(request_id, engine, **attrs)
        tr.events.append(dict(event=status, ts=now()))
        tr.status = status
        tr.t_end = tr.events[-1]["ts"]
        with self._lock:
            self._done.append(tr)
        self._fire(tr, tr.events[-1])
        return tr

    # -- hooks (the flight recorder subscribes here) -----------------------
    def add_hook(self, fn):
        """fn(trace, event_dict) on every recorded event (exceptions
        swallowed — an observer must never break serving)."""
        with self._lock:
            if fn not in self._hooks:
                self._hooks.append(fn)

    def remove_hook(self, fn):
        with self._lock:
            if fn in self._hooks:
                self._hooks.remove(fn)

    def _fire(self, tr, ev):
        with self._lock:
            hooks = list(self._hooks)
        for fn in hooks:
            try:
                fn(tr, ev)
            except Exception:
                pass

    # -- views -------------------------------------------------------------
    def recent(self, n=50, include_live=True):
        """Most recent timelines as dicts, oldest first; live traces
        (no terminal event yet) ride at the end."""
        with self._lock:
            done = list(self._done)[-int(n):]
            live = sorted(self._live.values(),
                          key=lambda t: t.t_begin) if include_live else []
        return [t.to_dict() for t in done + live]

    @property
    def num_live(self):
        with self._lock:
            return len(self._live)

    def clear(self):
        with self._lock:
            self._live.clear()
            self._done.clear()


#: The process-global log every ServingEngine records into.
request_log = RequestTraceLog()

# stable perfetto track ids: request id -> tid, interned FIFO
_tids = {}
_tid_counter = itertools.count(1)
_tid_lock = threading.Lock()


def _tid(engine, request_id):
    key = (engine, request_id)
    with _tid_lock:
        t = _tids.get(key)
        if t is None:
            t = _tids[key] = next(_tid_counter)
            if len(_tids) > 4096:        # bound the intern table
                _tids.pop(next(iter(_tids)))
        return t


def _us(t):
    return t * 1e6


def chrome_trace(last_ms=None, requests=None, spans=None, max_requests=512):
    """Export request timelines + telemetry spans as a Chrome
    `trace_event` JSON object (the dict; json.dump it yourself or hit
    the live server's `/trace`). Loads directly in ui.perfetto.dev.

    Layout: one perfetto *process* per engine (pid = engine ordinal +
    1), one *track* per request (its whole lifetime is an "X" slice;
    queued/prefill/decode/verify phases nest inside it; terminal
    status is an instant event). Host `telemetry.span` ranges ride in
    pid 0 ("host spans"), one track per OS thread. `last_ms` keeps
    only events ending in the trailing window.
    """
    if requests is None:
        requests = request_log.recent(max_requests)
    if spans is None:
        from .tracing import events as _span_events
        spans = _span_events()
    cutoff = None if last_ms is None else now() - last_ms / 1e3
    out = []
    procs = {}                 # pid -> process_name
    seen_tracks = set()        # (pid, tid) -> thread_name emitted

    def emit_meta(pid, tid, pname, tname):
        if pid not in procs:
            procs[pid] = pname
            out.append({"name": "process_name", "ph": "M", "pid": pid,
                        "tid": 0, "args": {"name": pname}})
        if (pid, tid) not in seen_tracks:
            seen_tracks.add((pid, tid))
            out.append({"name": "thread_name", "ph": "M", "pid": pid,
                        "tid": tid, "args": {"name": tname}})
            out.append({"name": "thread_sort_index", "ph": "M",
                        "pid": pid, "tid": tid,
                        "args": {"sort_index": tid}})

    for tr in requests:
        t_end = tr["t_end"] if tr["t_end"] is not None else now()
        if cutoff is not None and t_end < cutoff:
            continue
        try:
            pid = int(tr["engine"]) + 1
        except (TypeError, ValueError):
            pid = 1
        tid = _tid(tr["engine"], tr["request_id"])
        emit_meta(pid, tid, f"engine {tr['engine']}",
                  f"req {tr['request_id']}")
        args = {k: v for k, v in tr.items() if k not in
                ("events", "t_begin", "t_end")}
        out.append({"name": "request", "cat": "request", "ph": "X",
                    "ts": _us(tr["t_begin"]),
                    "dur": max(_us(t_end - tr["t_begin"]), 0.0),
                    "pid": pid, "tid": tid, "args": args})
        prev_ts = tr["t_begin"]
        for ev in tr["events"]:
            if cutoff is not None and ev["ts"] < cutoff:
                # keep the window export O(window), not O(history):
                # a long-lived request's old dispatches stay out, its
                # lifetime slice still spans the track
                if "dur" not in ev:
                    prev_ts = ev["ts"]
                continue
            name = ev["event"]
            eargs = {k: v for k, v in ev.items()
                     if k not in ("event", "ts", "dur")}
            if name == "enqueued":
                continue           # its span is the queued→admitted gap
            if name == "admitted":
                out.append({"name": "queued", "cat": "queue", "ph": "X",
                            "ts": _us(tr["t_begin"]),
                            "dur": max(_us(ev["ts"] - tr["t_begin"]), 0.0),
                            "pid": pid, "tid": tid, "args": eargs})
            elif "dur" in ev:      # prefill / decode / verify / phase spans
                dur = max(float(ev["dur"]), 0.0)
                ts0 = max(ev["ts"] - dur, prev_ts)
                cat = "dispatch"
                if name == "phase":
                    # TTFT phase-budget span: named slice on the
                    # request track so the waterfall reads directly
                    name = ev.get("phase", "phase")
                    cat = "phase"
                    eargs.pop("phase", None)
                out.append({"name": name, "cat": cat, "ph": "X",
                            "ts": _us(ts0),
                            "dur": _us(min(dur, t_end - ts0)),
                            "pid": pid, "tid": tid, "args": eargs})
            else:                  # instants: prefix_match, terminal, …
                out.append({"name": name, "cat": "lifecycle", "ph": "i",
                            "ts": _us(min(ev["ts"], t_end)), "s": "t",
                            "pid": pid, "tid": tid, "args": eargs})
            prev_ts = ev["ts"] if "dur" not in ev else prev_ts
    for ev in spans:
        if cutoff is not None and ev["ts"] < cutoff:
            continue
        tid = ev.get("thread", 0) % 100000
        emit_meta(0, tid, "host spans", f"thread {tid}")
        dur = max(float(ev.get("dur", 0.0)), 0.0)
        args = {k: v for k, v in ev.items()
                if k not in ("name", "ts", "dur", "thread")}
        out.append({"name": ev["name"], "cat": "span", "ph": "X",
                    "ts": _us(ev["ts"] - dur), "dur": _us(dur),
                    "pid": 0, "tid": tid, "args": args})
    out.sort(key=lambda e: (0 if e["ph"] == "M" else 1,
                            e.get("ts", 0.0)))
    return {"traceEvents": out, "displayTimeUnit": "ms",
            "otherData": {"exporter": "mx.telemetry.chrome_trace",
                          "clock": "perf_counter re-anchored to unix"}}
