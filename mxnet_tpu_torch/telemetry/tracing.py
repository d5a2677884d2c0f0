"""Lightweight span tracing: nesting, JSONL event log, profiler interplay.

Counterpart of mxnet_tpu/telemetry/tracing.py. `span(name)` is a
context manager that (a) nests via a thread-local stack, (b) records
its duration into the labeled `span_duration_seconds{name=...}`
histogram, (c) appends a structured event to an in-process ring buffer
(and, when `enable_jsonl(path)` is armed, to a JSON-lines file), and
(d) forwards into `torch.profiler.record_function` — but ONLY while a
`torch.profiler` session is recording, so spans appear in the traces
that session takes without paying for a profiler range (or importing
torch at all) otherwise. The reference forwards to
`jax.profiler.TraceAnnotation` under the same gate.

Event schema (one JSON object per line):
    {"name", "ts" (unix seconds at exit), "dur" (seconds), "depth",
     "parent" (enclosing span name or null), "thread", ...attrs}

A span exited by a raising block records `status="error"` plus the
exception type under `"error"` — the exception itself propagates
untouched (`__exit__` returns False). Observers can subscribe to every
finished span with `add_event_hook(fn)` (the flight recorder's feed);
hook exceptions are swallowed, an observer must never break the host.
"""
from __future__ import annotations

import json
import sys
import threading
import time
from collections import deque

__all__ = ["span", "events", "clear_events", "enable_jsonl",
           "disable_jsonl", "add_event_hook", "remove_event_hook"]

_tls = threading.local()
_events_lock = threading.Lock()
_events = deque(maxlen=4096)
_jsonl = {"fh": None, "path": None}
_event_hooks = []


def _span_hist():
    # late import: instruments ↔ tracing have no cycle, but the default
    # registry lives in the package __init__ which imports this module
    from . import histogram
    return histogram("span_duration_seconds",
                     "wall time of telemetry.span ranges",
                     labelnames=("name",))


def _device_trace_running():
    """True while a torch.profiler session records (torch's own flag;
    a process that never imported torch never asks it)."""
    torch = sys.modules.get("torch")
    if torch is None:
        return False
    try:
        return bool(torch.autograd.profiler._is_profiler_enabled)
    except AttributeError:
        return False


def _stack():
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


class span:
    """with span("serving.decode_block", slot=3): ..."""

    __slots__ = ("name", "attrs", "_ann", "_t0", "_parent", "_depth")

    def __init__(self, name, **attrs):
        self.name = name
        self.attrs = attrs
        self._ann = None

    def __enter__(self):
        st = _stack()
        self._parent = st[-1].name if st else None
        self._depth = len(st)
        st.append(self)
        if _device_trace_running():
            import torch
            self._ann = torch.profiler.record_function(self.name)
            self._ann.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        dur = time.perf_counter() - self._t0
        if self._ann is not None:
            self._ann.__exit__(exc_type, exc_val, exc_tb)
            self._ann = None
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        _span_hist().labels(self.name).observe(dur)
        ev = {"name": self.name, "ts": time.time(), "dur": dur,
              "depth": self._depth, "parent": self._parent,
              "thread": threading.get_ident()}
        if exc_type is not None:
            # a raising block still records its span — tagged, so the
            # event log shows WHERE the stack unwound, not a silent gap
            ev["status"] = "error"
            ev["error"] = exc_type.__name__
        if self.attrs:
            ev.update(self.attrs)
        with _events_lock:
            _events.append(ev)
            fh = _jsonl["fh"]
            if fh is not None:
                try:
                    fh.write(json.dumps(ev) + "\n")
                    fh.flush()
                except Exception:
                    pass           # a full disk must not break serving
            hooks = list(_event_hooks)
        for fn in hooks:
            try:
                fn(ev)
            except Exception:
                pass               # observers must never break the host
        return False


def events():
    """The in-process span ring buffer (most recent 4096), oldest first."""
    with _events_lock:
        return list(_events)


def clear_events():
    with _events_lock:
        _events.clear()


def enable_jsonl(path):
    """Start appending every finished span to `path` as JSON lines."""
    with _events_lock:
        if _jsonl["fh"] is not None:
            _jsonl["fh"].close()
        _jsonl["fh"] = open(path, "a")
        _jsonl["path"] = path
    return path


def disable_jsonl():
    with _events_lock:
        if _jsonl["fh"] is not None:
            _jsonl["fh"].close()
        _jsonl["fh"] = None
        _jsonl["path"] = None


def add_event_hook(fn):
    """Call fn(event_dict) on every finished span (the flight
    recorder's subscription point). Exceptions in fn are swallowed."""
    with _events_lock:
        if fn not in _event_hooks:
            _event_hooks.append(fn)


def remove_event_hook(fn):
    with _events_lock:
        if fn in _event_hooks:
            _event_hooks.remove(fn)
