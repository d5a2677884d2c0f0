"""Anomaly-triggered flight recorder.

A copy of mxnet_tpu/telemetry/flight.py (stdlib only; the port keeps
its own so that it never imports the JAX package). In the port a
"compile" is a kernel library build or load (ops/_build.py), and the
retrace-storm detector latches on one after an engine's mark_warm().

A black box for the serving/training process: a fixed-size ring of
recent telemetry events (span exits + request lifecycle events + any
`record()`ed breadcrumbs) plus a watchdog thread, and on an anomaly an
**atomic, once-per-trigger dump** of everything an offline triage
needs (docs/OBSERVABILITY.md "Flight recorder"):

    <out_dir>/<reason>-<timestamp>/
        events.jsonl     the ring, oldest first
        metrics.json     full registry snapshot
        state.json       trigger reason/detail, component status
                         (engine config, slot map, queue), recent
                         request timelines

Dumps are staged in a `.tmp` sibling and os.rename()d into place, so
a reader never sees a half-written directory. Each trigger *reason*
latches after its first dump — a stalled loop or a NaN storm fires
once, not once per watchdog tick — until `rearm()`.

Built-in detectors (all opt-in via `install()`):
  * **stall** — a watched component reports (progress, busy); busy
    with frozen progress past `stall_timeout` seconds trips
    `stall:<name>`. ServingEngine registers itself: progress is its
    dispatch/finish counter sum, busy is `scheduler.has_work`.
  * **queue-full storm** — `note_queue_full()` timestamps (the engine
    calls it on every QueueFullError); more than
    `queue_full_threshold` within `queue_full_window` seconds trips
    `queue_full:<name>`.
  * **non-finite grads** — `gluon.trainer` (sentinel armed by
    `install(watch_trainer=True)`) checks the global gradient norm
    each step and trips `trainer_nonfinite` on NaN/Inf (a NaN loss
    backpropagates NaN into every gradient, so this catches NaN loss
    without seeing the loss).
  * **retrace storms** — the recorder subscribes to `telemetry.cost`'s
    compile hook: every compile becomes a ring breadcrumb, and a
    compile flagged *steady* (the owning engine declared warmup over
    via `mark_warm()` yet a program still compiled inside the dispatch
    loop) trips `retrace_storm:<program key>` with the offending
    program signature in the dump detail.

Stdlib only; never imports jax.
"""
from __future__ import annotations

import json
import os
import threading
import time
import weakref
from collections import deque

__all__ = ["FlightRecorder", "install", "uninstall", "get", "record",
           "trigger", "note_queue_full", "note_shed",
           "trainer_sentinel_enabled", "latched_reasons", "watch",
           "unwatch"]

_recorder = None
_lock = threading.Lock()

# Stall-watch probes live at MODULE level so a component can register
# at construction time and a recorder installed later still sees it
# (and an uninstall/reinstall keeps the probes). Values are weak for
# bound methods — a collected engine drops out silently.
_watches = {}              # name -> weak ref / thunk returning probe


def watch(name, probe):
    """Register `probe() -> (progress, busy)` for stall detection:
    `progress` must move while `busy` is True, else an armed recorder
    trips `stall:<name>` after its stall_timeout. Bound methods are
    weakly held."""
    if hasattr(probe, "__self__"):
        ref = weakref.WeakMethod(probe)
    else:
        ref = lambda p=probe: p                           # noqa: E731
    _watches[str(name)] = ref


def unwatch(name):
    _watches.pop(str(name), None)


class FlightRecorder:
    def __init__(self, out_dir="flight_dumps", capacity=4096,
                 stall_timeout=30.0, poll_interval=None,
                 queue_full_threshold=64, queue_full_window=1.0,
                 watch_trainer=False):
        self.out_dir = str(out_dir)
        self.stall_timeout = float(stall_timeout)
        self.queue_full_threshold = int(queue_full_threshold)
        self.queue_full_window = float(queue_full_window)
        self.watch_trainer = bool(watch_trainer)
        self._ring = deque(maxlen=int(capacity))
        self._ring_lock = threading.Lock()
        self._fired = set()            # latched reasons
        self._fired_lock = threading.Lock()
        self._watch_state = {}         # name -> {progress, since}
        self._queue_full = {}          # name -> deque of timestamps
        self._dumps = []               # paths written, oldest first
        from . import counter
        self._dump_counter = counter(
            "flight_dumps_total",
            "flight-recorder dumps written", labelnames=("reason",))
        self._event_counter = counter(
            "flight_ring_events_total",
            "events captured into the flight ring")
        # subscribe to both telemetry event streams + compile events
        from . import cost, tracing
        from .request_trace import request_log
        self._span_hook = lambda ev: self.record("span", **ev)
        self._req_hook = lambda tr, ev: self.record(
            "request", request_id=tr.request_id, engine=tr.engine, **ev)
        tracing.add_event_hook(self._span_hook)
        request_log.add_hook(self._req_hook)
        self._compile_hook = self._on_compile
        cost.add_compile_hook(self._compile_hook)
        self._poll = float(poll_interval if poll_interval is not None
                           else max(min(self.stall_timeout / 4, 1.0), 0.01))
        self._stop = threading.Event()
        self._watchdog = threading.Thread(
            target=self._watchdog_loop, name="mx-flight-watchdog",
            daemon=True)
        self._watchdog.start()

    # -- the ring ----------------------------------------------------------
    def record(self, kind, **attrs):
        """Append one breadcrumb to the ring (cheap: one lock + append)."""
        ev = dict(kind=kind, t=time.time(), **attrs)
        with self._ring_lock:
            self._ring.append(ev)
        self._event_counter.inc()

    def events(self):
        with self._ring_lock:
            return list(self._ring)

    # -- stall watch -------------------------------------------------------
    def _watchdog_loop(self):
        while not self._stop.wait(self._poll):
            now = time.monotonic()
            for name, ref in list(_watches.items()):
                st = self._watch_state.setdefault(
                    name, {"progress": None, "since": None})
                probe = ref()
                if probe is None:
                    _watches.pop(name, None)
                    continue
                try:
                    progress, busy = probe()
                except Exception:
                    continue
                if not busy or progress != st["progress"]:
                    st["progress"], st["since"] = progress, now
                    continue
                if st["since"] is not None and \
                        now - st["since"] > self.stall_timeout:
                    self.trigger(
                        f"stall:{name}",
                        {"stalled_for_s": round(now - st["since"], 3),
                         "progress": progress,
                         "stall_timeout_s": self.stall_timeout})

    # -- retrace storm (compile-after-warmup) ------------------------------
    def _on_compile(self, ev):
        """telemetry.cost compile hook: breadcrumb every compile; a
        compile the owner flagged as steady-state (shape churn inside
        the dispatch loop after warmup) latches `retrace_storm:<key>`
        with the offending program signature."""
        self.record("compile", program=ev.get("program"),
                    seconds=ev.get("seconds"),
                    steady=ev.get("steady", False))
        if ev.get("steady"):
            self.trigger(
                f"retrace_storm:{ev.get('program')}",
                {"program": ev.get("program"),
                 "compile_seconds": ev.get("seconds"),
                 "note": "a program compiled inside the dispatch loop "
                         "after its owner declared steady state — "
                         "unexpected shape churn"})

    # -- queue-full / shed storms ------------------------------------------
    def _note_storm(self, kind, name):
        """Shared rejection-storm detector: timestamp one event of
        `kind` for component `name`; trips `<kind>:<name>` when the
        trailing window fills past the threshold."""
        dq = self._queue_full.setdefault(
            (kind, name), deque(maxlen=self.queue_full_threshold))
        now = time.monotonic()
        dq.append(now)
        self.record(kind, component=name)
        if len(dq) == self.queue_full_threshold and \
                now - dq[0] <= self.queue_full_window:
            self.trigger(
                f"{kind}:{name}",
                {"rejections": len(dq),
                 "window_s": round(now - dq[0], 4),
                 "threshold": self.queue_full_threshold})

    def note_queue_full(self, name="engine"):
        """Timestamp one QueueFullError; trips `queue_full:<name>` when
        the trailing window fills past the threshold."""
        self._note_storm("queue_full", str(name))

    def note_shed(self, name="engine"):
        """Timestamp one policy shed (the engine calls it on every
        ShedError); trips `shed_storm:<name>` when the trailing window
        fills past the queue-full threshold — sustained shedding is the
        same anomaly class as a queue-full storm."""
        self._note_storm("shed_storm", str(name))

    # -- trigger + dump ----------------------------------------------------
    def trigger(self, reason, detail=None):
        """Dump ring + metrics + component state for `reason`. Latched:
        the first call per reason writes the dump and returns its path;
        repeats return None until `rearm(reason)`."""
        reason = str(reason)
        with self._fired_lock:
            if reason in self._fired:
                return None
            self._fired.add(reason)
        path = self._dump(reason, detail)
        self._dumps.append(path)
        self._dump_counter.labels(reason).inc()
        return path

    def rearm(self, reason=None):
        """Un-latch one reason (or all) so it can trigger again."""
        with self._fired_lock:
            if reason is None:
                self._fired.clear()
            else:
                self._fired.discard(str(reason))

    @property
    def dumps(self):
        return list(self._dumps)

    @property
    def latched(self):
        """Trigger reasons that have fired and not been rearm()ed —
        /healthz reports `degraded` while this is non-empty."""
        with self._fired_lock:
            return sorted(self._fired)

    def _dump(self, reason, detail):
        from . import snapshot
        from .request_trace import request_log
        from .server import collect_status

        safe = "".join(c if c.isalnum() or c in "-_" else "-"
                       for c in reason)
        stamp = time.strftime("%Y%m%d-%H%M%S", time.localtime())
        final = os.path.join(self.out_dir,
                             f"{safe}-{stamp}-{os.getpid()}")
        n = 0
        while os.path.exists(final):           # same reason+second
            n += 1
            final = f"{final}.{n}"
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        with open(os.path.join(tmp, "events.jsonl"), "w") as f:
            for ev in self.events():
                f.write(json.dumps(ev, default=str) + "\n")
        with open(os.path.join(tmp, "metrics.json"), "w") as f:
            json.dump({"ts": time.time(), "instruments": snapshot()},
                      f, indent=1, sort_keys=True, default=str)
        state = {"reason": reason, "detail": detail, "ts": time.time(),
                 "pid": os.getpid(),
                 "components": collect_status(),
                 "requests": request_log.recent(64)}
        with open(os.path.join(tmp, "state.json"), "w") as f:
            json.dump(state, f, indent=1, sort_keys=True, default=str)
        os.rename(tmp, final)                  # atomic publish
        return final

    # -- lifecycle ---------------------------------------------------------
    def close(self):
        self._stop.set()
        self._watchdog.join(timeout=5)
        from . import cost, tracing
        from .request_trace import request_log
        tracing.remove_event_hook(self._span_hook)
        request_log.remove_hook(self._req_hook)
        cost.remove_compile_hook(self._compile_hook)


# -- module-level singleton (what the engine/trainer hooks talk to) --------

def install(**kw):
    """Create and arm the process flight recorder (replaces any prior
    one). See FlightRecorder for the knobs."""
    global _recorder
    with _lock:
        if _recorder is not None:
            _recorder.close()
        _recorder = FlightRecorder(**kw)
        return _recorder


def uninstall():
    global _recorder
    with _lock:
        rec, _recorder = _recorder, None
    if rec is not None:
        rec.close()


def get():
    return _recorder


def record(kind, **attrs):
    """Breadcrumb into the ring; no-op when no recorder is armed."""
    rec = _recorder
    if rec is not None:
        rec.record(kind, **attrs)


def trigger(reason, detail=None):
    rec = _recorder
    return rec.trigger(reason, detail) if rec is not None else None


def note_queue_full(name="engine"):
    rec = _recorder
    if rec is not None:
        rec.note_queue_full(name)


def note_shed(name="engine"):
    rec = _recorder
    if rec is not None:
        rec.note_shed(name)


def latched_reasons():
    """Latched trigger reasons of the armed recorder ([] when none) —
    the /healthz degraded probe."""
    rec = _recorder
    return rec.latched if rec is not None else []


def trainer_sentinel_enabled():
    """True when an armed recorder asked for trainer NaN/Inf checks —
    the per-step gradient-norm fetch only happens then."""
    rec = _recorder
    return rec is not None and rec.watch_trainer
