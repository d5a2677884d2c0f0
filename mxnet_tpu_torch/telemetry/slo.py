"""mx.telemetry.slo — declarative SLOs on multi-window burn rates.

A copy of mxnet_tpu/telemetry/slo.py (stdlib only; the port keeps its
own so that it never imports the JAX package).

An `SLO` names an objective over the serving stream — a TTFT latency
bound (`ttft_p99_ms`: the target fraction of requests must see first
token under the bound) and/or a per-request decode goodput floor
(`goodput_min`, tokens/s) — optionally split `per` request dimension
(priority and/or tenant), so one declaration yields one burn-rate
series per label value.

Evaluation is the Google SRE workbook's multi-window multi-burn-rate
scheme: each observation is classified good/bad against the objective,
and the **burn rate** over a trailing window is

    burn = bad_fraction(window) / (1 - target)

i.e. the rate at which the error budget is being consumed (1.0 =
exactly sustainable; 14.4 over 1 minute ≈ "2% of a 30-day budget in an
hour" — page territory). Two windows are kept per series: a FAST one
(default 60 s) that reacts to incidents, and a SLOW one (default
600 s) that suppresses blips. `fast_burning` — fast burn over its
threshold — is the actionable signal: it latches a flight-recorder
dump (`slo_burn:<objective>`, once per objective until rearmed) and
`SheddingPolicy(slo=...)` counts it toward the overload level.

The process-global `slo_engine` is fed by every ServingEngine
(`observe_ttft` at first token, `observe_goodput` at finish) exactly
like `request_log`; with no objectives configured every observe is a
cheap no-op, which is the A/B-overhead baseline. `/sloz` on the live
server serves `snapshot()`.

Zero heavy dependencies: stdlib only, like the rest of `mx.telemetry`.
"""
from __future__ import annotations

import threading
import time
from collections import deque

from . import flight as _flight

__all__ = ["SLO", "SLOEngine", "slo_engine", "configure",
           "observe_ttft", "observe_goodput", "snapshot",
           "fast_burning"]

_DIMS = ("priority", "tenant")     # the request dimensions `per` may name


class SLO:
    """One declarative objective.

    name: label the burn series / flight dumps / `/sloz` report use.
    ttft_p99_ms: first-token latency bound — an observed TTFT above it
        is a bad event. goodput_min: per-request decode goodput floor
        (tokens/s) — a finished request below it is a bad event. At
        least one must be set; both may be.
    target: the good fraction the objective promises (0.99 = 1% error
        budget). per: iterable of request dimensions ("priority",
        "tenant") to split the series by.
    fast_window_s / slow_window_s: the two trailing windows.
    fast_burn / slow_burn: burn-rate thresholds per window; the fast
        one is the paging/shedding/flight signal.
    min_events: observations a window needs before it is trusted —
        burn reads 0.0 below it (a single early failure must not page).
    """

    def __init__(self, name, ttft_p99_ms=None, goodput_min=None,
                 target=0.99, per=(), fast_window_s=60.0,
                 slow_window_s=600.0, fast_burn=14.0, slow_burn=2.0,
                 min_events=10):
        if ttft_p99_ms is None and goodput_min is None:
            raise ValueError("SLO needs ttft_p99_ms and/or goodput_min")
        if not 0.0 < float(target) < 1.0:
            raise ValueError("target must be in (0, 1)")
        per = tuple(per)
        for d in per:
            if d not in _DIMS:
                raise ValueError(f"unknown SLO dimension {d!r} "
                                 f"(allowed: {', '.join(_DIMS)})")
        self.name = str(name)
        self.ttft_p99_ms = None if ttft_p99_ms is None \
            else float(ttft_p99_ms)
        self.goodput_min = None if goodput_min is None \
            else float(goodput_min)
        self.target = float(target)
        self.per = per
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.fast_burn = float(fast_burn)
        self.slow_burn = float(slow_burn)
        self.min_events = int(min_events)

    def key_of(self, priority=None, tenant=None):
        """The series key for one observation's label values."""
        vals = {"priority": priority, "tenant": tenant}
        return tuple((d, str(vals[d])) for d in self.per)


class _Series:
    """One (objective, label-key) observation ring: (ts, good) pairs,
    bounded by the slow window at eviction time."""

    __slots__ = ("events", "good_total", "bad_total")

    def __init__(self):
        self.events = deque()
        self.good_total = 0
        self.bad_total = 0

    def add(self, ts, good):
        self.events.append((ts, bool(good)))
        if good:
            self.good_total += 1
        else:
            self.bad_total += 1

    def prune(self, horizon):
        ev = self.events
        while ev and ev[0][0] < horizon:
            ev.popleft()

    def window(self, t_now, window_s):
        """(events, bad) inside the trailing window."""
        lo = t_now - window_s
        n = bad = 0
        for ts, good in reversed(self.events):
            if ts < lo:
                break
            n += 1
            if not good:
                bad += 1
        return n, bad


def _burn(n, bad, budget, min_events):
    if n < min_events:
        return 0.0
    return (bad / n) / budget


class SLOEngine:
    """Evaluates a set of `SLO` objectives over observed events.

    clock: injectable (engine-style) for tests; default perf_counter.
    The burn-rate math only ever sees THIS clock, so hand-driven
    clocks give exact window arithmetic.

    metrics: optional {"events": Counter, "burn": Gauge, "burning":
    Gauge} to publish into, replacing the default `slo_*` families —
    the fleet collector injects literally-declared `slo_fleet_*`
    instruments so per-process and fleet-wide burn never share a
    series. on_fast_burn: optional `fn(objective_name, detail)`
    replacing the default flight-recorder trigger on a fresh fast
    burn — the fleet engine routes this into the correlated fleet
    dump instead of the local process's recorder.
    """

    def __init__(self, objectives=(), clock=None, metrics=None,
                 on_fast_burn=None):
        self._lock = threading.Lock()
        self._clock = clock if clock is not None else time.perf_counter
        self._objectives = []
        self._series = {}          # (name, key) -> _Series
        self._burning = set()      # objective names fast-burning now
        self._metrics = dict(metrics) if metrics is not None else None
        self._on_fast_burn = on_fast_burn
        self.configure(objectives)

    # -- setup -------------------------------------------------------------
    def configure(self, objectives, clock=None):
        """Replace the objective set (and optionally the clock);
        clears every observation series."""
        with self._lock:
            self._objectives = list(objectives)
            self._series = {}
            self._burning = set()
            if clock is not None:
                self._clock = clock

    def clear(self):
        """Drop observations + burning state; objectives survive
        (telemetry.reset() calls this)."""
        with self._lock:
            self._series = {}
            self._burning = set()

    @property
    def objectives(self):
        with self._lock:
            return list(self._objectives)

    def _families(self):
        # lazy: mx.telemetry must stay importable backend-free and the
        # registry is only touched once an objective actually observes
        if self._metrics is None:
            from . import counter, gauge
            self._metrics = {
                "events": counter(
                    "slo_events_total",
                    "SLO observations classified against each "
                    "objective (verdict=good|bad)",
                    ("objective", "verdict")),
                "burn": gauge(
                    "slo_burn_rate",
                    "error-budget burn rate per objective and window "
                    "(1.0 = consuming exactly the budget; worst "
                    "series when the objective is split per-dimension)",
                    ("objective", "window")),
                "burning": gauge(
                    "slo_fast_burning",
                    "1 while the objective's fast-window burn rate is "
                    "at/over its threshold, else 0",
                    ("objective",)),
            }
        return self._metrics

    # -- observation -------------------------------------------------------
    def observe_ttft(self, ttft_s, priority=None, tenant=None, t=None):
        """Classify one first-token latency against every TTFT
        objective. No-op (one attribute read) with none configured.
        `t` backdates the observation onto the engine's clock axis —
        the fleet collector stamps aligned event times so its burn
        windows stay exact under scrape lag."""
        if not self._objectives:
            return
        ms = float(ttft_s) * 1e3
        self._observe("ttft_p99_ms", lambda slo: ms <= slo.ttft_p99_ms,
                      priority, tenant, t)

    def observe_goodput(self, tokens_per_s, priority=None, tenant=None,
                        t=None):
        """Classify one finished request's decode goodput against
        every goodput objective."""
        if not self._objectives:
            return
        rate = float(tokens_per_s)
        self._observe("goodput_min", lambda slo: rate >= slo.goodput_min,
                      priority, tenant, t)

    def _observe(self, field, is_good, priority, tenant, t=None):
        t = self._clock() if t is None else float(t)
        fams = self._families()
        with self._lock:
            for slo in self._objectives:
                if getattr(slo, field) is None:
                    continue
                good = bool(is_good(slo))
                key = (slo.name, slo.key_of(priority, tenant))
                s = self._series.get(key)
                if s is None:
                    s = self._series[key] = _Series()
                s.add(t, good)
                s.prune(t - slo.slow_window_s)
                fams["events"].labels(
                    slo.name, "good" if good else "bad").inc()

    # -- evaluation --------------------------------------------------------
    def evaluate(self, t_now=None):
        """Burn rates for every (objective, series): list of dicts.
        Publishes the worst-series gauges per objective and latches a
        `slo_burn:<objective>` flight dump the moment an objective's
        fast burn crosses its threshold (once, until flight rearms)."""
        if t_now is None:
            t_now = self._clock()
        out = []
        newly = []
        fams = self._families() if self._objectives else None
        with self._lock:
            for slo in self._objectives:
                budget = 1.0 - slo.target
                worst_fast = worst_slow = 0.0
                found = False
                for (name, key), s in self._series.items():
                    if name != slo.name:
                        continue
                    found = True
                    nf, bf = s.window(t_now, slo.fast_window_s)
                    ns, bs = s.window(t_now, slo.slow_window_s)
                    fast = _burn(nf, bf, budget, slo.min_events)
                    slow = _burn(ns, bs, budget, slo.min_events)
                    worst_fast = max(worst_fast, fast)
                    worst_slow = max(worst_slow, slow)
                    out.append({
                        "objective": slo.name,
                        "labels": dict(key),
                        "fast": {"window_s": slo.fast_window_s,
                                 "events": nf, "bad": bf,
                                 "burn_rate": fast},
                        "slow": {"window_s": slo.slow_window_s,
                                 "events": ns, "bad": bs,
                                 "burn_rate": slow},
                        "fast_burning": fast >= slo.fast_burn,
                        "slow_burning": slow >= slo.slow_burn,
                    })
                if not found:
                    out.append({"objective": slo.name, "labels": {},
                                "fast": {"window_s": slo.fast_window_s,
                                         "events": 0, "bad": 0,
                                         "burn_rate": 0.0},
                                "slow": {"window_s": slo.slow_window_s,
                                         "events": 0, "bad": 0,
                                         "burn_rate": 0.0},
                                "fast_burning": False,
                                "slow_burning": False})
                burning = worst_fast >= slo.fast_burn
                if fams is not None:
                    fams["burn"].labels(slo.name, "fast").set(worst_fast)
                    fams["burn"].labels(slo.name, "slow").set(worst_slow)
                    fams["burning"].labels(slo.name).set(
                        1.0 if burning else 0.0)
                if burning and slo.name not in self._burning:
                    newly.append((slo.name, worst_fast, worst_slow))
                if burning:
                    self._burning.add(slo.name)
                else:
                    self._burning.discard(slo.name)
        for name, fast, slow in newly:
            # outside the lock: flight dumps walk telemetry state.
            # flight's own per-reason latch makes repeats no-ops until
            # the operator rearms, so a sustained burn dumps ONCE.
            detail = {"fast_burn": fast, "slow_burn": slow}
            if self._on_fast_burn is not None:
                try:
                    self._on_fast_burn(name, detail)
                except Exception:
                    pass           # a broken sink must not break eval
            else:
                _flight.trigger(f"slo_burn:{name}", detail)
        return out

    def fast_burning(self, t_now=None):
        """Names of objectives whose fast-window burn is at/over
        threshold — the SheddingPolicy overload input."""
        rows = self.evaluate(t_now)
        return sorted({r["objective"] for r in rows if r["fast_burning"]})

    def snapshot(self, t_now=None):
        """The `/sloz` payload: declared objectives + live burn rows."""
        rows = self.evaluate(t_now)
        decls = [{
            "name": s.name, "ttft_p99_ms": s.ttft_p99_ms,
            "goodput_min": s.goodput_min, "target": s.target,
            "per": list(s.per),
            "fast_window_s": s.fast_window_s,
            "slow_window_s": s.slow_window_s,
            "fast_burn": s.fast_burn, "slow_burn": s.slow_burn,
            "min_events": s.min_events,
        } for s in self.objectives]
        return {"objectives": decls, "series": rows,
                "fast_burning": sorted(
                    {r["objective"] for r in rows if r["fast_burning"]})}


#: The process-global SLO engine every ServingEngine observes into.
slo_engine = SLOEngine()


def configure(objectives, clock=None):
    """Replace the global engine's objectives (list of `SLO`)."""
    slo_engine.configure(objectives, clock=clock)


def observe_ttft(ttft_s, priority=None, tenant=None):
    slo_engine.observe_ttft(ttft_s, priority=priority, tenant=tenant)


def observe_goodput(tokens_per_s, priority=None, tenant=None):
    slo_engine.observe_goodput(tokens_per_s, priority=priority,
                               tenant=tenant)


def snapshot():
    return slo_engine.snapshot()


def fast_burning():
    return slo_engine.fast_burning()
