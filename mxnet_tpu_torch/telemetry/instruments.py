"""Zero-dependency, thread-safe metric instruments + registry.

A copy of mxnet_tpu/telemetry/instruments.py (pure Python; the port
keeps its own so that it never imports the JAX package).

The framework-wide observability core (docs/OBSERVABILITY.md): named
Counter/Gauge/Histogram instruments live in a process-global Registry and
are cheap enough for hot paths — one lock acquire and a few float ops per
record (~1 µs), against multi-millisecond dispatches. Pure stdlib:
importing this module touches neither torch nor the card.

Design notes:

  * Histograms are fixed-boundary with exponential buckets (default
    100 µs · 2^i — latency-shaped), so recording is O(log n_buckets) and
    memory is constant regardless of sample count; percentiles are
    estimated by linear interpolation inside the covering bucket
    (the prometheus histogram_quantile estimator), exact to one bucket's
    resolution.
  * Labels follow the prometheus child model: an instrument declared
    with `labelnames` is a parent; `.labels(v)` interns a child per
    label-value tuple. Serving uses this for per-engine children so
    `ServingEngine.stats` stays engine-local while the registry view
    aggregates.
  * `Registry.reset()` zeroes values IN PLACE (children keep their
    identity) — call sites may hold child references across a reset.
"""
from __future__ import annotations

import json
import math
import threading
import time

from ..base import MXNetError

__all__ = ["Counter", "Gauge", "Histogram", "Registry",
           "exponential_buckets", "DEFAULT_LATENCY_BUCKETS"]


def exponential_buckets(start, factor, count):
    """`count` ascending upper bounds: start, start·factor, …"""
    if start <= 0 or factor <= 1 or count < 1:
        raise MXNetError("exponential_buckets needs start>0, factor>1, "
                         "count>=1")
    return tuple(start * factor ** i for i in range(count))


# 100 µs .. ~105 s in ×2 steps — covers admission waits through drains
DEFAULT_LATENCY_BUCKETS = exponential_buckets(1e-4, 2.0, 21)


class _Instrument:
    """Base: name/help/labels bookkeeping shared by all three kinds."""

    kind = "untyped"

    def __init__(self, name, help="", labelnames=()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children = {}        # label-value tuple -> child instrument

    # -- labels ------------------------------------------------------------
    def labels(self, *values, **kw):
        """Child instrument for one label-value combination (interned)."""
        if not self.labelnames:
            raise MXNetError(f"instrument {self.name!r} declared no "
                             "labelnames")
        if kw:
            if values or set(kw) != set(self.labelnames):
                raise MXNetError(f"labels() for {self.name!r} needs exactly "
                                 f"{self.labelnames}")
            values = tuple(str(kw[k]) for k in self.labelnames)
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise MXNetError(f"{self.name!r} takes {len(self.labelnames)} "
                             f"label values, got {len(values)}")
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._make_child()
                self._children[values] = child
            return child

    def _make_child(self):
        raise NotImplementedError

    # -- lifecycle ---------------------------------------------------------
    def reset(self):
        with self._lock:
            children = list(self._children.values())
            self._reset_self()
        for c in children:
            c.reset()

    def _reset_self(self):
        raise NotImplementedError

    # -- snapshots ---------------------------------------------------------
    def snapshot(self):
        """JSON-able dict: own value and/or per-child values."""
        out = {"type": self.kind}
        if self.help:
            out["help"] = self.help
        if self.labelnames:
            out["labelnames"] = list(self.labelnames)
            with self._lock:
                items = list(self._children.items())
            out["children"] = [
                dict(zip(self.labelnames, vals), **child._value_snapshot())
                for vals, child in items]
        else:
            out.update(self._value_snapshot())
        return out

    def _value_snapshot(self):
        raise NotImplementedError

    def _samples(self):
        """[(label_values, child)] for exposition — self when unlabeled."""
        if self.labelnames:
            with self._lock:
                return list(self._children.items())
        return [((), self)]


class Counter(_Instrument):
    """Monotonic count. `inc()` only accepts non-negative deltas."""

    kind = "counter"

    def __init__(self, name, help="", labelnames=()):
        super().__init__(name, help, labelnames)
        self._value = 0.0

    def _make_child(self):
        return Counter(self.name, self.help)

    def inc(self, amount=1):
        if amount < 0:
            raise MXNetError(f"counter {self.name!r} cannot decrease")
        with self._lock:
            self._value += amount

    @property
    def value(self):
        with self._lock:
            return self._value

    def _reset_self(self):
        self._value = 0.0

    def _value_snapshot(self):
        return {"value": self.value}


class Gauge(_Instrument):
    """Point-in-time value; optionally backed by a callback evaluated at
    read time (`set_function`) — used for device-memory sampling."""

    kind = "gauge"

    def __init__(self, name, help="", labelnames=()):
        super().__init__(name, help, labelnames)
        self._value = 0.0
        self._fn = None

    def _make_child(self):
        return Gauge(self.name, self.help)

    def set(self, value):
        with self._lock:
            self._value = float(value)

    def inc(self, amount=1):
        with self._lock:
            self._value += amount

    def dec(self, amount=1):
        self.inc(-amount)

    def set_function(self, fn):
        """Evaluate fn() at every read — keeps sampling cost out of hot
        paths and inside snapshot()/render time."""
        with self._lock:
            self._fn = fn

    @property
    def value(self):
        with self._lock:
            fn = self._fn
            if fn is None:
                return self._value
        return float(fn())

    def _reset_self(self):
        self._value = 0.0

    def _value_snapshot(self):
        return {"value": self.value}


class Histogram(_Instrument):
    """Fixed-boundary histogram with an implicit +Inf overflow bucket.

    Records count/sum/min/max plus per-bucket counts; `observe(v, n)`
    folds n identical observations in one lock acquire (the serving
    engine uses this to attribute one decode dispatch's wall time to
    every token it emitted)."""

    kind = "histogram"

    def __init__(self, name, help="", labelnames=(), buckets=None):
        super().__init__(name, help, labelnames)
        self.buckets = tuple(sorted(buckets or DEFAULT_LATENCY_BUCKETS))
        if not self.buckets:
            raise MXNetError("histogram needs at least one bucket bound")
        self._counts = [0] * (len(self.buckets) + 1)   # last = +Inf
        self._sum = 0.0
        self._count = 0
        self._min = math.inf
        self._max = -math.inf

    def _make_child(self):
        return Histogram(self.name, self.help, buckets=self.buckets)

    def _bucket_index(self, v):
        lo, hi = 0, len(self.buckets)
        while lo < hi:                    # first bound >= v
            mid = (lo + hi) // 2
            if v <= self.buckets[mid]:
                hi = mid
            else:
                lo = mid + 1
        return lo

    def observe(self, value, count=1):
        if count < 1:
            return
        value = float(value)
        i = self._bucket_index(value)
        with self._lock:
            self._counts[i] += count
            self._sum += value * count
            self._count += count
            if value < self._min:
                self._min = value
            if value > self._max:
                self._max = value

    # -- derived stats -----------------------------------------------------
    @property
    def count(self):
        with self._lock:
            return self._count

    @property
    def sum(self):
        with self._lock:
            return self._sum

    def percentile(self, q):
        """Estimate the q-th percentile (0..100) by linear interpolation
        inside the covering bucket (histogram_quantile estimator). The
        result is exact to one bucket's width; min/max clamp the open
        first/last buckets.

        An EMPTY histogram returns `float("nan")` — the defined "no
        data" value (docs/OBSERVABILITY.md "Percentiles"): NaN
        propagates visibly through arithmetic instead of forging a
        plausible 0.0 latency, and `math.isnan` is the idiomatic probe.
        Snapshots and dashboards must therefore guard on `count` before
        formatting. q outside [0, 100] raises."""
        if not 0 <= q <= 100:
            raise MXNetError(
                f"percentile q must be in [0, 100], got {q!r}")
        with self._lock:
            counts = list(self._counts)
            total, mn, mx = self._count, self._min, self._max
        if total == 0:
            return math.nan
        target = q / 100.0 * total
        cum = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo = self.buckets[i - 1] if i > 0 else min(mn, self.buckets[0])
                hi = self.buckets[i] if i < len(self.buckets) else mx
                lo, hi = max(lo, mn), min(hi, mx)
                if hi <= lo:
                    return lo
                frac = (target - cum) / c
                return lo + frac * (hi - lo)
            cum += c
        return mx

    # -- merging -----------------------------------------------------------
    def merge(self, other):
        """Fold `other`'s observations into self, BUCKET-WISE: per-bucket
        counts add, sum/count add, min/max widen. This is the only
        correct way to combine histograms from different processes —
        averaging per-process percentiles is wrong the moment the
        processes saw different loads (docs/OBSERVABILITY.md "Fleet
        observability"; tests/test_telemetry.py proves it against a
        numpy oracle). Requires identical bucket boundaries."""
        if not isinstance(other, Histogram):
            raise MXNetError(f"cannot merge {type(other).__name__} into "
                             f"histogram {self.name!r}")
        if other.buckets != self.buckets:
            raise MXNetError(
                f"histogram merge for {self.name!r} needs identical "
                f"buckets: {len(self.buckets)} bounds vs "
                f"{len(other.buckets)}")
        with other._lock:
            counts = list(other._counts)
            o_sum, o_count = other._sum, other._count
            o_min, o_max = other._min, other._max
        with self._lock:
            for i, c in enumerate(counts):
                self._counts[i] += c
            self._sum += o_sum
            self._count += o_count
            if o_min < self._min:
                self._min = o_min
            if o_max > self._max:
                self._max = o_max
        return self

    @classmethod
    def from_cumulative(cls, bounds, cumulative, sum, count,
                        name="", help=""):
        """Reconstruct a Histogram from Prometheus exposition samples:
        `bounds` are the finite `le` bucket bounds (ascending, no +Inf)
        and `cumulative` the matching cumulative counts PLUS the final
        +Inf count (len(bounds) + 1 entries). min/max are synthesized
        from the outermost non-empty buckets — the exposition format
        does not carry them — so `percentile()` stays exact to one
        bucket's resolution on the reconstruction."""
        bounds = tuple(float(b) for b in bounds)
        if len(cumulative) != len(bounds) + 1:
            raise MXNetError(
                f"from_cumulative for {name!r}: {len(bounds)} bounds "
                f"need {len(bounds) + 1} cumulative counts, got "
                f"{len(cumulative)}")
        h = cls(name, help, buckets=bounds)
        prev = 0
        for i, cum in enumerate(cumulative):
            c = int(cum) - prev
            if c < 0:
                raise MXNetError(
                    f"from_cumulative for {name!r}: cumulative counts "
                    "must be non-decreasing")
            h._counts[i] = c
            prev = int(cum)
        h._count = int(count)
        h._sum = float(sum)
        if h._count:
            nonzero = [i for i, c in enumerate(h._counts) if c]
            lo_i, hi_i = nonzero[0], nonzero[-1]
            h._min = bounds[lo_i - 1] if lo_i > 0 else min(0.0, bounds[0])
            h._max = bounds[hi_i] if hi_i < len(bounds) else bounds[-1]
        return h

    def _reset_self(self):
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._count = 0
        self._min = math.inf
        self._max = -math.inf

    def _value_snapshot(self):
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
            mn, mx = self._min, self._max
        out = {"count": total, "sum": s,
               "buckets": {("%g" % b): c
                           for b, c in zip(self.buckets, counts)},
               "overflow": counts[-1]}
        if total:
            out.update(min=mn, max=mx, avg=s / total,
                       p50=self.percentile(50), p90=self.percentile(90),
                       p99=self.percentile(99))
        return out


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class Registry:
    """Name → instrument map with get-or-create semantics.

    Re-declaring a name returns the existing instrument; a kind or
    labelnames mismatch raises (two subsystems silently sharing one
    name with different meanings is the bug this catches)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments = {}
        self._collect_hooks = []

    # -- declaration -------------------------------------------------------
    def _declare(self, kind, name, help="", labelnames=(), **kw):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is not None:
                if inst.kind != kind or \
                        inst.labelnames != tuple(labelnames):
                    raise MXNetError(
                        f"instrument {name!r} already registered as "
                        f"{inst.kind}{inst.labelnames} — cannot redeclare "
                        f"as {kind}{tuple(labelnames)}")
                return inst
            inst = _KINDS[kind](name, help, labelnames=labelnames, **kw)
            self._instruments[name] = inst
            return inst

    def counter(self, name, help="", labelnames=()):
        return self._declare("counter", name, help, labelnames)

    def gauge(self, name, help="", labelnames=()):
        return self._declare("gauge", name, help, labelnames)

    def histogram(self, name, help="", labelnames=(), buckets=None):
        return self._declare("histogram", name, help, labelnames,
                             buckets=buckets)

    def get(self, name):
        with self._lock:
            return self._instruments.get(name)

    def add_collect_hook(self, fn):
        """fn() runs before every snapshot/render — opt-in samplers
        (device memory) hang here so hot paths never pay for them."""
        with self._lock:
            if fn not in self._collect_hooks:
                self._collect_hooks.append(fn)

    def _collect(self):
        with self._lock:
            hooks = list(self._collect_hooks)
        for fn in hooks:
            try:
                fn()
            except Exception:
                pass               # a broken sampler must not break reads

    # -- views -------------------------------------------------------------
    def snapshot(self):
        """{name: instrument snapshot} for every registered instrument."""
        self._collect()
        with self._lock:
            items = sorted(self._instruments.items())
        return {name: inst.snapshot() for name, inst in items}

    def render_prometheus(self):
        """Prometheus text exposition format (0.0.4)."""
        self._collect()
        with self._lock:
            items = sorted(self._instruments.items())
        lines = []
        for name, inst in items:
            if inst.help:
                lines.append(f"# HELP {name} {inst.help}")
            lines.append(f"# TYPE {name} {inst.kind}")
            for values, child in inst._samples():
                lab = ",".join(f'{k}="{v}"'
                               for k, v in zip(inst.labelnames, values))
                if inst.kind == "histogram":
                    with child._lock:
                        counts = list(child._counts)
                        total, s = child._count, child._sum
                    cum = 0
                    for b, c in zip(child.buckets + (math.inf,), counts):
                        cum += c
                        le = "+Inf" if b == math.inf else "%g" % b
                        sep = "," if lab else ""
                        lines.append(f'{name}_bucket{{{lab}{sep}le="{le}"}}'
                                     f" {cum}")
                    suffix = f"{{{lab}}}" if lab else ""
                    lines.append(f"{name}_sum{suffix} {s:g}")
                    lines.append(f"{name}_count{suffix} {total}")
                else:
                    suffix = f"{{{lab}}}" if lab else ""
                    lines.append(f"{name}{suffix} {child.value:g}")
        return "\n".join(lines) + "\n"

    def dump(self, path):
        """Write the snapshot as JSON; returns the path."""
        snap = {"ts": time.time(), "instruments": self.snapshot()}
        with open(path, "w") as f:
            json.dump(snap, f, indent=1, sort_keys=True)
        return path

    def reset(self):
        """Zero every instrument in place (tests; between bench rounds).
        Instrument and child identities survive — holders of references
        (e.g. a live ServingEngine) keep recording into the same
        objects."""
        with self._lock:
            insts = list(self._instruments.values())
        for inst in insts:
            inst.reset()
