"""FleetCollector: one metrics/trace/SLO view over the worker fleet.

Counterpart of mxnet_tpu/serving/fleet/observe.py. The fleet makes
serving a multi-process system; this module makes it ONE observable
system. A pull-based collector runs beside `FleetRouter`
and periodically scrapes every worker's `/metrics`, `/fleet/requests`,
`/fleet/sloz`, and `/fleet/flightz` over the existing control plane
(bounded per-RPC timeouts — a dead or wedged worker marks itself stale
via `fleet_scrape_errors_total{worker}` and NEVER blocks the loop),
then merges the answers into one registry with the correct aggregation
per instrument kind:

  * counters SUM across workers (the fleet emitted N tokens),
  * gauges stay PER-WORKER — `worker_id`/`role` labels are appended
    (a fleet-summed slot occupancy is meaningless),
  * histograms merge BUCKET-WISE via `Histogram.merge()` — never by
    averaging per-worker percentiles, which is wrong the moment two
    workers see different load.

On top of the merged view:

  * **cross-process trace assembly** — `fleet_chrome_trace()` gathers
    every worker's timeline ring, aligns each onto the collector's
    clock using the per-worker offset measured at scrape time (the
    worker answers its wall-anchored `now`; offset = worker_now minus
    the scrape round-trip midpoint), and emits one Perfetto file with
    one process track per worker pid. A disaggregated request's
    prefill → handoff → decode spans land on different process tracks
    under a single stitched trace_id.
  * a **fleet-global SLO engine** — a second `SLOEngine` fed from the
    merged first-token/finish event stream (deduplicated across
    scrapes and across workers, so a migrated request counts once),
    publishing `slo_fleet_*` instruments. TTFT p99 and goodput
    objectives are judged fleet-wide, not per process.
  * a **correlated fleet flight dump** — any worker's flight latch
    (mirrored from `/fleet/flightz`) or a fleet SLO fast burn latches
    ONE dump per reason: every worker's metrics + requests + flight
    state plus the merged registry, snapshotted into one directory
    with the same atomic .tmp → rename discipline as the per-process
    flight recorder.
  * the **/fleetz** payload (`fleetz()`), served by the router
    process's introspection server once the collector registers
    itself: per-worker health/role/weight_dtype/steady-compiles,
    fleet tokens/sec and tokens/sec/chip at the current merged TTFT
    p99, and scrape staleness.

Stdlib-only, like the rest of the control plane: the collector talks
HTTP to workers and touches no device.
"""
from __future__ import annotations

import itertools
import json
import math
import os
import re
import threading
import time

from ...base import MXNetError
from ... import telemetry
from ...telemetry.instruments import Histogram, Registry
from .client import WorkerClient, WorkerGone, WorkerRejected

__all__ = ["FleetCollector", "parse_prometheus", "merge_exports",
           "fleet_chrome_trace"]

_collector_ids = itertools.count()
_C = ("collector",)

# label pairs inside the braces of one sample line
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')

# label-string -> parsed dict. Label SETS are low-cardinality and
# stable across scrape cycles while VALUES change every line, so the
# brace content is the natural memo key — it turns the per-line regex
# walk into a dict hit on the scrape hot path. Cached dicts are shared:
# callers must treat them as frozen.
_label_cache = {}
_suffix_cache = {}                     # name -> (base, suffix) or ""


def _parse_labels(rawlab):
    d = _label_cache.get(rawlab)
    if d is None:
        d = {k: v.replace('\\"', '"').replace("\\\\", "\\")
             for k, v in _LABEL_RE.findall(rawlab)}
        if len(_label_cache) > 8192:   # bound both memo tables
            _label_cache.clear()
            _suffix_cache.clear()
        _label_cache[rawlab] = d
    return d


def _hist_suffix(name):
    r = _suffix_cache.get(name)
    if r is None:
        r = ""
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix):
                r = (name[:-len(suffix)], suffix)
                break
        _suffix_cache[name] = r
    return r


def parse_prometheus(text):
    """Parse a Prometheus text exposition (0.0.4) into
    {family: {"kind", "help", "samples": [(labels_dict, value)],
    "hist": {label_key: {"labels", "bounds", "cumulative", "sum",
    "count"}}}}. Histogram `_bucket`/`_sum`/`_count` series fold back
    into their family; `cumulative` keeps the raw cumulative counts
    (including +Inf, last) so `Histogram.from_cumulative` can
    reconstruct per-bucket counts. Label dicts come from a shared memo
    (label sets repeat across lines and scrape cycles) — treat them as
    read-only."""
    fams = {}

    def fam(name):
        f = fams.get(name)
        if f is None:
            f = fams[name] = {"kind": "untyped", "help": "",
                              "samples": [], "hist": {}}
        return f

    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] == "TYPE":
                fam(parts[2])["kind"] = parts[3].strip() \
                    if len(parts) > 3 else "untyped"
            elif len(parts) >= 3 and parts[1] == "HELP":
                fam(parts[2])["help"] = parts[3] if len(parts) > 3 else ""
            continue
        # "name value" | "name{labels} value" — the value is the text
        # after the last space (label values may themselves contain
        # spaces, but they sit inside the braces)
        sp = line.rfind(" ")
        if sp <= 0:
            continue
        head = line[:sp].rstrip()
        try:
            value = float(line[sp + 1:])
        except ValueError:
            continue
        if head.endswith("}"):
            br = head.find("{")
            if br <= 0:
                continue
            name = head[:br]
            labels = _parse_labels(head[br + 1:-1])
        else:
            name, labels = head, {}
            if " " in name or "{" in name:
                continue
        hs = _hist_suffix(name)
        base = None
        if hs and fams.get(hs[0], {}).get("kind") == "histogram":
            base = hs[0]
        if base is not None:
            hl = {k: v for k, v in labels.items() if k != "le"}
            key = tuple(sorted(hl.items()))
            h = fam(base)["hist"].setdefault(
                key, {"labels": hl, "bounds": [], "cumulative": [],
                      "sum": 0.0, "count": 0})
            if name.endswith("_bucket"):
                le = labels.get("le", "+Inf")
                b = math.inf if le == "+Inf" else float(le)
                h["bounds"].append(b)
                h["cumulative"].append(value)
            elif name.endswith("_sum"):
                h["sum"] = value
            else:
                h["count"] = int(value)
        else:
            fams[name] = fam(name)
            fams[name]["samples"].append((labels, value))
    return fams


def _scan_counter_total(text, name):
    """Sum every sample of one counter family straight off the raw
    exposition text — the scrape loop's per-cycle rate bookkeeping
    needs exactly one family, and a C-speed `str.find` walk over the
    few matching lines beats parsing the whole export."""
    total = 0.0
    i = text.find(name)
    while i != -1:
        if i == 0 or text[i - 1] == "\n":      # line start == a sample
            j = text.find("\n", i)
            line = text[i:j] if j != -1 else text[i:]
            sp = line.rfind(" ")
            if sp > 0:
                try:
                    total += float(line[sp + 1:])
                except ValueError:
                    pass
        i = text.find(name, i + 1)
    return total


def _hist_from_export(name, help, h):
    """One scraped histogram series -> a reconstructed Histogram."""
    pairs = sorted(zip(h["bounds"], h["cumulative"]))
    bounds = tuple(b for b, _ in pairs if b != math.inf)
    cum = [c for _, c in pairs]
    if len(cum) == len(bounds):       # exposition without +Inf line
        cum.append(float(h["count"]))
    return Histogram.from_cumulative(bounds, cum, h["sum"], h["count"],
                                     name=name, help=help)


def merge_exports(exports, out=None):
    """Merge per-worker Prometheus exports into one Registry.

    `exports` is [(worker_id, role, families_dict)] with families as
    `parse_prometheus` returns them. Counters sum across workers per
    label-set; gauges append (worker_id, role) labels and stay
    per-worker; histograms merge bucket-wise. Families whose shape
    disagrees across workers (labelnames or bucket bounds) are skipped
    and returned in the conflict list: (registry, [family, ...])."""
    target = out if out is not None else Registry()
    conflicts = []
    names = []
    for _wid, _role, fams in exports:
        for name in fams:
            if name not in names:
                names.append(name)
    for name in names:
        try:
            _merge_family(target, name, exports)
        except MXNetError:
            conflicts.append(name)
    return target, conflicts


def _merge_family(target, name, exports):
    kind = help = None
    for _wid, _role, fams in exports:
        f = fams.get(name)
        if f is None:
            continue
        if kind is None:
            kind, help = f["kind"], f["help"]
        elif f["kind"] != kind:
            raise MXNetError(f"family {name!r}: kind disagrees")
    if kind == "counter":
        totals = {}                   # label tuple -> (labels, sum)
        for _wid, _role, fams in exports:
            for labels, value in fams.get(name, {}).get("samples", ()):
                key = tuple(sorted(labels.items()))
                prev = totals.get(key)
                totals[key] = (labels, (prev[1] if prev else 0.0) + value)
        labelnames = _labelnames(v[0] for v in totals.values())
        inst = target.counter(name, help, labelnames)
        for labels, total in totals.values():
            child = inst.labels(**labels) if labelnames else inst
            child.inc(max(total, 0.0))
    elif kind == "gauge":
        rows = []
        for wid, role, fams in exports:
            for labels, value in fams.get(name, {}).get("samples", ()):
                rows.append((wid, role, labels, value))
        labelnames = _labelnames(r[2] for r in rows) \
            + ("worker_id", "role")
        inst = target.gauge(name, help, labelnames)
        for wid, role, labels, value in rows:
            inst.labels(**dict(labels, worker_id=wid,
                               role=role)).set(value)
    elif kind == "histogram":
        series = {}                   # label tuple -> (labels, [Hist])
        for _wid, _role, fams in exports:
            for key, h in fams.get(name, {}).get("hist", {}).items():
                series.setdefault(key, (h["labels"], []))[1].append(
                    _hist_from_export(name, help, h))
        bounds = None
        for _labels, hists in series.values():
            for h in hists:
                if bounds is None:
                    bounds = h.buckets
                elif h.buckets != bounds:
                    raise MXNetError(f"family {name!r}: buckets disagree")
        if bounds is None:
            return
        labelnames = _labelnames(v[0] for v in series.values())
        inst = target.histogram(name, help, labelnames, buckets=bounds)
        for labels, hists in series.values():
            child = inst.labels(**labels) if labelnames else inst
            for h in hists:
                child.merge(h)
    # untyped families (none today) are dropped: no aggregation rule


def _labelnames(labeldicts):
    """The union'd label-name tuple for one family, in first-seen
    order — every worker renders the same declaration, so in practice
    this is just the declared order."""
    names = []
    for d in labeldicts:
        for k in d:
            if k not in names:
                names.append(k)
    return tuple(names)


class _WorkerView:
    """One worker as the collector sees it: the client stub, learned
    identity, the measured clock offset, and the last good scrape."""

    def __init__(self, index, client):
        self.index = index
        self.client = client
        self.worker_id = client.url      # until the first stats answer
        self.role = "unknown"
        self.pid = None
        self.offset = 0.0                # worker clock - collector clock
        self.stats = {}
        self._text = ""                  # raw /metrics exposition
        self._fams = None                # parsed lazily from _text
        self.requests = []
        self.sloz = {}
        self.flightz = {}
        self.last_ok = None              # collector clock, last full scrape
        self.errors = 0
        self.last_error = None

    @property
    def families(self):
        """Parsed metric families, parsed LAZILY from the last scraped
        exposition text: the scrape cycle itself never pays the parse —
        only readers that need the structured view (merged registry,
        fleet dumps) do."""
        if self._fams is None:
            self._fams = parse_prometheus(self._text) if self._text \
                else {}
        return self._fams

    @property
    def stale(self):
        return self.last_ok is None or self.last_error is not None


def _fleet_collector_metrics(cid):
    c, g, h = telemetry.counter, telemetry.gauge, telemetry.histogram
    return {
        "errors": c(
            "fleet_scrape_errors_total",
            "scrape failures per worker (connection loss, timeout, "
            "HTTP error) — the worker's view goes stale, the loop "
            "keeps going", ("collector", "worker")),
        "cycles": c(
            "fleet_scrape_cycles_total",
            "completed collector scrape cycles", _C).labels(cid),
        "scrape_s": h(
            "fleet_scrape_seconds",
            "wall time of one full scrape cycle across every worker "
            "(serial RPCs, bounded per-RPC timeouts)", _C).labels(cid),
        "age": g(
            "fleet_scrape_age_seconds",
            "seconds since each worker's last successful scrape "
            "(staleness; grows while a worker is down)",
            ("collector", "worker")),
        "stale": g(
            "fleet_workers_stale",
            "workers whose last scrape failed (their merged view is "
            "from an earlier cycle)", _C).labels(cid),
        "tok_s": g(
            "fleet_tokens_per_sec",
            "fleet-wide token emission rate over the trailing scrape "
            "window (delta of the merged "
            "serving_tokens_emitted_total)", _C).labels(cid),
        "tok_s_chip": g(
            "fleet_tokens_per_sec_per_chip",
            "fleet tokens/sec divided by the chips serving them "
            "(sum of per-worker tp_shards), the fleet's "
            "headline, at the merged TTFT p99", _C).labels(cid),
        "dumps": c(
            "fleet_flight_dumps_total",
            "correlated fleet flight dumps written, by reason "
            "(worker:<id>:<latch> or slo_fleet_burn:<objective>)",
            ("collector", "reason")),
    }


def _fleet_slo_metrics():
    c, g = telemetry.counter, telemetry.gauge
    return {
        "events": c(
            "slo_fleet_events_total",
            "fleet-wide SLO observations from the merged event "
            "stream, classified per objective (verdict=good|bad)",
            ("objective", "verdict")),
        "burn": g(
            "slo_fleet_burn_rate",
            "fleet-wide error-budget burn rate per objective and "
            "window (judged over every worker's merged events)",
            ("objective", "window")),
        "burning": g(
            "slo_fleet_fast_burning",
            "1 while the fleet-wide fast-window burn rate is at/over "
            "threshold, else 0", ("objective",)),
    }


class FleetCollector:
    """Scrape-merge-judge loop over one fleet (see module docstring).

    workers: base URLs or WorkerClient instances (a router's live
    clients work — `FleetRouter.observe()` wires exactly that).
    router: optional FleetRouter whose identity/stats ride along in
    `fleetz()`. objectives: fleet-global `telemetry.SLO` list.
    interval_s: scrape period of the background loop (`start()`);
    `scrape()` may also be driven by hand. out_dir: where correlated
    fleet dumps land. requests_n: per-worker timeline pull bound per
    cycle — the knob that keeps a cycle's cost flat as the request log
    fills (raise it if a worker finishes more than requests_n requests
    per interval, or the SLO feed samples rather than sees them all).
    clock: injectable for tests — defaults to the wall-anchored
    telemetry clock, the axis every aligned event timestamp lives on.
    """

    def __init__(self, workers, *, router=None, interval_s=1.0,
                 scrape_timeout_s=5.0, objectives=(),
                 out_dir="flight_dumps", rate_window_s=10.0,
                 requests_n=32, clock=None, cid=None):
        if not workers:
            raise MXNetError("FleetCollector needs at least one worker")
        self.cid = str(cid) if cid is not None \
            else str(next(_collector_ids))
        self.interval_s = float(interval_s)
        self.scrape_timeout_s = float(scrape_timeout_s)
        self.out_dir = str(out_dir)
        self.rate_window_s = float(rate_window_s)
        self.requests_n = int(requests_n)
        self.router = router
        self._clock = clock if clock is not None else telemetry.now
        self._views = []
        for i, w in enumerate(workers):
            client = w if isinstance(w, WorkerClient) else WorkerClient(w)
            self._views.append(_WorkerView(i, client))
        self._m = _fleet_collector_metrics(self.cid)
        self._lock = threading.Lock()
        self._merged = Registry()
        self._merge_conflicts = []
        self._merge_stamp = None      # cycle the lazy merge is valid for
        self._seen_slo = set()        # (request_id, kind) fed to the SLO
        self._tok_marks = []          # (t, fleet tokens total) per cycle
        self._tok_rate = 0.0
        self._chips = 0
        self._cycles = 0
        self._dumped = set()          # latched correlated-dump reasons
        self._dump_paths = []
        self._stop = threading.Event()
        self._thread = None
        self._slo = telemetry.slo.SLOEngine(
            objectives, clock=self._clock,
            metrics=_fleet_slo_metrics(),
            on_fast_burn=lambda name, detail: self.fleet_dump(
                f"slo_fleet_burn:{name}", detail))

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        """Run the scrape loop on a daemon thread and publish
        `fleetz()` on this process's introspection server."""
        if self._thread is not None:
            return self
        from ...telemetry import server as _tserver
        _tserver.register_fleetz_provider(self.fleetz)
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"mx-fleet-collector:{self.cid}")
        self._thread.start()
        return self

    def close(self):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=self.scrape_timeout_s
                   * (len(self._views) * 4 + 2) + self.interval_s)
        from ...telemetry import server as _tserver
        _tserver.unregister_fleetz_provider(self.fleetz)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def _loop(self):
        while not self._stop.is_set():
            try:
                self._cycle()
            except Exception:         # noqa: BLE001 — loop must survive
                pass
            self._stop.wait(self.interval_s)

    # -- the scrape cycle ---------------------------------------------------
    def scrape(self):
        """One full cycle (see `_cycle`), then the merged registry.
        The background loop runs `_cycle` alone — the parse/merge cost
        of building the registry view is paid lazily, by readers."""
        self._cycle(full=True)
        return self.merged

    def _cycle(self, full=None):
        """One scrape cycle: pull every worker, update the fleet
        rates, feed + evaluate the fleet SLO engine, mirror worker
        flight latches. Never raises on worker failure — a failing
        worker only bumps `fleet_scrape_errors_total{worker}` and
        leaves its last good snapshot in place, stale. The merged
        registry is NOT rebuilt here: the raw exposition text is
        stashed per worker and `merged` re-parses on demand, so the
        periodic loop stays off the serving path even on saturated
        single-core hosts. The sloz/flightz planes change slowly, so
        the periodic loop refreshes them every 4th cycle only (a
        worker flight latch is still mirrored within 4 intervals);
        manual `scrape()` always pulls everything."""
        if full is None:
            full = self._cycles % 4 == 0
        t_cycle0 = self._clock()
        for w in self._views:
            self._scrape_worker(w, full)
        self._update_rates()
        self._feed_slo()
        self._slo.evaluate(self._clock())
        self._mirror_worker_latches()
        now = self._clock()
        for w in self._views:
            self._m["age"].labels(self.cid, w.worker_id).set(
                now - w.last_ok if w.last_ok is not None else math.inf)
        self._m["stale"].set(sum(w.stale for w in self._views))
        self._m["cycles"].inc()
        self._m["scrape_s"].observe(max(now - t_cycle0, 0.0))
        with self._lock:
            self._cycles += 1

    def _scrape_worker(self, w, full=True):
        tmo = self.scrape_timeout_s
        try:
            t0 = self._clock()
            stats = w.client.stats(timeout=tmo)
            t1 = self._clock()
            text = w.client.metrics_text(timeout=tmo)
            requests = w.client.requests(n=self.requests_n, timeout=tmo)
            if full:
                try:
                    sloz = w.client.sloz(timeout=tmo)
                    flightz = w.client.flightz(timeout=tmo)
                except WorkerRejected:  # a worker without these planes
                    sloz, flightz = {}, {}
            else:                     # slow planes: keep the last pull
                sloz, flightz = w.sloz, w.flightz
        except (WorkerGone, WorkerRejected, ValueError, KeyError) as e:
            w.errors += 1
            w.last_error = f"{type(e).__name__}: {e}"
            self._m["errors"].labels(self.cid, w.worker_id).inc()
            return
        w.worker_id = str(stats.get("worker_id") or w.client.url)
        w.role = str(stats.get("role") or "unknown")
        w.pid = stats.get("pid")
        if "now" in stats:
            # the worker's wall-anchored clock minus the round-trip
            # midpoint on OURS: subtracting this from a worker
            # timestamp lands it on the collector's axis, good to
            # ~RTT/2 — far inside a handoff's wall time
            w.offset = float(stats["now"]) - 0.5 * (t0 + t1)
        w.stats = stats
        w._text = text
        w._fams = None                # re-parsed lazily on next read
        w.requests = requests if isinstance(requests, list) else []
        w.sloz = sloz
        w.flightz = flightz
        w.last_ok = self._clock()
        w.last_error = None

    def _update_rates(self):
        total = 0.0
        for w in self._views:
            total += _scan_counter_total(w._text,
                                         "serving_tokens_emitted_total")
        t = self._clock()
        marks = self._tok_marks
        marks.append((t, total))
        while len(marks) > 2 and marks[0][0] < t - self.rate_window_s:
            marks.pop(0)
        dt = t - marks[0][0]
        self._tok_rate = (total - marks[0][1]) / dt if dt > 0 else 0.0
        chips = 0
        for w in self._views:
            st = (w.stats or {}).get("stats") or {}
            chips += max(int(st.get("tp_shards") or 1), 1)
        self._chips = max(chips, 1)
        self._m["tok_s"].set(self._tok_rate)
        self._m["tok_s_chip"].set(self._tok_rate / self._chips)

    # -- fleet SLO feed ------------------------------------------------------
    def _feed_slo(self):
        """Feed the fleet SLO engine from the merged request streams:
        one ttft observation per request (the first `first_token` any
        worker recorded) and one goodput observation per finished
        request, deduplicated across scrape cycles AND across workers
        so a migrated/handed-off request counts once fleet-wide.
        Observation timestamps are the ALIGNED event times, so burn
        windows are exact even when a scrape arrives late."""
        if not self._slo.objectives:
            return
        by_req = {}
        for w in self._views:
            for tr in w.requests:
                by_req.setdefault(
                    str(tr.get("request_id")), []).append((w, tr))
        for rid, pieces in by_req.items():
            first = None              # (aligned ts, ttft, pri, tenant)
            finish = None             # (aligned ts, tokens, pri, tenant)
            t_first = None
            for w, tr in pieces:
                pri = tr.get("priority")
                ten = tr.get("tenant")
                for ev in tr.get("events") or ():
                    ts = float(ev.get("ts", 0.0)) - w.offset
                    if ev.get("event") == "first_token":
                        if first is None or ts < first[0]:
                            first = (ts, ev.get("ttft"), pri, ten)
                        if t_first is None or ts < t_first:
                            t_first = ts
                    elif ev.get("event") == "finished" \
                            and tr.get("status") == "finished":
                        finish = (ts, ev.get("tokens"), pri, ten)
            if first is not None and first[1] is not None \
                    and (rid, "ttft") not in self._seen_slo:
                self._seen_slo.add((rid, "ttft"))
                self._slo.observe_ttft(float(first[1]),
                                       priority=first[2],
                                       tenant=first[3], t=first[0])
            if finish is not None and (rid, "finish") not in self._seen_slo:
                ts, tokens, pri, ten = finish
                t0 = t_first if t_first is not None else None
                if t0 is not None and tokens and int(tokens) > 1 \
                        and ts > t0:
                    self._seen_slo.add((rid, "finish"))
                    self._slo.observe_goodput(
                        (int(tokens) - 1) / (ts - t0),
                        priority=pri, tenant=ten, t=ts)
        if len(self._seen_slo) > 65536:   # bound across long soaks
            self._seen_slo.clear()

    # -- correlated fleet dump ----------------------------------------------
    def _mirror_worker_latches(self):
        for w in self._views:
            for reason in (w.flightz or {}).get("latched") or ():
                self.fleet_dump(f"worker:{w.worker_id}:{reason}",
                                {"worker": w.worker_id,
                                 "worker_reason": str(reason)})

    def fleet_dump(self, reason, detail=None):
        """Snapshot EVERY worker's last-scraped metrics + requests +
        flight state (plus the merged registry and the fleetz payload)
        into one directory — once per reason, like the per-process
        flight recorder's latch. Returns the path, or None when the
        reason already fired."""
        reason = str(reason)
        with self._lock:
            if reason in self._dumped:
                return None
            self._dumped.add(reason)
        safe = "".join(ch if ch.isalnum() or ch in "-_" else "-"
                       for ch in reason)[:80]
        stamp = time.strftime("%Y%m%d-%H%M%S")
        base = os.path.join(self.out_dir,
                            f"fleet-{safe}-{stamp}-{os.getpid()}")
        path = base
        n = 0
        while os.path.exists(path) or os.path.exists(path + ".tmp"):
            n += 1
            path = f"{base}.{n}"
        tmp = path + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        merged_text = self.merged.render_prometheus()
        for w in self._views:
            wdir = os.path.join(tmp, "".join(
                ch if ch.isalnum() or ch in "-_" else "-"
                for ch in w.worker_id)[:60] or f"worker{w.index}")
            os.makedirs(wdir, exist_ok=True)
            with open(os.path.join(wdir, "metrics.prom"), "w") as f:
                f.write("".join(self._render_export(w.families)))
            for fname, obj in (("stats.json", w.stats),
                               ("requests.json", w.requests),
                               ("sloz.json", w.sloz),
                               ("flightz.json", w.flightz)):
                with open(os.path.join(wdir, fname), "w") as f:
                    json.dump(obj, f, indent=1, sort_keys=True,
                              default=str)
        with open(os.path.join(tmp, "merged.prom"), "w") as f:
            f.write(merged_text)
        with open(os.path.join(tmp, "trace.json"), "w") as f:
            json.dump(self.fleet_chrome_trace(), f)
        with open(os.path.join(tmp, "fleet.json"), "w") as f:
            json.dump({"reason": reason, "detail": detail,
                       "ts": time.time(), "fleetz": self.fleetz()},
                      f, indent=1, sort_keys=True, default=str)
        os.rename(tmp, path)
        self._m["dumps"].labels(self.cid, reason).inc()
        with self._lock:
            self._dump_paths.append(path)
        telemetry.flight.record("fleet_dump", collector=self.cid,
                                reason=reason, path=path)
        return path

    @staticmethod
    def _render_export(fams):
        """Re-render a parsed export (dump fidelity beats keeping the
        raw text around per worker)."""
        for name, f in sorted(fams.items()):
            yield f"# TYPE {name} {f['kind']}\n"
            for labels, value in f["samples"]:
                lab = ",".join(f'{k}="{v}"' for k, v in labels.items())
                yield f"{name}{{{lab}}} {value:g}\n" if lab \
                    else f"{name} {value:g}\n"
            for h in f["hist"].values():
                lab = ",".join(f'{k}="{v}"'
                               for k, v in h["labels"].items())
                sep = "," if lab else ""
                for b, cum in sorted(zip(h["bounds"], h["cumulative"])):
                    le = "+Inf" if b == math.inf else "%g" % b
                    yield (f'{name}_bucket{{{lab}{sep}le="{le}"}}'
                           f" {cum:g}\n")
                suffix = f"{{{lab}}}" if lab else ""
                yield f"{name}_sum{suffix} {h['sum']:g}\n"
                yield f"{name}_count{suffix} {h['count']}\n"

    def rearm(self, reason=None):
        """Un-latch one correlated-dump reason (or all)."""
        with self._lock:
            if reason is None:
                self._dumped.clear()
            else:
                self._dumped.discard(str(reason))

    # -- views ---------------------------------------------------------------
    @property
    def merged(self):
        """The merged Registry over the most recent scrape cycle —
        rebuilt lazily and memoized per cycle. Readers (fleetz, dumps,
        `render_prometheus`) pay the parse + merge; the periodic
        scrape loop never does."""
        with self._lock:
            stamp = self._cycles
            if self._merge_stamp == stamp:
                return self._merged
        exports = [(w.worker_id, w.role, w.families)
                   for w in self._views if w._text]
        merged, conflicts = merge_exports(exports)
        with self._lock:
            self._merged = merged
            self._merge_conflicts = conflicts
            self._merge_stamp = stamp
            return self._merged

    @property
    def workers(self):
        return list(self._views)

    def render_prometheus(self):
        return self.merged.render_prometheus()

    def fleet_chrome_trace(self):
        """ONE Perfetto trace over the whole fleet: every worker's
        last-scraped timelines, clock-aligned, one process track per
        worker pid (see module docstring)."""
        snaps = []
        for w in self._views:
            snaps.append({"worker_id": w.worker_id, "role": w.role,
                          "pid": w.pid, "offset": w.offset,
                          "requests": w.requests})
        return fleet_chrome_trace(snaps, collector=self.cid)

    def fleetz(self):
        """The /fleetz payload: per-worker health + identity + steady
        compiles, fleet throughput at the current merged p99, scrape
        staleness, the fleet SLO snapshot, correlated dumps."""
        now = self._clock()
        merged = self.merged
        rows = []
        for w in self._views:
            st = (w.stats or {}).get("stats") or {}
            eng = (w.stats or {}).get("engine") or {}
            rows.append({
                "worker_id": w.worker_id, "role": w.role,
                "pid": w.pid, "url": w.client.url,
                "state": "stale" if w.stale else "ok",
                "scrape_age_s": (now - w.last_ok)
                if w.last_ok is not None else None,
                "scrape_errors": w.errors,
                "last_error": w.last_error,
                "clock_offset_s": w.offset,
                "draining": (w.stats or {}).get("draining"),
                "weight_dtype": eng.get("weight_dtype"),
                "kv_dtype": eng.get("kv_dtype"),
                "steady_state_compiles": st.get("steady_state_compiles"),
                "handoffs": (w.stats or {}).get("handoffs"),
                "flight_latched": (w.flightz or {}).get("latched") or [],
            })
        p99_ms = None
        ttft = merged.get("serving_ttft_seconds")
        if ttft is not None:
            merged_ttft = None
            for _values, child in ttft._samples():
                if merged_ttft is None:
                    merged_ttft = Histogram(
                        "_fleetz_ttft", buckets=child.buckets)
                merged_ttft.merge(child)
            if merged_ttft is not None and merged_ttft.count:
                p99_ms = merged_ttft.percentile(99) * 1e3
        with self._lock:
            cycles = self._cycles
            conflicts = list(self._merge_conflicts)
            dumps = list(self._dump_paths)
        out = {
            "collector": self.cid,
            "now": now,
            "interval_s": self.interval_s,
            "cycles": cycles,
            "workers": rows,
            "fleet": {
                "workers_total": len(self._views),
                "workers_stale": sum(w.stale for w in self._views),
                "chips": self._chips,
                "tokens_per_sec": self._tok_rate,
                "tokens_per_sec_per_chip": self._tok_rate
                / max(self._chips, 1),
                "ttft_p99_ms": p99_ms,
            },
            "slo": self._slo.snapshot(self._clock()),
            "fleet_dumps": dumps,
            "merge_conflicts": conflicts,
        }
        if self.router is not None:
            out["router"] = {
                "router": self.router._rid,
                "disaggregated": self.router.disaggregated,
                "workers_up": sum(r.state == "up"
                                  for r in self.router.workers),
            }
        return out

    # -- SLO surface ---------------------------------------------------------
    @property
    def slo_engine(self):
        return self._slo


def _unique_pid(pid, used, index):
    """Track pid for one worker: its real OS pid when free — in-process
    test fleets share one pid, so collisions fall back to a derived,
    stable id (the trace args keep the real pid)."""
    cand = int(pid) if pid else 1000000 + index
    while cand in used:
        cand = cand * 10 + index + 1
    used.add(cand)
    return cand


def fleet_chrome_trace(worker_snaps, collector=""):
    """Assemble per-worker timeline snapshots into ONE Chrome/Perfetto
    trace: `worker_snaps` is [{"worker_id", "role", "pid", "offset",
    "requests": [timeline dict, ...]}]. Each worker becomes one
    process track (pid = the worker's OS pid); every timeline's
    timestamps are shifted by -offset onto the collector's clock
    before emission, so spans of one `trace_id` that crossed processes
    (prefill → handoff → decode) line up on one consistent axis."""
    from ...telemetry.request_trace import chrome_trace
    events = []
    used = set()
    offsets = {}
    for i, snap in enumerate(worker_snaps):
        reqs = [_align_timeline(tr, snap.get("offset") or 0.0)
                for tr in snap.get("requests") or ()]
        if not reqs:
            continue
        sub = chrome_trace(requests=reqs, spans=[])["traceEvents"]
        pid = _unique_pid(snap.get("pid"), used, i)
        wid = snap.get("worker_id", f"worker{i}")
        offsets[str(wid)] = snap.get("offset") or 0.0
        pname = (f"worker {wid} ({snap.get('role', '?')}) "
                 f"pid {snap.get('pid')}")
        for ev in sub:
            ev = dict(ev, pid=pid)
            if ev.get("ph") == "M" and ev.get("name") == "process_name":
                ev["args"] = {"name": pname}
            events.append(ev)
    events.sort(key=lambda e: (0 if e["ph"] == "M" else 1,
                               e.get("ts", 0.0)))
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {
                "exporter": "mxnet_tpu_torch.serving.fleet.observe."
                            "fleet_chrome_trace",
                "collector": str(collector),
                "clock": "per-worker wall-anchored clocks aligned onto "
                         "the collector's axis (offset = worker now - "
                         "scrape round-trip midpoint)",
                "clock_offsets_s": offsets,
            }}


def _align_timeline(tr, offset):
    """Shift one timeline dict onto the collector's clock: absolute
    timestamps (t_begin, t_end, event ts) move by -offset; durations
    and phase budgets are differences and stay untouched."""
    out = dict(tr)
    if out.get("t_begin") is not None:
        out["t_begin"] = float(out["t_begin"]) - offset
    if out.get("t_end") is not None:
        out["t_end"] = float(out["t_end"]) - offset
    evs = []
    for ev in out.get("events") or ():
        ev = dict(ev)
        if "ts" in ev:
            ev["ts"] = float(ev["ts"]) - offset
        evs.append(ev)
    out["events"] = evs
    return out
