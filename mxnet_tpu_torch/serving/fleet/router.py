"""FleetRouter: place requests across worker PROCESSES and survive
their deaths.

Counterpart of mxnet_tpu/serving/fleet/router.py: the in-process
ServingRouter (serving/router.py) taken out of process. Replicas are
`WorkerClient` stubs over HTTP instead of engines in the same
interpreter, so every interaction — placement, streaming, failover,
the disaggregated prefill->decode handoff — crosses the wire format
(fleet/wire.py). The router duck-types the ServingFrontend backend
protocol (submit/cancel/step/has_work/estimated_drain_wait), so
`ServingFrontend(FleetRouter(...))` serves a whole fleet on one
ingress port.

Placement is rendezvous hashing over the prompt head (+ adapter id):
each request ranks every eligible worker by crc32(affinity_key + "/" +
worker_index) — sticky for prefix-cache affinity, stable under
membership churn (a worker's death reshuffles only ITS requests).

Two topologies:

* **Mixed** — every worker runs prefill + decode. A request streams
  from its affinity worker; optional pre-first-token hedging races a
  second worker and cancels the loser (deterministic generation makes
  the race safe — both would emit identical tokens).
* **Disaggregated** — prompts go to `prefill` workers, which run to
  the first token and export WITH the KV page payload; the router
  ships the blob to a `decode` worker, which scatters the pages in
  and streams the continuation. Client tokens are withheld until the
  decode worker acks adoption, so client TTFT includes the handoff.

Failure contract: a worker death mid-request (connection loss, EOF
before `done`) marks the replica down and re-places the request as a
restart blob synthesized from the ROUTER's own record — prompt,
received tokens, the trace stitch, and a natural-grid `kv_history`
(the dead process cannot be asked how it chunked, and on the natural
grid the schedule is deterministic — the int8 replay contract needs
it). The survivor adopts and continues bit-identically; the client
stream never breaks and the request's timeline reads as ONE stitched
trace.
"""
from __future__ import annotations

import itertools
import queue
import threading
import time
import zlib

import numpy as np

from ...base import MXNetError
from ... import telemetry
from ..scheduler import QueueFullError, ShedError, TERMINAL_STATUSES
from . import wire
from .client import WorkerClient, WorkerGone, WorkerRejected

__all__ = ["FleetRouter"]

_router_ids = itertools.count()
_R = ("router",)


def _fleet_metrics(rid):
    c, g, h = telemetry.counter, telemetry.gauge, telemetry.histogram
    placements = c(
        "fleet_placements_total",
        "requests placed on a worker, by placement kind (affinity = "
        "rendezvous first choice, spill = first choice rejected, "
        "failover = re-placed after a worker death, hedge = "
        "speculative second stream)", ("router", "kind"))
    hedges = c(
        "fleet_hedges_total",
        "pre-first-token hedges by outcome (fired = second stream "
        "opened, won = hedge delivered first, lost = primary "
        "delivered first)", ("router", "outcome"))
    return {
        "workers_up": g(
            "fleet_workers_up",
            "worker processes currently considered up by the router's "
            "health watchdog", _R).labels(rid),
        "deaths": c(
            "fleet_worker_deaths_total",
            "up->down transitions observed (connection loss mid-RPC "
            "or failed health probes)", _R).labels(rid),
        "failovers": c(
            "fleet_failovers_total",
            "requests re-placed onto a survivor after a worker died "
            "mid-flight (the restart blob preserves bit-identity)",
            _R).labels(rid),
        "handoffs": c(
            "fleet_handoffs_total",
            "disaggregated prefill->decode handoffs the router "
            "brokered", _R).labels(rid),
        "handoff_s": h(
            "fleet_handoff_seconds",
            "prefill export stamp -> decode adoption ack, as the "
            "router observes it (the wall-clock cost disaggregation "
            "adds to TTFT)", _R).labels(rid),
        "placements": placements,
        "hedges": hedges,
    }


class _Replica:
    """One worker process as the router sees it."""

    def __init__(self, index, client, info):
        self.index = index
        self.client = client
        self.state = "up"
        self.down_reason = None
        self.refresh(info)

    def refresh(self, info):
        self.info = info
        self.worker_id = info.get("worker_id")
        self.role = info.get("role", "mixed")
        eng = info.get("engine") or {}
        self.chunk_tokens = int(eng.get("chunk_tokens") or 0)

    def eligible(self, want):
        if self.state != "up":
            return False
        if want == "prefill":
            return self.role in ("prefill", "mixed")
        if want == "decode":
            return self.role in ("decode", "mixed")
        return True

    def __repr__(self):
        return (f"_Replica({self.index}, {self.client.url}, "
                f"{self.role}, {self.state})")


class _Track:
    """Router-side record of one in-flight request — the source of
    truth a failover rebuilds from."""

    def __init__(self, req, trace_id, t_begin):
        self.req = req
        self.trace_id = trace_id
        self.t_begin = t_begin
        self.rep = None
        self.error = None
        self.stream_error = None
        self.t_first = None
        self.done = threading.Event()


class FleetRouter:
    """Route requests across fleet worker processes (see module
    docstring). `workers` is a list of base URLs or WorkerClient
    instances; every worker must speak this build's WIRE_VERSION and
    (for bit-identical failover) share one chunk grid."""

    def __init__(self, workers, *, affinity_tokens=8,
                 hedge_after_s=None, max_failovers=3,
                 watchdog_interval_s=0.25, prefill_rpc_timeout_s=150.0,
                 rid=None):
        if not workers:
            raise MXNetError("FleetRouter needs at least one worker")
        self._rid = str(rid) if rid is not None else \
            str(next(_router_ids))
        self.affinity_tokens = int(affinity_tokens)
        self.hedge_after_s = None if hedge_after_s is None \
            else float(hedge_after_s)
        self.max_failovers = int(max_failovers)
        self.prefill_rpc_timeout_s = float(prefill_rpc_timeout_s)
        self._m = _fleet_metrics(self._rid)
        self._lock = threading.Lock()
        self._live = {}             # request id -> _Track
        self._collector = None      # FleetCollector via observe()
        self._closed = False
        self._reps = []
        for i, w in enumerate(workers):
            client = w if isinstance(w, WorkerClient) else WorkerClient(w)
            info = client.stats()
            if info.get("wire_version") != wire.WIRE_VERSION:
                raise MXNetError(
                    f"worker {client.url} speaks wire_version "
                    f"{info.get('wire_version')!r}, this router speaks "
                    f"{wire.WIRE_VERSION} — refusing to build a fleet "
                    "that cannot migrate requests")
            self._reps.append(_Replica(i, client, info))
        grids = {r.chunk_tokens for r in self._reps if r.chunk_tokens}
        if len(grids) > 1:
            raise MXNetError(
                f"workers disagree on chunk_tokens {sorted(grids)}: "
                "bit-identical failover replays the dead worker's "
                "write schedule on the natural grid, which requires "
                "ONE grid fleet-wide")
        self._chunk_tokens = grids.pop() if grids else 0
        self._disagg = any(r.role != "mixed" for r in self._reps)
        if self._disagg:
            for want in ("prefill", "decode"):
                if not any(r.eligible(want) for r in self._reps):
                    raise MXNetError(
                        f"disaggregated fleet has no {want}-capable "
                        "worker")
        self._m["workers_up"].set(len(self._reps))
        self._watchdog_interval_s = float(watchdog_interval_s)
        self._watchdog = threading.Thread(
            target=self._watch, daemon=True,
            name=f"mx-fleet-watchdog:{self._rid}")
        self._watchdog.start()
        telemetry.flight.record(
            "fleet_router_up", router=self._rid,
            workers=len(self._reps), disagg=self._disagg)

    # -- lifecycle ---------------------------------------------------------
    @property
    def workers(self):
        return list(self._reps)

    @property
    def disaggregated(self):
        return self._disagg

    def observe(self, **kw):
        """Build + start a `FleetCollector` over this router's workers
        (fleet/observe.py): the scrape-merge loop, the fleet SLO
        engine, correlated fleet dumps, and the /fleetz payload on
        this process's introspection server. Keyword args pass through
        to the collector (interval_s, objectives, out_dir, ...); the
        router closes it with itself."""
        if self._collector is not None:
            return self._collector
        from .observe import FleetCollector
        self._collector = FleetCollector(
            [r.client for r in self._reps], router=self, **kw)
        return self._collector.start()

    @property
    def collector(self):
        return self._collector

    def close(self):
        self._closed = True
        if self._collector is not None:
            self._collector.close()
            self._collector = None
        with self._lock:
            live = list(self._live.values())
        for tr in live:
            st = getattr(tr.req, "stream", None)
            if st is not None:
                st.close("aborted")
            tr.done.set()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def _watch(self):
        while not self._closed:
            time.sleep(self._watchdog_interval_s)
            up = 0
            for rep in self._reps:
                ok = rep.client.healthz()
                if ok and rep.state == "down":
                    # rejoin: refresh its declared shape first
                    try:
                        rep.refresh(rep.client.stats())
                    except (WorkerGone, WorkerRejected):
                        ok = False
                    else:
                        rep.state = "up"
                        rep.down_reason = None
                        telemetry.flight.record(
                            "fleet_worker_rejoined", router=self._rid,
                            worker=rep.index)
                elif not ok and rep.state == "up":
                    self._replica_down(rep, "health probe failed")
                up += rep.state == "up"
            self._m["workers_up"].set(up)

    def _replica_down(self, rep, reason):
        if rep.state == "down":
            return
        rep.state = "down"
        rep.down_reason = reason
        self._m["deaths"].inc()
        self._m["workers_up"].set(
            sum(r.state == "up" for r in self._reps))
        telemetry.flight.record(
            "fleet_worker_down", router=self._rid, worker=rep.index,
            reason=str(reason)[:200])

    # -- ServingFrontend backend protocol ----------------------------------
    @property
    def has_work(self):
        with self._lock:
            return bool(self._live)

    def step(self):
        return []                   # workers own their serving loops

    def estimated_drain_wait(self):
        return None

    def submit(self, request):
        """Admit and start routing one Request. Mixed fleets get a
        synchronous admission verdict (a worker rejection re-raises
        here as the engine-shaped QueueFullError/ShedError, so an
        ingress frontend keeps its 429/503 contract); disaggregated
        fleets admit at the prefill worker inside the runner thread
        and surface rejections on the request's stream/status."""
        if self._closed:
            raise MXNetError("router is closed")
        req = request
        t = dict(getattr(req, "trace", None) or {})
        t.setdefault("trace_id", telemetry.new_trace_id())
        t.setdefault("t_begin", telemetry.request_trace.now())
        req.trace = t
        track = _Track(req, t["trace_id"], t["t_begin"])
        if not isinstance(getattr(req, "phases", None), dict):
            req.phases = {}
        if self._disagg:
            runner, args = self._run_disagg, ()
        else:
            sse, rep, kind = self._open_generate(track)
            self._m["placements"].labels(self._rid, kind).inc()
            track.rep = rep
            runner, args = self._run_mixed, (sse, rep)
        with self._lock:
            self._live[req.id] = track
        threading.Thread(
            target=self._guard, args=(runner, track) + args,
            daemon=True,
            name=f"mx-fleet-run:{self._rid}:{req.id}").start()
        return req

    def cancel(self, request_id):
        with self._lock:
            track = self._live.get(request_id)
        if track is None:
            return False
        self._cancel_on_worker(track)
        return True

    # -- public conveniences ----------------------------------------------
    def result(self, request, timeout=None):
        """Block until `request` (a Request previously submitted)
        reaches a terminal status; returns it."""
        with self._lock:
            track = self._live.get(request.id)
        if track is not None and not track.done.wait(timeout):
            raise MXNetError(f"request {request.id} still in flight "
                             f"after {timeout}s")
        return request

    def fleet_stats(self):
        out = {"router": self._rid, "disaggregated": self._disagg,
               "workers": []}
        for rep in self._reps:
            entry = {"index": rep.index, "url": rep.client.url,
                     "state": rep.state, "role": rep.role,
                     "down_reason": rep.down_reason}
            if rep.state == "up":
                try:
                    entry["stats"] = rep.client.stats()
                except (WorkerGone, WorkerRejected):
                    pass
            out["workers"].append(entry)
        return out

    # -- placement ---------------------------------------------------------
    def _order(self, req, want, exclude=()):
        """Rendezvous order over eligible up workers: stable per
        (prompt head, adapter), uniform across requests."""
        key = np.asarray(req.prompt[:self.affinity_tokens],
                         np.int32).tobytes()
        key += f"|{req.adapter_id or ''}".encode("utf-8")
        cands = [r for r in self._reps
                 if r.eligible(want) and r.index not in exclude]
        return sorted(
            cands, reverse=True,
            key=lambda r: zlib.crc32(key + b"/%d" % r.index))

    def _open_generate(self, track, exclude=()):
        """Open the primary stream on the best eligible worker;
        spill down the rendezvous order on structured rejection, mark
        down and keep going on connection failure. All-rejected
        re-raises the least-loaded rejection engine-shaped."""
        req = track.req
        rejections = []
        tp = telemetry.format_traceparent(track.trace_id)
        for i, rep in enumerate(self._order(req, "any", exclude)):
            try:
                sse = rep.client.generate(self._body_of(req),
                                          traceparent=tp)
                return sse, rep, ("affinity" if i == 0 and not exclude
                                  else "spill")
            except WorkerGone as e:
                self._replica_down(rep, str(e))
            except WorkerRejected as e:
                rejections.append(e)
        raise self._admission_error(rejections)

    @staticmethod
    def _admission_error(rejections):
        if not rejections:
            return ShedError("no fleet workers available",
                             reason="no_workers")
        best = min(rejections,
                   key=lambda e: e.retry_after_s
                   if e.retry_after_s is not None else float("inf"))
        kw = dict(reason=best.reason, queue_depth=best.queue_depth,
                  active_slots=best.active_slots,
                  retry_after_s=best.retry_after_s)
        cls = QueueFullError if best.code == 429 else ShedError
        return cls(str(best), **kw)

    def _body_of(self, req):
        body = {"prompt": [int(t) for t in req.prompt],
                "max_new_tokens": int(req.max_new_tokens),
                "request_id": req.id,
                "do_sample": bool(req.do_sample),
                "temperature": float(req.temperature),
                "top_k": int(req.top_k), "top_p": float(req.top_p),
                "seed": int(req.seed), "stream": True}
        for k in ("eos_token_id", "priority", "deadline_ms",
                  "adapter_id", "tenant"):
            v = getattr(req, k, None)
            if v is not None:
                body[k] = v
        return body

    # -- the runner threads ------------------------------------------------
    def _guard(self, runner, track, *args):
        try:
            runner(track, *args)
        except Exception as e:      # noqa: BLE001 — never leak a hang
            self._finish(track, "failed", error=e)

    def _run_mixed(self, track, sse, rep):
        req = track.req
        attempts = 0
        base = 0
        while True:
            try:
                if base == 0 and self.hedge_after_s is not None \
                        and not req.output_tokens:
                    status = self._consume_hedged(track, sse, rep)
                else:
                    status = self._consume(track, iter(sse), base)
                self._finish(track, status)
                return
            except WorkerGone as e:
                sse.close()
                self._replica_down(rep, str(e))
                attempts += 1
                if attempts > self.max_failovers or self._closed:
                    self._finish(track, "failed", error=e)
                    return
                self._m["failovers"].inc()
                got = self._adopt_once(
                    track, self._restart_blob(track), "any",
                    kind="failover")
                if got is None:
                    self._finish(track, "failed",
                                 error=track.error or e)
                    return
                rep, sse = got
                track.rep = rep
                base = len(req.output_tokens)

    def _run_disagg(self, track):
        req = track.req
        tp = telemetry.format_traceparent(track.trace_id)
        blob = None
        rejections = []
        for i, rep in enumerate(self._order(req, "prefill")):
            try:
                blob = rep.client.prefill(
                    self._body_of(req), traceparent=tp,
                    timeout=self.prefill_rpc_timeout_s)
                track.rep = rep
                self._m["placements"].labels(
                    self._rid, "affinity" if i == 0 else "spill").inc()
                break
            except WorkerGone as e:
                # nothing streamed yet — a prefill retry elsewhere is
                # a plain deterministic resubmit
                self._replica_down(rep, str(e))
            except WorkerRejected as e:
                rejections.append(e)
        if blob is None:
            err = self._admission_error(rejections)
            self._finish(track,
                         "shed" if rejections else "failed", error=err)
            return
        # tokens the prefill produced: withheld until the decode
        # worker acks adoption, so the client's TTFT includes the
        # handoff (the trace's phase budget says the same thing)
        held = [int(t) for t in blob.get("output_tokens", [])]
        for k, v in (blob.get("phases") or {}).items():
            req.phases[str(k)] = float(v)
        if blob.get("final"):
            self._deliver(track, held[len(req.output_tokens):])
            self._finish(track, str(blob.get("status") or "finished"))
            return
        cur_blob = blob
        attempts = 0
        kind = "affinity"
        while True:
            got = self._adopt_once(track, cur_blob, "decode", kind=kind)
            if got is None:
                self._finish(track, "failed",
                             error=track.error
                             or MXNetError("no decode workers"))
                return
            rep, sse = got
            track.rep = rep
            it = iter(sse)
            try:
                ev, data = next(it)
                if ev == "adopted":
                    kvp = cur_blob.get("kv_payload")
                    if kvp is not None:
                        self._m["handoff_s"].observe(max(
                            0.0, telemetry.request_trace.now()
                            - float(kvp["t_export"])))
                    self._m["handoffs"].inc()
                    if held:
                        self._deliver(
                            track, held[len(req.output_tokens):])
                        held = []
                    status = self._consume(track, it,
                                           len(req.output_tokens))
                else:
                    st = self._apply_event(track, ev, data,
                                           len(req.output_tokens))
                    status = st if st is not None else self._consume(
                        track, it, len(req.output_tokens))
                self._finish(track, status)
                return
            except WorkerGone as e:
                sse.close()
                self._replica_down(rep, str(e))
                attempts += 1
                if attempts > self.max_failovers or self._closed:
                    self._finish(track, "failed", error=e)
                    return
                self._m["failovers"].inc()
                kind = "failover"
                if held:
                    # died before the adoption ack: nothing reached
                    # the client, the exported payload is still the
                    # exact continuation — re-ship the SAME blob
                    continue
                # decode had progressed: the payload is stale (its
                # cursor predates tokens the client already has) —
                # rebuild as a replay restart from the router's record
                cur_blob = self._restart_blob(track)

    # -- stream consumption ------------------------------------------------
    def _deliver(self, track, new):
        """Append NEW tokens (callers have already trimmed overlap)
        to the record and the client stream."""
        req = track.req
        if not new:
            return
        if track.t_first is None:
            track.t_first = telemetry.request_trace.now()
        req.output_tokens.extend(new)
        st = getattr(req, "stream", None)
        if st is not None and not st.emit(new):
            # slow client: mirror the engine's overflow policy —
            # cancel at the source rather than buffer unboundedly
            self._cancel_on_worker(track)

    def _apply_event(self, track, ev, data, base):
        """Fold one SSE event into the track. Returns the terminal
        status on `done`, else None. Token indices are re-based and
        de-overlapped, so replays from a failover or hedge are
        harmless."""
        req = track.req
        if ev == "tokens" and isinstance(data, dict):
            gidx = base + int(data.get("index", 0))
            toks = [int(t) for t in data.get("tokens", [])]
            have = len(req.output_tokens)
            if gidx > have:
                raise WorkerGone(
                    f"worker skipped ahead (index {gidx}, have {have})")
            # overlap with what a prior stream already delivered (a
            # failover/hedge replay) is trimmed, never re-emitted
            self._deliver(track, toks[have - gidx:]
                          if have > gidx else toks)
        elif ev == "error" and isinstance(data, dict):
            track.stream_error = data
        elif ev == "done":
            data = data if isinstance(data, dict) else {}
            for k, v in (data.get("phases") or {}).items():
                req.phases[str(k)] = float(v)
            status = str(data.get("status") or "finished")
            if status not in TERMINAL_STATUSES:
                # "exported"/"aborted": the worker let go of the
                # request without finishing it — re-place
                raise WorkerGone(f"worker released the request "
                                 f"({status})")
            return status
        return None

    def _consume(self, track, events, base):
        for ev, data in events:
            status = self._apply_event(track, ev, data, base)
            if status is not None:
                return status
        raise WorkerGone("stream ended without a done event")

    def _consume_hedged(self, track, sse, rep):
        """Pre-first-token hedging: if the primary stays silent for
        hedge_after_s, open the SAME request on the next-ranked
        worker and let the first tokens event win; the loser is
        cancelled at its source. Safe because generation is
        deterministic — both streams would emit identical tokens."""
        req = track.req
        q = queue.Queue()
        streams = {0: (sse, rep)}
        dead = set()
        winner = None
        hedged = False

        def pump(tag, s):
            def run():
                try:
                    for item in s:
                        q.put((tag,) + item)
                    q.put((tag, "__eof__", None))
                except WorkerGone as e:
                    q.put((tag, "__gone__", e))
            threading.Thread(
                target=run, daemon=True,
                name=f"mx-fleet-pump:{req.id}:{tag}").start()

        pump(0, sse)
        deadline = time.monotonic() + self.hedge_after_s
        while True:
            try:
                if winner is None and not hedged:
                    tag, ev, data = q.get(
                        timeout=max(0.0, deadline - time.monotonic()))
                else:
                    tag, ev, data = q.get()
            except queue.Empty:
                hedged = True
                try:
                    order = self._order(req, "any",
                                        exclude={rep.index})
                    if order:
                        s2 = order[0].client.generate(
                            self._body_of(req),
                            traceparent=telemetry.format_traceparent(
                                track.trace_id))
                        streams[1] = (s2, order[0])
                        pump(1, s2)
                        self._m["hedges"].labels(
                            self._rid, "fired").inc()
                        self._m["placements"].labels(
                            self._rid, "hedge").inc()
                except (WorkerGone, WorkerRejected):
                    pass
                continue
            if ev == "__eof__":
                continue
            if ev == "__gone__":
                dead.add(tag)
                if tag == winner or dead >= set(streams):
                    for t, (s, _r) in streams.items():
                        if t not in dead:
                            s.close()
                    raise data
                self._replica_down(streams[tag][1], str(data))
                continue
            if winner is None and ev == "tokens" \
                    and isinstance(data, dict) and data.get("tokens"):
                winner = tag
                track.rep = streams[tag][1]
                if hedged and 1 in streams:
                    self._m["hedges"].labels(
                        self._rid, "won" if tag == 1 else "lost").inc()
                for t, (s, r) in streams.items():
                    if t != winner and t not in dead:
                        s.close()
                        try:
                            r.client.cancel(req.id)
                        except (WorkerGone, WorkerRejected):
                            pass
            if winner is not None and tag != winner:
                continue
            status = self._apply_event(track, ev, data, 0)
            if status is not None:
                return status

    # -- failover plumbing -------------------------------------------------
    def _restart_blob(self, track):
        """Rebuild the migration blob from the router's OWN record —
        the dead worker cannot be asked. `kv_history` is synthesized
        on the natural chunk grid over the prompt (how every fleet
        engine feeds a fresh admission), which the int8 replay
        contract needs to regenerate identical KV codes; emitted
        tokens replay as 1-token writes, exactly how decode wrote
        them."""
        req = track.req
        blob = wire.encode_request(req)
        blob["status"] = "exported"
        blob["kv_payload"] = None
        blob["kv_attach"] = 0
        blob["trace"] = {"trace_id": track.trace_id,
                         "t_begin": track.t_begin}
        hist, left = [], int(req.prompt_len)
        chunk = self._chunk_tokens or left
        while left > 0:
            hist.append(min(chunk, left))
            left -= hist[-1]
        blob["kv_history"] = hist
        return blob

    def _adopt_once(self, track, blob, want, kind):
        """Ship a blob to the best eligible worker and open the
        continuation stream. Marks connection-dead targets down and
        keeps walking the order; structured rejections (incl. the 409
        wire-version refusal) land on track.error."""
        req = track.req
        for i, rep in enumerate(self._order(req, want)):
            try:
                sse = rep.client.adopt(blob)
                self._m["placements"].labels(
                    self._rid,
                    kind if kind == "failover"
                    else ("affinity" if i == 0 else "spill")).inc()
                return rep, sse
            except WorkerGone as e:
                self._replica_down(rep, str(e))
            except WorkerRejected as e:
                track.error = e
        return None

    def _cancel_on_worker(self, track):
        rep = track.rep
        if rep is None:
            return
        try:
            rep.client.cancel(track.req.id)
        except (WorkerGone, WorkerRejected):
            pass

    def _finish(self, track, status, error=None):
        req = track.req
        if error is not None:
            track.error = error
        req.status = status if status in TERMINAL_STATUSES else "failed"
        st = getattr(req, "stream", None)
        if st is not None:
            st.close(req.status)
        with self._lock:
            self._live.pop(req.id, None)
        track.done.set()
