"""Fleet worker: one ServingEngine behind a control-plane HTTP server.

Counterpart of mxnet_tpu/serving/fleet/worker.py. `FleetWorker`
subclasses `ServingFrontend`: it keeps the whole data plane (`POST
/v1/generate` SSE streaming, /healthz, /readyz, /metrics, the
serving-loop thread that owns the engine) and adds the fleet control
plane on the SAME port:

    GET  /fleet/stats     role, wire version, engine geometry (the
                          router checks chunk_tokens), engine stats with
                          steady_state_compiles
    GET  /fleet/requests  this engine's recent request timelines
    GET  /fleet/sloz      this process's SLO snapshot and clock stamp
    GET  /fleet/flightz   this process's flight-recorder state
    POST /fleet/prefill   submit, run prefill to the first token, then
                          export WITH the KV page payload -> wire blob
    POST /fleet/adopt     decode a wire blob, adopt it (payload scatter
                          or replay restart), stream the continuation
    POST /fleet/export    export everything in flight as replay blobs
    POST /fleet/cancel    cancel by request id
    POST /fleet/drain     stop admitting (engine and frontend); work in
                          flight keeps being served
    POST /fleet/undrain   reopen admission

The frontend's threading rule holds: handler threads never touch the
engine. Control RPCs (export, adopt, drain) go through one more
serving-loop command, ("call", (fn, box)), which runs `fn(engine)` on
the loop between step() calls.

Run as a process: `python -m mxnet_tpu_torch.serving.fleet.worker
--spec SPEC.json [--role prefill|decode|mixed] [--port N] [--device
cpu]`. It runs on the CUDA card unless `--device` (or the spec's
"device") names another. The spec fixes the model (config, init seed
and std), so every worker given one spec builds the same weights
without shipping a checkpoint; the worker warms the engine (every
prefill bucket, greedy and sampled, and one export_handoff -> adopt
round trip, so every kernel library is loaded before warmup ends and
a handoff loads nothing), then prints one `FLEET_WORKER_READY {json}`
line for its supervisor.
"""
from __future__ import annotations

import json
import os
import queue
import threading
import time
from urllib.parse import parse_qs, urlparse

from ...base import MXNetError
from ... import telemetry
from ..frontend import (ServingFrontend, TokenStream, _FrontendServer,
                        _Handler, _drain_rejection, _failed_body,
                        _invalid_body, _rejection_body, _DISCONNECT_ERRORS)
from ..scheduler import (Request, RejectedError, QueueFullError,
                         TERMINAL_STATUSES)
from . import wire

__all__ = ["FleetWorker", "build_engine", "warm_engine", "main"]

ROLES = ("prefill", "decode", "mixed")


class _CallBox:
    """Result slot for a generic serving-loop call."""
    __slots__ = ("outcome", "error", "result", "event")

    def __init__(self):
        self.outcome = None
        self.error = None
        self.result = None
        self.event = threading.Event()


class _WorkerHandler(_Handler):
    server_version = "mx-fleet-worker/1.0"

    def do_GET(self):               # noqa: N802 (stdlib handler name)
        url = urlparse(self.path)
        views = {"/fleet/stats": self.fe.fleet_stats,
                 "/fleet/sloz": self.fe.fleet_sloz,
                 "/fleet/flightz": self.fe.fleet_flightz}
        try:
            if url.path in views:
                self._reply(views[url.path]())
                return
            if url.path == "/fleet/requests":
                q = parse_qs(url.query)
                try:
                    n = max(1, int(q["n"][0])) if "n" in q else 100
                except ValueError:
                    n = 100
                self._reply(self.fe.recent_requests(n))
                return
        except _DISCONNECT_ERRORS:
            return
        except Exception as e:      # noqa: BLE001 — must answer
            self._reply({"error": f"{type(e).__name__}: {e}"}, code=500)
            return
        super().do_GET()

    def do_POST(self):              # noqa: N802 (stdlib handler name)
        route = {
            "/fleet/prefill": self._fleet_prefill,
            "/fleet/adopt": self._fleet_adopt,
            "/fleet/export": self._fleet_export,
            "/fleet/cancel": self._fleet_cancel,
            "/fleet/drain": self._fleet_drain,
            "/fleet/undrain": self._fleet_undrain,
        }.get(urlparse(self.path).path)
        if route is None:
            super().do_POST()
            return
        try:
            route()
        except _DISCONNECT_ERRORS:
            pass
        except Exception as e:      # noqa: BLE001 — must answer
            self._counted_reply(
                {"error": {"type": type(e).__name__,
                           "reason": "internal",
                           "message": str(e)}}, 500)

    # -- plumbing ----------------------------------------------------------
    def _read_body(self):
        return self.rfile.read(
            int(self.headers.get("Content-Length") or 0))

    def _read_json(self):
        body = json.loads(self._read_body() or b"{}")
        if not isinstance(body, dict):
            raise ValueError("request body must be a JSON object")
        return body

    def _refuse_admission(self):
        """Answer 503 when the worker takes no new work (its backend
        failed, or it drains); True when it did."""
        fw = self.fe
        if fw.failed is not None:
            self._counted_reply(_failed_body(fw), 503)
            return True
        if fw.draining:
            self._reject_reply(_drain_rejection(fw), 503)
            return True
        return False

    # -- control plane -----------------------------------------------------
    def _fleet_cancel(self):
        try:
            rid = str(self._read_json()["request_id"])
        except Exception as e:      # noqa: BLE001 — malformed request
            self._counted_reply(_invalid_body(e), 400)
            return
        self.fe.cancel(rid)
        self._reply({"ok": True, "request_id": rid})

    def _fleet_drain(self):
        self.fe.begin_drain()
        self.fe.call_on_loop(lambda eng: eng.drain())
        self._reply({"ok": True, "draining": True})

    def _fleet_undrain(self):
        self.fe.call_on_loop(lambda eng: eng.undrain())
        self.fe.end_drain()
        self._reply({"ok": True, "draining": False})

    def _fleet_export(self):
        blobs = self.fe.call_on_loop(
            lambda eng: [wire.encode_request(r)
                         for r in self.fe.close_streams(
                             eng.export_requests())])
        self._reply({"requests": blobs, "wire_version": wire.WIRE_VERSION})

    # -- disaggregation data plane -----------------------------------------
    def _fleet_prefill(self):
        """Admit, run prefill to the first emitted token, export the
        request WITH its KV payload, answer the wire blob. A request
        that goes terminal during prefill (a 1-token budget, an instant
        EOS, a deadline) comes back as a `final` blob: nothing is left
        to hand off."""
        fw = self.fe
        try:
            body = self._read_json()
        except Exception as e:      # noqa: BLE001 — malformed request
            self._counted_reply(_invalid_body(e), 400)
            return
        if self._refuse_admission():
            return
        try:
            req = fw._build_request(body)
        except (MXNetError, TypeError, ValueError, KeyError) as e:
            self._counted_reply(_invalid_body(e), 400)
            return
        tp = telemetry.parse_traceparent(self.headers.get("traceparent"))
        req.trace = {"trace_id": tp[0], "parent_span": tp[1]} \
            if tp is not None else {"trace_id": telemetry.new_trace_id()}
        outcome, err = fw._submit_via_loop(req)
        if outcome == "rejected":
            code = 429 if isinstance(err, QueueFullError) else 503
            self._reject_reply(_rejection_body(err), code)
            return
        if outcome == "invalid":
            self._counted_reply(_invalid_body(err), 400)
            return
        if outcome == "failed":
            self._counted_reply(_failed_body(fw), 503)
            return
        if outcome != "ok":
            self._counted_reply(
                {"error": {"type": "Internal", "reason": "internal",
                           "message": str(err)}}, 500)
            return
        deadline = time.monotonic() + fw.prefill_timeout_s
        while time.monotonic() < deadline and fw.failed is None:
            if req.output_tokens or req.status in TERMINAL_STATUSES:
                break
            time.sleep(0.002)
        exported = None
        if req.status not in TERMINAL_STATUSES and fw.failed is None:
            exported = fw.call_on_loop(
                lambda eng: eng.export_handoff(req.id))
        if exported is None:
            if req.status in TERMINAL_STATUSES:
                blob = wire.encode_request(req)
                blob["final"] = True
                fw._note_handoff(final=True)
                self._counted_reply(blob, 200)
                return
            # still mid-prefill at the timeout (or the backend failed):
            # give the slot back
            fw.cancel(req.id)
            self._counted_reply(
                {"error": {"type": "Timeout",
                           "reason": "prefill_timeout",
                           "message": "prefill did not reach its "
                                      "first token in "
                                      f"{fw.prefill_timeout_s}s"}}, 500)
            return
        if not fw.ship_payload:
            # the ablation arm: the blob carries kv_history only and the
            # decode worker re-prefills (bit-identical, slower)
            exported.kv_payload = None
        blob = wire.encode_request(exported)
        blob["final"] = False
        fw._note_handoff(final=False)
        self._counted_reply(blob, 200)

    def _fleet_adopt(self):
        """Decode a wire blob, adopt it on the serving loop and stream
        the continuation. A version mismatch answers 409 with the
        structured reason, never a guess-and-adopt."""
        fw = self.fe
        try:
            blob = wire.loads(self._read_body())
        except wire.WireVersionError as e:
            fw._note_version_reject()
            self._counted_reply(
                {"error": {"type": "WireVersionError",
                           "reason": "wire_version_mismatch",
                           "message": str(e),
                           "got": e.got, "want": e.want}}, 409)
            return
        except MXNetError as e:
            self._counted_reply(_invalid_body(e), 400)
            return
        try:
            req = wire.decode_request(blob)
        except (MXNetError, KeyError, TypeError, ValueError) as e:
            self._counted_reply(_invalid_body(e), 400)
            return
        if self._refuse_admission():
            return
        stream = TokenStream(
            capacity=max(fw.stream_buffer, req.max_new_tokens + 8))
        req.stream = stream
        base = len(req.output_tokens)
        try:
            fw.call_on_loop(
                lambda eng: eng.adopt(req, migrated_from="wire"))
        except RejectedError as e:
            code = 429 if isinstance(e, QueueFullError) else 503
            self._reject_reply(_rejection_body(e), code)
            return
        except MXNetError as e:
            self._counted_reply(_invalid_body(e), 400)
            return
        fw._register(req, stream)
        try:
            self._adopt_stream(fw, req, stream, base)
        finally:
            fw._unregister(req)

    def _adopt_stream(self, fw, req, stream, base):
        """SSE continuation of an adopted request. The `adopted` event
        acknowledges the handoff (the router holds client tokens back
        until it lands, so client TTFT includes the handoff); `tokens`
        indices are LOCAL (index 0 is global token `base`) and the
        router re-bases them."""
        try:
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/event-stream; charset=utf-8")
            self.send_header("Cache-Control", "no-store")
            self.send_header("X-Request-Id", req.id)
            if req.trace:
                self.send_header(
                    "traceparent",
                    telemetry.format_traceparent(req.trace["trace_id"]))
            self.send_header("Connection", "close")
            self.end_headers()
            self._send_event("adopted", {
                "request_id": req.id, "base": base,
                "worker": fw.worker_id})
        except _DISCONNECT_ERRORS:
            fw._on_disconnect(req)
            return
        fw._code_inc(200)
        sent = 0
        while True:
            toks, closed = stream.take(timeout=fw.keepalive_s)
            try:
                if toks:
                    self._send_event("tokens",
                                     {"tokens": toks, "index": sent})
                    sent += len(toks)
                if closed is not None:
                    status = req.status \
                        if req.status in TERMINAL_STATUSES else closed
                    if closed == "error" and fw.failed is not None:
                        self._send_event("error", {
                            "error": "backend_failed",
                            "message": fw.failed, "sent": sent})
                    elif stream.overflowed:
                        fw._note_overflow()
                        self._send_event("error", {
                            "error": "overflow", "sent": sent,
                            "message": "client fell behind on the "
                                       "adopted stream; request "
                                       "cancelled"})
                    else:
                        tail = [int(t) for t
                                in req.output_tokens[base + sent:]]
                        if tail:
                            self._send_event(
                                "tokens",
                                {"tokens": tail, "index": sent})
                            sent += len(tail)
                    self._send_event("done", {
                        "request_id": req.id, "status": status,
                        "emitted": len(req.output_tokens),
                        "sent": sent,
                        # the whole stitched phase budget, handoff
                        # included: the router reads the TTFT
                        # decomposition from here
                        "phases": {k: float(v) for k, v
                                   in (req.phases or {}).items()}})
                    return
                if not toks:
                    self.wfile.write(b": keepalive\n\n")
                    self.wfile.flush()
            except _DISCONNECT_ERRORS:
                fw._on_disconnect(req)
                return


class _WorkerServer(_FrontendServer):
    handler_class = _WorkerHandler
    name_prefix = "mx-fleet-worker-http"


class FleetWorker(ServingFrontend):
    """ServingFrontend plus the fleet control plane (one port, one
    engine, one serving loop). `role` is a declaration the router
    honours: "prefill" workers take new prompts and export at the first
    token, "decode" workers adopt and stream, "mixed" do both. The
    worker itself never refuses a data-plane call for its role, so a
    degraded fleet can still route around losses.

    steady_state_compiles counts the kernel-library builds and loads
    flagged steady (made after an engine's mark_warm()) while this
    worker lives. The port's compiles are process-wide kernel
    libraries, not per-engine programs, so a worker counts every steady
    one in its process; the fleet's bar is 0 on every worker."""

    server_class = _WorkerServer

    def __init__(self, engine, role="mixed", worker_id=None,
                 ship_payload=True, prefill_timeout_s=120.0, **kw):
        if role not in ROLES:
            raise MXNetError(f"role must be one of {ROLES}, got {role!r}")
        self.role = role
        self.worker_id = str(worker_id) if worker_id is not None \
            else f"w{os.getpid()}"
        self.ship_payload = bool(ship_payload)
        self.prefill_timeout_s = float(prefill_timeout_s)
        self._fleet_lock = threading.Lock()
        self._handoffs = 0
        self._handoffs_final = 0
        self._version_rejects = 0
        self._steady_compiles = 0

        def _on_compile(ev):
            if ev.get("steady"):
                with self._fleet_lock:
                    self._steady_compiles += 1

        self._compile_hook = _on_compile
        telemetry.cost.add_compile_hook(_on_compile)
        super().__init__(engine, **kw)

    @property
    def engine(self):
        return self._backend

    # -- serving-loop extension: generic calls -----------------------------
    def _drain_cmds(self, fail=False):
        """ServingFrontend._drain_cmds plus the ("call", (fn, box))
        command that control RPCs use to run loop-only engine methods
        on the owning thread."""
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
                        box.error = MXNetError("worker closed")
                    box.event.set()
                    continue
                self._do_submit(req, box)
            elif kind == "call":
                fn, box = payload
                if fail or self._failed is not None:
                    box.outcome = "error"
                    box.error = MXNetError(
                        "worker closed" if self._failed is None
                        else f"backend failed: {self._failed}")
                    box.event.set()
                    continue
                try:
                    box.result = fn(self._backend)
                    box.outcome = "ok"
                except Exception as e:  # noqa: BLE001 — surfaced to caller
                    box.outcome, box.error = "error", e
                box.event.set()
            elif self._failed is None:      # never touch a failed backend
                self._do_cancel(payload)

    def call_on_loop(self, fn, timeout=None):
        """Run `fn(engine)` on the serving loop and return its result
        (its exception re-raises here). The only path from a handler
        thread to a loop-only engine method."""
        box = _CallBox()
        self._cmd_q.put(("call", (fn, box)))
        self._wake.set()
        if not box.event.wait(timeout or self.submit_timeout_s):
            raise MXNetError("serving-loop call timed out")
        if box.outcome != "ok":
            raise box.error
        return box.result

    def close(self):
        telemetry.cost.remove_compile_hook(self._compile_hook)
        super().close()

    # -- control-plane helpers (handler threads) ---------------------------
    def end_drain(self):
        """Reopen frontend admission after /fleet/drain (the engine is
        undrained separately, on the loop)."""
        self._draining = False
        telemetry.flight.record("frontend_undrained", frontend=self._fid)

    def close_streams(self, reqs, status="exported"):
        """Close the client streams of exported requests: over the wire
        the blob carries the tokens, and the stream's reader learns the
        request moved from its `done` event."""
        for r in reqs:
            st = getattr(r, "stream", None)
            if st is not None:
                st.close(status)
                r.stream = None
        return reqs

    def _note_handoff(self, final):
        with self._fleet_lock:
            self._handoffs += 1
            if final:
                self._handoffs_final += 1

    def _note_version_reject(self):
        with self._fleet_lock:
            self._version_rejects += 1

    def fleet_stats(self):
        eng = self._backend
        with self._fleet_lock:
            counts = (self._handoffs, self._handoffs_final,
                      self._version_rejects, self._steady_compiles)
        return {
            "worker_id": self.worker_id,
            "role": self.role,
            "pid": os.getpid(),
            "url": self.url,
            # this process's wall-anchored trace clock at answer time:
            # the fleet collector brackets the RPC with its own clock and
            # derives a per-worker offset to align timelines
            "now": telemetry.now(),
            "wire_version": wire.WIRE_VERSION,
            "ship_payload": self.ship_payload,
            "draining": self.draining,
            "handoffs": counts[0],
            "handoffs_final": counts[1],
            "wire_version_rejects": counts[2],
            "engine": {
                "chunk_tokens": eng.chunk_tokens,
                "prefill_chunk_budget": eng.prefill_chunk_budget,
                "page_size": eng.page_size,
                "max_length": eng.max_length,
                "num_slots": eng.num_slots,
                "kv_dtype": eng.kv_dtype,
                "weight_dtype": eng.weight_dtype,
                "device": str(eng.device),
            },
            "stats": dict(eng.stats, steady_state_compiles=counts[3]),
            "frontend": self.stats,
        }

    def recent_requests(self, n=100):
        """This engine's recent request timelines only: in-process
        workers share the process-global request log, so the engine id
        scopes the answer."""
        eid = str(self._backend._eid)
        return [t for t in telemetry.request_log.recent(max(n * 4, 64))
                if str(t.get("engine")) == eid][-n:]

    def fleet_sloz(self):
        """This process's SLO snapshot plus the clock stamp the
        collector aligns with."""
        return {"worker_id": self.worker_id, "now": telemetry.now(),
                "slo": telemetry.slo.snapshot()}

    def fleet_flightz(self):
        """This process's flight-recorder state: latched reasons (the
        collector mirrors a new latch into a correlated fleet dump),
        dump paths and a bounded tail of the breadcrumb ring."""
        rec = telemetry.flight.get()
        out = {"worker_id": self.worker_id, "now": telemetry.now(),
               "armed": rec is not None,
               "latched": telemetry.flight.latched_reasons()}
        if rec is not None:
            out["dumps"] = [str(p) for p in rec.dumps]
            out["events_tail"] = rec.events()[-64:]
        return out


# -- spec-driven process entry ---------------------------------------------

def build_engine(spec, device=None):
    """(model, config, engine) from a JSON-safe spec: {"config":
    GPT2Config kwargs (their "dtype" float32 or bfloat16), "seed": int,
    "init_std": float, "engine": ServingEngine kwargs, "device":
    optional}. The weights are `init_params(model, seed, init_std)`
    drawn in float32 (then cast for a bfloat16 config), so every process
    given one spec holds the same weights. `device` (default the spec's,
    else the CUDA card) places model and engine."""
    import torch
    from ...models import GPT2Config, GPT2ForCausalLM, init_params
    from ...models.gpt2 import _DTYPES
    from ..engine import ServingEngine

    kw = dict(spec.get("config", {}))
    dtype = kw.pop("dtype", "float32")
    if dtype not in _DTYPES:
        raise MXNetError(f"spec dtype {dtype!r} unsupported "
                         f"({', '.join(_DTYPES)})")
    cfg = GPT2Config(**kw)
    dev = device if device is not None else spec.get("device")
    net = GPT2ForCausalLM(cfg, device=dev)
    init_params(net, seed=int(spec.get("seed", 3)),
                std=float(spec.get("init_std", 0.05)))
    if _DTYPES[dtype] != torch.float32:
        net.to(_DTYPES[dtype])
    eng = ServingEngine(net, device=dev, **spec.get("engine", {}))
    return net, cfg, eng


def warm_engine(eng, cfg, spec=None):
    """Serve the warmup traffic BEFORE declaring ready: greedy then
    sampled requests across every prefill bucket a prompt (or a
    migrated re-prefill of prompt + emitted tokens) can land in, and one
    export_handoff -> adopt round trip over two pages, so every kernel
    library the worker's traffic needs is loaded and a disaggregated
    fleet runs with steady_state_compiles == 0, handoffs included. Ends
    with mark_warm() and reset_stats()."""
    import numpy as np
    spec = spec or {}
    rng = np.random.default_rng(int(spec.get("warmup_seed", 17)))
    vocab = int(cfg.vocab_size)

    def mk(n, i, samp):
        return Request(rng.integers(0, vocab, n).tolist(), 4,
                       seed=9900 + i, do_sample=samp,
                       request_id=f"_warm{i}")
    page = int(eng.page_size)
    lens = [4, 5] + list(range(page, int(eng.max_length), page))
    # one pass per variant, as the reference: an all-greedy pass then an
    # all-sampled one
    i = 0
    for samp in (False, True):
        reqs = []
        for n in lens:
            i += 1
            reqs.append(mk(n, i, samp))
        eng.serve(reqs)
    r = mk(page + 3, i, True)
    eng.submit(r)
    for _ in range(64):
        eng.step()
        if r.output_tokens or r.status in TERMINAL_STATUSES:
            break
    e = eng.export_handoff(r.id)
    if e is not None:
        eng.adopt(e, migrated_from="warmup")
    while eng.has_work:
        eng.step()
    eng.mark_warm()
    eng.reset_stats()


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        description="run one fleet worker process")
    ap.add_argument("--spec", required=True,
                    help="model+engine spec: a JSON file path or an "
                         "inline JSON object")
    ap.add_argument("--role", default=None, choices=ROLES)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--worker-id", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device of model and engine (default: the "
                         "spec's, else the CUDA card)")
    ap.add_argument("--no-ship-payload", action="store_true",
                    help="handoff blobs carry kv_history only (replay "
                         "restart on the decode side): the ablation arm")
    ap.add_argument("--no-warmup", action="store_true")
    args = ap.parse_args(argv)
    raw = args.spec
    if os.path.exists(raw):
        with open(raw, "r", encoding="utf-8") as f:
            raw = f.read()
    spec = json.loads(raw)
    _net, cfg, eng = build_engine(spec, device=args.device)
    if not args.no_warmup:
        warm_engine(eng, cfg, spec)
    fw = FleetWorker(
        eng, role=args.role or spec.get("role", "mixed"),
        worker_id=args.worker_id, port=args.port, host=args.host,
        ship_payload=not args.no_ship_payload,
        **spec.get("frontend", {}))
    print("FLEET_WORKER_READY " + json.dumps(
        {"url": fw.url, "pid": os.getpid(), "role": fw.role,
         "worker_id": fw.worker_id, "device": str(eng.device)}),
        flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        fw.close()


if __name__ == "__main__":
    main()
