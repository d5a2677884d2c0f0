"""The port's telemetry plane against the JAX package's.

On weights carried across from a seeded JAX tiny GPT-2 (attn_impl="xla"
on the JAX side) and the same traffic, clocks and fault seeds, the
port's serving engine must record what the JAX engine records:

  * request timelines: per request the same ordered event names (TTFT
    phases by phase name) and terminal status, for the plain serve, the
    prefix cache with the host tier and a page-in, preemption with
    resume and with restart, a FaultPlan chaos run, deadlines and
    cancel; times are not compared. Phase sums stay <= TTFT in both
    packages, and chrome_trace() loads as JSON with one track per
    request;
  * metrics: for every engine-labeled family both packages register,
    the same counter and gauge values and histogram counts (histogram
    sums and time-valued gauges are times and are not compared; the
    cost-derived serving_model_flops_total, serving_wasted_flops_total
    and serving_flops_per_token are not compared either: the reference
    reads XLA's cost analysis of its compiled program, the port the
    model formula, held to a hand count in test_torch_cost_ledger.py),
    and the same family names in /metrics;
  * /statusz engine keys, the flight dump a fault latches (its file
    set), SLO fast burn and SheddingPolicy(slo=...) shedding, and drain
    flipping readiness;
  * the port's own seams: spans nest and reach torch.profiler, and the
    ready-probe registry survives engine churn under garbage
    collection (the reference can deadlock there; the port builds the
    weak reference outside its reentrant lock).

Every JAX engine built here is kept alive until the module ends, and
garbage is collected before each one is built, so no JAX engine's
finalizer runs inside the JAX package's ready-probe lock.
"""
import gc
import json
import os
import threading
import urllib.error
import urllib.request
import weakref
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402
import mxnet_tpu.serving as jax_serving  # noqa: E402
from mxnet_tpu import telemetry as jax_telemetry  # noqa: E402
from mxnet_tpu.models import GPT2Config as JaxConfig  # noqa: E402
from mxnet_tpu.models import GPT2ForCausalLM as JaxGPT2  # noqa: E402
import mxnet_tpu_torch.serving as port_serving  # noqa: E402
from mxnet_tpu_torch import telemetry as port_telemetry  # noqa: E402
from mxnet_tpu_torch.models import (GPT2Config, GPT2ForCausalLM,  # noqa: E402
                                    load_jax_params)

KW = dict(vocab_size=97, units=32, num_layers=2, num_heads=2,
          max_length=64, dropout=0.0, attention_dropout=0.0)
ENGINE = dict(num_slots=2, max_length=64, page_size=8)
# families whose values are times or come from the cost model
NOT_COMPARED = {"serving_model_flops_total", "serving_wasted_flops_total",
                "serving_flops_per_token", "serving_retry_after_seconds"}


class Tick:
    """Manual engine clock: deadlines and schedules advance explicitly."""

    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += float(dt)


class Steps:
    """Engine clock that advances a fixed step on every read, so phase
    durations are non-zero and deterministic per package."""

    def __init__(self, dt=1e-3):
        self.t, self.dt = 0.0, float(dt)

    def __call__(self):
        self.t += self.dt
        return self.t


@pytest.fixture(scope="module")
def sides():
    gc.collect()
    jnet = JaxGPT2(JaxConfig(**KW))
    mx.rng.seed(3)
    jnet.initialize(mx.init.Normal(0.05))
    arrays = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    net = load_jax_params(GPT2ForCausalLM(GPT2Config(**KW), device="cpu"),
                          arrays)
    keep = []

    def jax_engine(**kw):
        gc.collect()
        eng = jax_serving.ServingEngine(jnet, attn_impl="xla",
                                        **dict(ENGINE, **kw))
        keep.append(eng)
        return eng

    def side(mod, tel, make):
        return SimpleNamespace(
            engine=make, telemetry=tel, Request=mod.Request,
            FaultPlan=mod.FaultPlan, SheddingPolicy=mod.SheddingPolicy,
            ShedError=mod.ShedError, QueueFullError=mod.QueueFullError)
    yield {"jax": side(jax_serving, jax_telemetry, jax_engine),
           "port": side(port_serving, port_telemetry,
                        lambda **kw: port_serving.ServingEngine(
                            net, device="cpu", **dict(ENGINE, **kw)))}
    keep.clear()
    gc.collect()


# ---------------------------------------------------------------------------
# scenarios: each runs on one side and returns (engine, requests)
# ---------------------------------------------------------------------------

def _prompts(n, seed=7, lo=3, hi=20):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 97, size=int(rng.integers(lo, hi))).tolist()
            for _ in range(n)]


def _plain(side):
    eng = side.engine(clock=Steps())
    reqs = [side.Request(p, 5, request_id=f"p{i}")
            for i, p in enumerate(_prompts(5))]
    eng.serve(reqs)
    return eng, reqs


def _prefix_tier(side):
    rng = np.random.default_rng(11)
    shared = rng.integers(1, 97, size=24).tolist()
    tails = [rng.integers(1, 97, size=6).tolist() for _ in range(2)]
    churn = [rng.integers(1, 97, size=17).tolist() for _ in range(6)]
    eng = side.engine(clock=Steps(), prefix_cache=True,
                      prefix_cache_pages=4, host_kv_bytes=1 << 22)
    reqs = [side.Request(shared + tails[0], 6, request_id="r0")]
    reqs += [side.Request(p, 3, request_id=f"c{i}")
             for i, p in enumerate(churn)]
    reqs.append(side.Request(shared + tails[1], 6, request_id="r1"))
    for r in reqs:
        eng.serve([r])
    assert eng.stats["kv_pagein_pages"] >= 1
    return eng, reqs


def _preempt(side, host_kv_bytes):
    rng = np.random.default_rng(5)
    pol = side.SheddingPolicy(queue_low=1, queue_high=2, preempt=True)
    eng = side.engine(num_slots=1, prefix_cache=True,
                      host_kv_bytes=host_kv_bytes, policy=pol,
                      retry_backoff_s=0.0, clock=Tick())
    low = side.Request(rng.integers(1, 97, size=12).tolist(), 10,
                       request_id="low", priority=2)
    a = side.Request(rng.integers(1, 97, size=5).tolist(), 4,
                     request_id="a", priority=0)
    b = side.Request(rng.integers(1, 97, size=5).tolist(), 4,
                     request_id="b", priority=0)
    eng.submit(low)
    while len(low.output_tokens) < 2:
        eng.step()
    eng.submit(a)
    eng.submit(b)
    eng.step()
    assert low.status == "queued"
    while eng.has_work:
        eng.step()
    assert eng.stats["preempts"] == 1
    return eng, [low, a, b]


def _chaos(side):
    rng = np.random.default_rng(11)
    reqs = []
    for i in range(16):
        prompt = rng.integers(1, 97, size=int(rng.integers(2, 10)))
        reqs.append(side.Request(prompt, int(rng.integers(2, 7)),
                                 request_id=f"c{i}"))
    eng = side.engine(num_slots=4, max_retries=4, retry_backoff_s=0.0,
                      clock=Steps())
    plan = side.FaultPlan(seed=3, dispatch_exception=0.05, nan_logits=0.05,
                          pool_exhaustion=0.05, exhaust_steps=2,
                          alloc_failure=0.05, poison={"c5": "both"},
                          max_faults=20)
    plan.install(eng)
    arrivals = np.random.default_rng(13)
    pending = reqs[::-1]
    try:
        steps = 0
        while (pending or eng.has_work) and steps < 3000:
            for _ in range(int(arrivals.poisson(2.0))):
                if pending:
                    eng.submit(pending.pop())
            eng.step()
            steps += 1
    finally:
        plan.uninstall()
    assert reqs[5].status == "failed"
    assert eng.stats["dispatch_errors"] >= 2
    return eng, reqs


def _deadlines(side):
    clk = Tick()
    eng = side.engine(num_slots=1, clock=clk)
    R = side.Request
    da = R([1, 2, 3], 4, request_id="da")
    db = R([4, 5, 6], 4, request_id="db", deadline_ms=50.0)
    dr = R([7, 8, 9], 16, request_id="dr", deadline_ms=100.0)
    eng.submit(da)
    eng.submit(db)
    eng.step()
    clk.advance(0.2)                 # db expires in the queue
    while eng.has_work:
        eng.step()
    eng.submit(dr)
    eng.step()
    eng.step()
    clk.advance(1.0)                 # dr is cancelled at the boundary
    eng.step()
    assert (db.status, dr.status) == ("shed", "deadline")
    return eng, [da, db, dr]


def _cancel(side):
    eng = side.engine(num_slots=1, clock=Steps())
    R = side.Request
    run = R([1, 2, 3, 4], 12, request_id="run")
    queued = R([5, 6, 7], 4, request_id="queued")
    after = R([8, 9], 3, request_id="after")
    eng.submit(run)
    eng.submit(queued)
    eng.step()
    eng.step()
    assert eng.cancel("queued") is queued
    assert eng.cancel("run") is run
    assert eng.cancel("run") is False          # idempotent
    assert eng.cancel("never") is False
    eng.serve([after])
    return eng, [run, queued, after]


SCENARIOS = {
    "plain": _plain,
    "prefix_host_tier": _prefix_tier,
    "preempt_resume": lambda side: _preempt(side, 1 << 22),
    "preempt_restart": lambda side: _preempt(side, 8),
    "chaos": _chaos,
    "deadlines": _deadlines,
    "cancel": _cancel,
}


def _traces(side, eng):
    return [tr for tr in side.telemetry.request_log.recent(512)
            if tr["engine"] == eng._eid]


def _timelines(traces):
    out = {}
    for tr in traces:
        names = [e["event"] if e["event"] != "phase" else
                 "phase:" + e["phase"] for e in tr["events"]]
        out[str(tr["request_id"])] = (tr["status"], names)
    return out


def _engine_families(side, eng):
    """{(family, *other labels): (kind, value or histogram count)} for
    every child labeled with this engine."""
    out = {}
    for name, inst in side.telemetry.default_registry._instruments.items():
        if "engine" not in inst.labelnames:
            continue
        i = inst.labelnames.index("engine")
        for vals, child in inst._samples():
            if vals[i] != eng._eid:
                continue
            key = (name,) + tuple(v for j, v in enumerate(vals) if j != i)
            out[key] = (inst.kind, child.count
                        if inst.kind == "histogram" else child.value)
    return out


@pytest.fixture(scope="module")
def runs(sides):
    """Every scenario once per side: {name: {side: (engine, reqs,
    timelines, families, traces)}}."""
    out = {}
    for name, fn in SCENARIOS.items():
        out[name] = {}
        for key in ("jax", "port"):
            side = sides[key]
            side.telemetry.request_log.clear()
            eng, reqs = fn(side)
            traces = _traces(side, eng)
            out[name][key] = (eng, reqs, _timelines(traces),
                              _engine_families(side, eng), traces)
    return out


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_request_timelines_match_jax(runs, scenario):
    (jeng, jreqs, want, _, _), (eng, reqs, got, _, _) = (
        runs[scenario]["jax"], runs[scenario]["port"])
    assert got == want
    assert len(got) == len(reqs)
    assert [(r.status, list(r.output_tokens)) for r in reqs] \
        == [(r.status, list(r.output_tokens)) for r in jreqs]
    assert eng.audit_pages() == []


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_phase_sums_stay_within_ttft(runs, scenario):
    for key in ("jax", "port"):
        reqs = runs[scenario][key][1]
        for r in reqs:
            if getattr(r, "t_admit", None) is None or not r.phases:
                continue
            ttft = r.t_admit - r.t_submit
            assert sum(r.phases.values()) <= ttft + 1e-9, (key, r.id)
            assert set(r.phases) <= set(port_telemetry.PHASES)


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_engine_metrics_match_jax(runs, scenario):
    jf, pf = runs[scenario]["jax"][3], runs[scenario]["port"][3]
    assert set(pf) == set(jf)
    diff = {k: (jf[k], pf[k]) for k in jf
            if k[0] not in NOT_COMPARED and jf[k] != pf[k]}
    assert diff == {}


def test_chrome_trace_has_one_track_per_request(runs):
    eng, reqs, _, _, traces = runs["plain"]["port"]
    tr = json.loads(json.dumps(port_telemetry.chrome_trace(requests=traces)))
    pid = int(eng._eid) + 1
    tracks = {e["tid"] for e in tr["traceEvents"]
              if e.get("pid") == pid and e.get("name") == "request"}
    names = {e["args"]["name"] for e in tr["traceEvents"]
             if e.get("pid") == pid and e.get("name") == "thread_name"}
    assert len(tracks) == len(reqs)
    assert names == {f"req {r.id}" for r in reqs}


def _prom_families(text):
    return {line.split()[2]: line.split()[3] for line in text.splitlines()
            if line.startswith("# TYPE ")}


def test_metrics_family_names_match_jax(runs):
    jf, pf = (runs["prefix_host_tier"]["jax"][3],
              runs["prefix_host_tier"]["port"][3])
    fams = {k[0] for k in pf}
    assert fams == {k[0] for k in jf}
    jp = _prom_families(jax_telemetry.render_prometheus())
    pp = _prom_families(port_telemetry.render_prometheus())
    assert {f: pp.get(f) for f in fams} == {f: jp.get(f) for f in fams}


def test_statusz_engine_keys_match_jax(runs):
    jeng, eng = runs["preempt_resume"]["jax"][0], runs["preempt_resume"][
        "port"][0]
    js, ps = jeng._statusz(), eng._statusz()
    for key in ("config", "robustness", "kv_tier", "stats", "scheduler"):
        assert set(ps[key]) == set(js[key]), key
    assert set(ps) == set(js)
    comps = port_telemetry.collect_status()
    assert set(comps[f"engine/{eng._eid}"]) == set(js)


# ---------------------------------------------------------------------------
# flight recorder, SLOs, readiness
# ---------------------------------------------------------------------------

def _one_fault(side, out_dir):
    rec = side.telemetry.flight.install(out_dir=str(out_dir),
                                        stall_timeout=60.0)
    try:
        eng = side.engine()
        plan = side.FaultPlan(seed=0, dispatch_exception=1.0, max_faults=1)
        plan.install(eng)
        try:
            eng.serve([side.Request([1, 2, 3], 3, request_id="f0")])
        finally:
            plan.uninstall()
        return eng, rec.dumps
    finally:
        side.telemetry.flight.uninstall()


def test_dispatch_fault_latches_one_flight_dump_like_jax(sides, tmp_path):
    import os
    files = {}
    for key in ("jax", "port"):
        eng, dumps = _one_fault(sides[key], tmp_path / key)
        assert len(dumps) == 1, key
        assert os.path.basename(dumps[0]).startswith(
            f"dispatch_error-engine{eng._eid}-")
        files[key] = sorted(os.listdir(dumps[0]))
        with open(os.path.join(dumps[0], "state.json")) as f:
            state = json.load(f)
        assert f"engine/{eng._eid}" in state["components"]
        assert eng.stats["dispatch_errors"] == 1
    assert files["port"] == files["jax"] == [
        "events.jsonl", "metrics.json", "state.json"]


def _slo_burn(side, out_dir):
    tel = side.telemetry
    rec = tel.flight.install(out_dir=str(out_dir), stall_timeout=60.0)
    tel.slo.configure([tel.SLO("ttft_impossible", ttft_p99_ms=1e-6,
                               min_events=1)])
    try:
        eng = side.engine()
        eng.serve([side.Request(p, 2) for p in _prompts(3)])
        return (tel.slo.fast_burning(), len(rec.dumps),
                [os.path.basename(d).split("-")[0] for d in rec.dumps])
    finally:
        tel.slo.configure([])
        tel.flight.uninstall()


def test_impossible_slo_fast_burns_like_jax(sides, tmp_path):
    want = _slo_burn(sides["jax"], tmp_path / "jax")
    got = _slo_burn(sides["port"], tmp_path / "port")
    assert got == want
    assert got[0] == ["ttft_impossible"] and got[1] == 1


def _slo_shed(side):
    tel = side.telemetry
    slo = tel.slo.SLOEngine()
    slo.configure([tel.SLO("ttft_impossible", ttft_p99_ms=1e-6,
                           min_events=1)], clock=lambda: 0.0)
    pol = side.SheddingPolicy(queue_low=1, queue_high=100, slo=slo,
                              slo_eval_interval_s=0.0)
    eng = side.engine(num_slots=1, policy=pol, clock=Tick())
    trace = []
    for burning in (False, True):
        if burning:
            slo.observe_ttft(1.0)       # one bad first token: fast burn
        for i, p in enumerate(_prompts(5, seed=3 + burning)):
            r = side.Request(p, 2, request_id=f"s{int(burning)}{i}",
                             priority=i % 3)
            try:
                eng.submit(r)
                trace.append(("queued", r.priority))
            except side.ShedError as e:
                trace.append(("shed", e.reason, r.status))
        done = eng.serve()
        trace.append(sorted((r.id, r.status, list(r.output_tokens))
                            for r in done))
    s = eng.stats
    return trace, s["shed"], s["overload_level"], pol.snapshot()


def test_shedding_policy_with_slo_engine_sheds_like_jax(sides):
    want = _slo_shed(sides["jax"])
    got = _slo_shed(sides["port"])
    assert got == want
    assert got[1] >= 1


def _drain(side):
    tel = side.telemetry
    eng = side.engine(num_slots=1)
    name = f"engine{eng._eid}"
    trace = [eng.is_ready(), tel.component_ready(name)]
    eng.mark_warm()
    trace += [eng.is_ready(), tel.component_ready(name), eng.warmed]
    a = side.Request([1, 2, 3], 3, request_id="a")
    eng.submit(a)
    eng.step()
    eng.drain()
    trace += [eng.draining, eng.drained, eng.is_ready(),
              tel.component_ready(name)]
    try:
        eng.submit(side.Request([4, 5], 2, request_id="b"))
        trace.append("accepted")
    except side.ShedError as e:
        trace.append((e.reason, e.retry_after_s is None))
    while eng.has_work:
        eng.step()
    trace += [a.status, eng.drained, eng.stats["draining"]]
    eng.undrain()
    trace += [eng.is_ready(), tel.component_ready(name), eng.drained]
    return trace


def test_drain_flips_readiness_like_jax(sides):
    want = _drain(sides["jax"])
    got = _drain(sides["port"])
    assert got == want
    assert got[2:4] == [True, True] and got[7:9] == [False, False]


# ---------------------------------------------------------------------------
# the port's own seams
# ---------------------------------------------------------------------------

def test_ready_probe_registry_survives_engine_churn(sides):
    """Port engines made and dropped in a loop with gc.collect() between
    them, on a thread joined with a timeout: registering a probe while
    a dead engine's finalizer unregisters its own never deadlocks."""
    make = sides["port"].engine
    errors = []

    class Owner:
        def probe(self):
            return {"warmed": True, "degraded": False, "draining": False}

    def churn():
        try:
            for i in range(12):
                eng = make(num_slots=1)
                eng.generate([[1, 2, 3]], 1)
                owner = Owner()
                # a cycle: only the cyclic collector frees it, and its
                # finalizer unregisters under the registry's lock
                owner.me = owner
                port_telemetry.register_ready_probe(f"churn{i}", owner.probe)
                weakref.finalize(owner, port_telemetry.unregister_ready_probe,
                                 f"churn{i}")
                del eng, owner
                gc.collect()
                port_telemetry.readiness()
        except Exception as e:      # noqa: BLE001 — reported below
            errors.append(e)

    t = threading.Thread(target=churn, daemon=True)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive(), "ready-probe registration deadlocked"
    assert errors == []
    assert not any(n.startswith("churn") for n in port_telemetry.readiness())


def test_spans_nest_and_reach_the_torch_profiler():
    from mxnet_tpu_torch.telemetry import tracing
    tracing.clear_events()
    with tracing.span("outer", k=1):
        with tracing.span("inner"):
            pass
    evs = {e["name"]: e for e in tracing.events()}
    assert evs["inner"]["parent"] == "outer" and evs["inner"]["depth"] == 1
    assert evs["outer"]["k"] == 1
    with torch.profiler.profile() as prof:
        with tracing.span("profiled.range"):
            torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert "profiled.range" in names
    hist = port_telemetry.get("span_duration_seconds")
    assert hist.labels("profiled.range").count >= 1


def test_introspection_server_endpoints(runs):
    srv = port_telemetry.IntrospectionServer(0)
    try:
        got = {}
        for path in ("/", "/healthz", "/readyz", "/metrics", "/statusz",
                     "/requests?n=5", "/trace", "/compilez", "/memz",
                     "/sloz", "/fleetz"):
            try:
                with urllib.request.urlopen(srv.url + path,
                                            timeout=30) as r:
                    got[path] = (r.status, r.read())
            except urllib.error.HTTPError as e:
                got[path] = (e.code, e.read())
        assert {p: c for p, (c, _) in got.items()
                if p not in ("/readyz", "/fleetz")} == {
            p: 200 for p in got if p not in ("/readyz", "/fleetz")}
        assert got["/fleetz"][0] == 404
        assert len(json.loads(got["/requests?n=5"][1])["requests"]) >= 1
        assert "serving_tokens_emitted_total" in got["/metrics"][1].decode()
        progs = json.loads(got["/compilez"][1])["programs"]
        assert any(k.endswith("/dispatch") and v["dispatches"]
                   for k, v in progs.items())
        assert json.loads(got["/memz"][1])["accounted_bytes"] > 0
    finally:
        srv.close()


def test_memory_sampling_never_starts_cuda():
    from mxnet_tpu_torch.telemetry import memory
    assert memory.sample() == {}
    assert not torch.cuda.is_initialized()
