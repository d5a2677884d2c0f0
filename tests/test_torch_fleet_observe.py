"""The port's fleet observability plane against the JAX package's.

The eight contracts of tests/test_fleet_observe.py, on port workers
serving weights carried across from the seeded JAX tiny GPT-2:
parse_prometheus and merge_exports (counters SUM across workers,
gauges stay per worker with worker_id/role labels, histograms merge
BUCKET-WISE, mismatched buckets refused) give the JAX package's answer
on the same exposition text; the FleetCollector's scrape, /fleetz on
the introspection server, the stitched cross-worker trace, the fleet
SLO's one correlated dump, a worker flight latch mirrored once and a
dead worker going stale without blocking the loop.
"""
import gc
import json
import math
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu.models import GPT2Config as JaxConfig  # noqa: E402
from mxnet_tpu.models import GPT2ForCausalLM as JaxGPT2  # noqa: E402
from mxnet_tpu.serving.fleet import observe as jax_observe  # noqa: E402
from mxnet_tpu_torch import telemetry  # noqa: E402
from mxnet_tpu_torch.models import (GPT2Config, GPT2ForCausalLM,  # noqa: E402
                                    load_jax_params)
from mxnet_tpu_torch.serving import (Request, ServingEngine,  # noqa: E402
                                     TokenStream)
from mxnet_tpu_torch.serving.fleet import (FleetRouter, FleetWorker,  # noqa: E402
                                           WorkerClient, warm_engine)
from mxnet_tpu_torch.serving.fleet.observe import (  # noqa: E402
    FleetCollector, fleet_chrome_trace, merge_exports, parse_prometheus)

_CONFIG = dict(vocab_size=97, units=32, num_layers=2, num_heads=2,
               max_length=64, dropout=0.0, attention_dropout=0.0)
_ENGINE = dict(num_slots=2, max_length=32, page_size=8)
_RESULT_S = 60


@pytest.fixture(scope="module")
def net():
    gc.collect()
    jnet = JaxGPT2(JaxConfig(**_CONFIG))
    mx.rng.seed(3)
    jnet.initialize(mx.init.Normal(0.05))
    arrays = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    cfg = GPT2Config(**_CONFIG)
    yield load_jax_params(GPT2ForCausalLM(cfg, device="cpu"), arrays), cfg
    gc.collect()


def _worker(net, role, wid=None):
    model, cfg = net
    eng = ServingEngine(model, device="cpu", **_ENGINE)
    warm_engine(eng, cfg)
    return FleetWorker(eng, role=role, worker_id=wid or f"{role}-t")


def _run(router, prompts, n_new, tag):
    reqs = [Request(list(p), n_new, request_id=f"{tag}{i}", seed=i,
                    do_sample=bool(i % 2)) for i, p in enumerate(prompts)]
    for r in reqs:
        r.stream = TokenStream(capacity=64)
        router.submit(r)
    for r in reqs:
        router.result(r, timeout=_RESULT_S)
    return reqs


# ---------------------------------------------------------------------------
# exposition parse + merge semantics (pure text, no fleet)
# ---------------------------------------------------------------------------

_EXPORT_A = """\
# HELP reqs_total requests
# TYPE reqs_total counter
reqs_total{engine="0"} 10
# TYPE depth gauge
depth{engine="0"} 3
# TYPE lat_seconds histogram
lat_seconds_bucket{engine="0",le="0.001"} 8
lat_seconds_bucket{engine="0",le="1"} 8
lat_seconds_bucket{engine="0",le="+Inf"} 8
lat_seconds_sum{engine="0"} 0.008
lat_seconds_count{engine="0"} 8
"""

_EXPORT_B = """\
# TYPE reqs_total counter
reqs_total{engine="0"} 32
# TYPE depth gauge
depth{engine="0"} 7
# TYPE lat_seconds histogram
lat_seconds_bucket{engine="0",le="0.001"} 0
lat_seconds_bucket{engine="0",le="1"} 2
lat_seconds_bucket{engine="0",le="+Inf"} 2
lat_seconds_sum{engine="0"} 1.9
lat_seconds_count{engine="0"} 2
"""


def test_parse_prometheus_structure_like_jax():
    fams = parse_prometheus(_EXPORT_A)
    assert fams["reqs_total"]["kind"] == "counter"
    assert fams["reqs_total"]["help"] == "requests"
    assert fams["reqs_total"]["samples"] == [({"engine": "0"}, 10.0)]
    h = fams["lat_seconds"]["hist"][(("engine", "0"),)]
    assert h["bounds"] == [0.001, 1.0, math.inf]
    assert h["cumulative"] == [8.0, 8.0, 8.0]
    assert h["count"] == 8 and h["sum"] == pytest.approx(0.008)
    for text in (_EXPORT_A, _EXPORT_B):
        assert parse_prometheus(text) == jax_observe.parse_prometheus(text)


def test_merge_counters_sum_gauges_split_hists_bucketwise_like_jax():
    def exports(parse):
        return [("wA", "prefill", parse(_EXPORT_A)),
                ("wB", "decode", parse(_EXPORT_B))]
    reg, conflicts = merge_exports(exports(parse_prometheus))
    assert conflicts == []
    c = reg.get("reqs_total")
    assert [(v, ch.value) for v, ch in c._samples()] == [(("0",), 42.0)]
    g = reg.get("depth")
    assert {v: ch.value for v, ch in g._samples()} == {
        ("0", "wA", "prefill"): 3.0, ("0", "wB", "decode"): 7.0}
    assert g.labelnames == ("engine", "worker_id", "role")
    h = reg.get("lat_seconds")
    child = next(ch for _v, ch in h._samples())
    assert child.count == 10
    assert child.sum == pytest.approx(1.908)
    assert child.percentile(99) > 0.001   # the slow worker's tail
    jreg, jconflicts = jax_observe.merge_exports(
        exports(jax_observe.parse_prometheus))
    assert jconflicts == conflicts
    assert reg.render_prometheus() == jreg.render_prometheus()


def test_merge_refuses_mismatched_buckets_like_jax():
    bad = _EXPORT_B.replace('le="0.001"', 'le="0.005"')
    reg, conflicts = merge_exports(
        [("wA", "prefill", parse_prometheus(_EXPORT_A)),
         ("wB", "decode", parse_prometheus(bad))])
    assert conflicts == ["lat_seconds"]
    assert reg.get("lat_seconds") is None     # skipped, not mangled
    assert reg.get("reqs_total") is not None  # the others still merge
    jreg, jconflicts = jax_observe.merge_exports(
        [("wA", "prefill", jax_observe.parse_prometheus(_EXPORT_A)),
         ("wB", "decode", jax_observe.parse_prometheus(bad))])
    assert jconflicts == conflicts
    assert reg.render_prometheus() == jreg.render_prometheus()


# ---------------------------------------------------------------------------
# the collector over a live in-process HTTP fleet
# ---------------------------------------------------------------------------

def test_collector_scrape_fleetz_and_endpoint(net):
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 97, n).tolist() for n in (4, 9, 6)]
    w1, w2 = _worker(net, "mixed", "wm1"), _worker(net, "mixed", "wm2")
    router = None
    try:
        router = FleetRouter([w1.url, w2.url])
        reqs = _run(router, prompts, 6, "c")
        assert all(r.status == "finished" for r in reqs)
        coll = router.observe(interval_s=60.0)
        assert router.observe() is coll          # idempotent
        merged = coll.scrape()
        # the merged token counter is the sum over both workers' own
        texts = [WorkerClient(w.url).metrics_text() for w in (w1, w2)]
        want = sum(sum(v for _l, v in parse_prometheus(t)
                       ["serving_tokens_emitted_total"]["samples"])
                   for t in texts)
        got = sum(ch.value for _v, ch in
                  merged.get("serving_tokens_emitted_total")._samples())
        assert got == want and got >= len(reqs)
        # the JAX parser reads a port worker's exposition the same way
        assert all(parse_prometheus(t) == jax_observe.parse_prometheus(t)
                   for t in texts)
        fz = coll.fleetz()
        assert {r["worker_id"] for r in fz["workers"]} == {"wm1", "wm2"}
        for row in fz["workers"]:
            assert row["state"] == "ok" and row["scrape_errors"] == 0
            assert row["steady_state_compiles"] == 0
            assert row["pid"] == os.getpid()
        assert fz["fleet"]["workers_total"] == 2
        assert fz["fleet"]["workers_stale"] == 0
        assert fz["router"]["workers_up"] == 2
        assert fz["cycles"] >= 1
        # the /fleetz route serves this collector's payload
        srv = telemetry.IntrospectionServer(0)
        try:
            with urllib.request.urlopen(srv.url + "/fleetz",
                                        timeout=30) as r:
                assert r.status == 200
                body = json.loads(r.read())
            assert body["collector"] == coll.cid
            assert len(body["workers"]) == 2
        finally:
            srv.close()
    finally:
        if router is not None:
            router.close()             # closes + unregisters collector
            assert router.collector is None
        w1.close(), w2.close()
    srv = telemetry.IntrospectionServer(0)
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(srv.url + "/fleetz", timeout=30)
        assert ei.value.code == 404
    finally:
        srv.close()


def test_disagg_trace_stitched_across_worker_tracks(net):
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 97, n).tolist() for n in (5, 8)]
    wp, wd = _worker(net, "prefill", "wp"), _worker(net, "decode", "wd")
    router = None
    try:
        router = FleetRouter([wp.url, wd.url])
        reqs = _run(router, prompts, 6, "d")
        assert all(r.status == "finished" for r in reqs)
        coll = router.observe(interval_s=60.0)
        coll.scrape()
        trace = coll.fleet_chrome_trace()
        evs = trace["traceEvents"]
        procs = {e["pid"]: e["args"]["name"] for e in evs
                 if e.get("ph") == "M" and e["name"] == "process_name"}
        assert len(procs) == 2         # one track per worker, even
        names = sorted(procs.values())  # with a shared in-process pid
        assert any("(prefill)" in n for n in names)
        assert any("(decode)" in n for n in names)
        by_trace = {}
        for e in evs:
            if e.get("ph") == "X" and e.get("cat") == "request" \
                    and str(e["args"].get("request_id", "")) \
                    .startswith("d"):
                by_trace.setdefault(e["args"]["trace_id"],
                                    set()).add(e["pid"])
        stitched = [t for t, pids in by_trace.items() if len(pids) >= 2]
        assert len(stitched) == len(reqs)
        # the router's own trace id is the stitched one
        assert {r.trace["trace_id"] for r in reqs} == set(stitched)
        last = {}
        for e in evs:
            if e.get("ph") == "X":
                k = (e["pid"], e["tid"])
                assert e["ts"] >= last.get(k, -math.inf)
                last[k] = e["ts"]
        assert trace["otherData"]["clock_offsets_s"].keys() \
            == {"wp", "wd"}
        # the module function assembles the same tracks and stitches
        # from the workers' snapshots (the collector's background cycle
        # may re-measure the clock offsets meanwhile, so timestamps are
        # not compared)
        snaps = [{"worker_id": w.worker_id, "role": w.role, "pid": w.pid,
                  "offset": w.offset, "requests": w.requests}
                 for w in coll.workers]
        again = fleet_chrome_trace(snaps, collector=coll.cid)["traceEvents"]
        assert {e["pid"]: e["args"]["name"] for e in again
                if e.get("ph") == "M"
                and e["name"] == "process_name"} == procs
        assert sorted((e["pid"], e["args"]["trace_id"]) for e in again
                      if e.get("ph") == "X" and e.get("cat") == "request") \
            == sorted((e["pid"], e["args"]["trace_id"]) for e in evs
                      if e.get("ph") == "X" and e.get("cat") == "request")
    finally:
        if router is not None:
            router.close()
        wp.close(), wd.close()


def test_fleet_slo_fast_burn_latches_one_correlated_dump(net, tmp_path):
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 97, n).tolist() for n in (4, 7, 5)]
    w1, w2 = _worker(net, "mixed", "wx"), _worker(net, "mixed", "wy")
    router = coll = None
    try:
        router = FleetRouter([w1.url, w2.url])
        reqs = _run(router, prompts, 5, "s")
        # an impossible objective: every observed TTFT is bad, so the
        # fast window burns at once
        coll = FleetCollector(
            [w1.url, w2.url], router=router, interval_s=60.0,
            out_dir=str(tmp_path),
            objectives=[telemetry.SLO("fleet_ttft", ttft_p99_ms=1e-6,
                                      min_events=1)])
        coll.scrape()
        fz = coll.fleetz()
        assert "fleet_ttft" in fz["slo"]["fast_burning"]
        dumps = fz["fleet_dumps"]
        assert len(dumps) == 1         # latched: scrape again, still 1
        coll.scrape()
        assert len(coll.fleetz()["fleet_dumps"]) == 1
        d = dumps[0]
        assert os.path.basename(d).startswith(
            "fleet-slo_fleet_burn-fleet_ttft")
        files = set(os.listdir(d))
        assert {"merged.prom", "trace.json", "fleet.json"} <= files
        for wid in ("wx", "wy"):       # one subdirectory per worker
            sub = set(os.listdir(os.path.join(d, wid)))
            assert {"metrics.prom", "stats.json", "requests.json",
                    "sloz.json", "flightz.json"} <= sub
        with open(os.path.join(d, "fleet.json")) as f:
            assert json.load(f)["reason"] == "slo_fleet_burn:fleet_ttft"
        coll.rearm()
        assert coll.fleet_dump("slo_fleet_burn:fleet_ttft") is not None
        assert len(coll.fleetz()["fleet_dumps"]) == 2
        assert len(reqs) == 3
    finally:
        if coll is not None:
            coll.close()
        if router is not None:
            router.close()
        w1.close(), w2.close()


def test_worker_flight_latch_mirrors_exactly_once(net, tmp_path):
    w = _worker(net, "mixed", "wl")
    coll = None
    try:
        coll = FleetCollector([w.url], interval_s=60.0,
                              out_dir=str(tmp_path))
        coll.scrape()
        view = coll.workers[0]
        view.flightz = {"latched": ["stall:engine9"]}
        coll._mirror_worker_latches()
        coll._mirror_worker_latches()  # the same latch: still one dump
        dumps = coll.fleetz()["fleet_dumps"]
        assert len(dumps) == 1
        assert "worker-wl-stall-engine9" in os.path.basename(dumps[0])
    finally:
        if coll is not None:
            coll.close()
        w.close()


def test_dead_worker_goes_stale_without_blocking(net, tmp_path):
    w1, w2 = _worker(net, "mixed", "wu"), _worker(net, "mixed", "wv")
    coll = FleetCollector([w1.url, w2.url], interval_s=0.05,
                          scrape_timeout_s=2.0, out_dir=str(tmp_path))
    try:
        coll.scrape()
        assert all(r["state"] == "ok" for r in coll.fleetz()["workers"])
        w2.close()
        coll.scrape()                  # must not raise
        rows = {r["worker_id"]: r for r in coll.fleetz()["workers"]}
        assert rows["wu"]["state"] == "ok"
        assert rows["wv"]["state"] == "stale"
        assert rows["wv"]["scrape_errors"] >= 1
        assert rows["wv"]["last_error"]
        assert coll.fleetz()["fleet"]["workers_stale"] == 1
        # the dead worker's last good families still feed the merge
        assert 'worker_id="wv"' in coll.merged.render_prometheus()
        # the background loop keeps cycling past the dead worker
        coll.start()
        cycles = coll.fleetz()["cycles"]
        deadline = time.monotonic() + 10
        while coll.fleetz()["cycles"] < cycles + 2 \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        assert coll.fleetz()["cycles"] >= cycles + 2
    finally:
        coll.close()
        w1.close()
