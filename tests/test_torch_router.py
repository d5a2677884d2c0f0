"""The port's in-process ServingRouter against the JAX package's.

On weights carried across from a seeded JAX tiny GPT-2 (attn_impl="xla"
on the JAX side), routers over port engines and over JAX engines of the
same geometry take the same requests and the same ReplicaFaultPlan:

  * placement: the rendezvous hash puts each prompt (with or without an
    adapter id) on the same replica index, and load-aware spill moves
    the same request;
  * the engine's drain/undrain/adopt/export_requests seams: greedy
    streams exported mid-decode and adopted by a second engine equal
    JAX's and the uninterrupted run's, each one stitched trace;
  * per-component /readyz while one replica drains;
  * drain and rejoin, and a rolling restart (drain with migration,
    mark_warm, rejoin) after which new work lands on the replica again;
  * hedges: the hedge wins over a wedged primary and the primary over
    its hedge, with JAX's streams and counters;
  * a replica kill mid-decode on float32 and int8 pages: greedy streams,
    statuses and router counters equal the JAX router's; sampled
    streams (the port's own sampler) equal the port's fault-free run;
    one `replica_down:` flight dump, clean page audits;
  * the aggregated rejection: retry-after the minimum over replicas, no
    shed counted twice, reasons and counts equal JAX's;
  * a seeded chaos soak (kill, hang, poison; port only) that loses no
    accepted request against the port's fault-free run;
  * a KernelError inside one replica's dispatch leaves router.step()
    and migrates nothing (the reference has no fatal class).

Token streams and counters are held exactly. Every JAX engine and
router stays alive until the module ends; the module fixture drops them
and collects garbage at teardown.
"""
import gc
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402
import mxnet_tpu.serving as jax_serving  # noqa: E402
from mxnet_tpu import telemetry as jax_telemetry  # noqa: E402
from mxnet_tpu.models import GPT2Config as JaxConfig  # noqa: E402
from mxnet_tpu.models import GPT2ForCausalLM as JaxGPT2  # noqa: E402
from mxnet_tpu.telemetry import server as jax_tserver  # noqa: E402
import mxnet_tpu_torch.serving as port_serving  # noqa: E402
from mxnet_tpu_torch import telemetry as port_telemetry  # noqa: E402
from mxnet_tpu_torch.models import (GPT2Config, GPT2ForCausalLM,  # noqa: E402
                                    load_jax_params)
from mxnet_tpu_torch.ops._build import KernelError  # noqa: E402
from mxnet_tpu_torch.telemetry import server as port_tserver  # noqa: E402

KW = dict(vocab_size=97, units=32, num_layers=2, num_heads=2,
          max_length=64, dropout=0.0, attention_dropout=0.0)
ENGINE = dict(num_slots=2, max_length=32, page_size=8, decode_block=2)
# int8 numerics depend on where prefill chunks end: a budget no dispatch
# reaches keeps every request on its natural chunk grid, whatever it is
# co-batched with
INT8 = dict(kv_dtype="int8", prefill_chunk_budget=64)


@pytest.fixture(scope="module")
def sides():
    gc.collect()
    jnet = JaxGPT2(JaxConfig(**KW))
    mx.rng.seed(3)
    jnet.initialize(mx.init.Normal(0.05))
    arrays = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    net = load_jax_params(GPT2ForCausalLM(GPT2Config(**KW), device="cpu"),
                          arrays)
    alive = []

    def keep(obj):
        alive.append(obj)
        return obj

    def side(name, mod, tel, tserver, make):
        return SimpleNamespace(
            name=name, engine=lambda **kw: keep(make(**dict(ENGINE, **kw))),
            router=lambda engines, **kw: keep(mod.ServingRouter(engines,
                                                                **kw)),
            Request=mod.Request, ReplicaFaultPlan=mod.ReplicaFaultPlan,
            FaultPlan=mod.FaultPlan, QueueFullError=mod.QueueFullError,
            ShedError=mod.ShedError, telemetry=tel, tserver=tserver)
    out = {"jax": side("jax", jax_serving, jax_telemetry, jax_tserver,
                       lambda **kw: jax_serving.ServingEngine(
                           jnet, attn_impl="xla", **kw)),
           "port": side("port", port_serving, port_telemetry, port_tserver,
                        lambda **kw: port_serving.ServingEngine(
                            net, device="cpu", **kw))}
    yield out
    # the engines die here, not inside a later module's engine build
    out.clear()
    alive.clear()
    gc.collect()


def _both(sides, run):
    """run(side) on the JAX router and on the port's; (want, got)."""
    return run(sides["jax"]), run(sides["port"])


def _reqs(side, n=8, max_new=6, prompt_seed=7, seed_base=100,
          sampled=False):
    rng = np.random.default_rng(prompt_seed)
    out = []
    for i in range(n):
        prompt = rng.integers(1, 97, size=int(rng.integers(3, 9)))
        out.append(side.Request(prompt, max_new, request_id=f"r{i}",
                                do_sample=sampled, temperature=0.9,
                                seed=seed_base + i))
    return out


def _outputs(done):
    return {r.id: list(r.output_tokens) for r in done
            if r.status == "finished"}


def _results(done):
    return {r.id: (r.status, list(r.output_tokens)) for r in done}


def _drive(router, steps=20000):
    n, done = 0, []
    while router.has_work and n < steps:
        done.extend(router.step())
        n += 1
    assert n < steps, "router did not converge"
    return done


def _serve_alone(side, reqs, **kw):
    """The fault-free oracle: one engine with the fleet's slots."""
    return _results(side.engine(num_slots=4, **kw).serve(reqs))


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

def _placement(side):
    R = side.Request
    engines = [side.engine() for _ in range(3)]
    router = side.router(engines)
    cands = [0, 1, 2]
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, 97, size=10) for _ in range(32)]
    places = [router._affinity_idx(R(p, 4, request_id=f"p{i}"), cands)
              for i, p in enumerate(prompts)]
    adapters = [router._affinity_idx(
        R(p, 4, request_id=f"a{i}", adapter_id=f"ad{i % 3}"), cands)
        for i, p in enumerate(prompts[:12])]
    shrunk = [router._affinity_idx(R(p, 4, request_id=f"s{i}"), [0, 2])
              for i, p in enumerate(prompts)]
    page = list(np.random.default_rng(5).integers(1, 97, size=8))
    a = router._affinity_idx(R(page + [3, 4], 4, request_id="a"), cands)
    same = [router._affinity_idx(R(page + t, 4, request_id=f"t{len(t)}"),
                                 cands) for t in ([], [50], [60, 61, 62])]
    for i in range(2):
        router.submit(R(page + [i], 6, request_id=f"q{i}"))
    router.submit(R(page + [9], 6, request_id="spill"))
    owners = {rid: router._owner[rid][0] for rid in ("q0", "q1", "spill")}
    done = _drive(router)
    return dict(places=places, adapters=adapters, shrunk=shrunk, a=a,
                same=same, owners=owners, results=_results(done),
                stats=router.stats,
                audits=[e.audit_pages() for e in engines])


def test_placement_and_spill_match_jax(sides):
    want, got = _both(sides, _placement)
    assert got == want
    assert len(set(got["places"])) >= 2
    # a replica leaving the set moves only the keys it owned
    assert all(s == p for s, p in zip(got["shrunk"], got["places"])
               if p != 1)
    assert got["same"] == [got["a"]] * 3
    assert got["owners"]["q0"] == got["owners"]["q1"] == got["a"]
    assert got["owners"]["spill"] != got["a"]
    assert got["stats"]["spill"] >= 1
    assert {s for s, _ in got["results"].values()} == {"finished"}
    assert got["audits"] == [[], [], []]


# ---------------------------------------------------------------------------
# the engine's seams: drain / undrain / export / adopt
# ---------------------------------------------------------------------------

def _seams(side):
    R = side.Request
    eng = side.engine()
    reqs = _reqs(side, 4)
    for r in reqs:
        eng.submit(r)
    for _ in range(2):
        eng.step()
    eng.drain()
    with pytest.raises(side.ShedError) as ei:
        eng.submit(R([1, 2, 3], 4, request_id="late"))
    n = 0
    while eng.has_work and n < 5000:
        eng.step()
        n += 1
    drain = dict(reason=ei.value.reason,
                 has_retry=hasattr(ei.value, "retry_after_s"),
                 drained=eng.drained, ready=eng.is_ready(),
                 results=_results(reqs), audit=eng.audit_pages())
    eng.undrain()
    drain["after"] = eng.serve([R([1, 2, 3], 4, request_id="after")])[0] \
        .status

    src, dst = side.engine(), side.engine()
    side.telemetry.request_log.clear()
    moving = _reqs(side, 4, prompt_seed=19)
    for r in moving:
        src.submit(r)
    for _ in range(4):
        src.step()
    emitted = [len(r.output_tokens) for r in moving]
    moved = src.export_requests()
    export = dict(order=[r.id for r in moved],
                  statuses=[r.status for r in moved], emitted=emitted,
                  src_work=src.has_work, src_audit=src.audit_pages(),
                  src_free=src.scheduler.num_free)
    for r in moved:
        dst.adopt(r, migrated_from=f"engine{src._eid}")
    done = []
    while dst.has_work:
        done.extend(dst.step())
    traces = [t for t in side.telemetry.request_log.recent(64)
              if t["request_id"] == "r0"]
    by_engine = {t["engine"]: t for t in traces}
    old, new = by_engine[src._eid], by_engine[dst._eid]
    export.update(
        results=_results(done), dst_audit=dst.audit_pages(),
        stitched=(old["status"] == "migrated"
                  and new.get("migrated_from") == f"engine{src._eid}"
                  and new["trace_id"] == old["trace_id"]
                  and new["t_begin"] == old["t_begin"]
                  and new.get("resumed_tokens") == emitted[0]),
        oracle=_serve_alone(side, _reqs(side, 4, prompt_seed=19)))
    return drain, export, _serve_alone(side, _reqs(side, 4))


def test_engine_seams_drain_export_adopt_match_jax(sides):
    want, got = _both(sides, _seams)
    assert got == want
    drain, export, oracle = got
    assert drain["reason"] == "draining" and drain["has_retry"]
    assert drain["drained"] and not drain["ready"]
    assert drain["results"] == oracle and drain["audit"] == []
    assert drain["after"] == "finished"
    assert export["order"] == ["r0", "r1", "r2", "r3"]
    assert set(export["statuses"]) == {"exported"}
    assert max(export["emitted"]) >= 2       # exported mid-decode
    assert not export["src_work"] and export["src_audit"] == []
    assert export["src_free"] == ENGINE["num_slots"]
    assert export["results"] == export["oracle"]
    assert export["dst_audit"] == [] and export["stitched"]


def test_readyz_per_component_draining_replica_stays_healthy(sides):
    side = sides["port"]
    e0, e1 = side.engine(), side.engine()
    e0.mark_warm()
    e1.mark_warm()
    e1.drain()
    name0, name1 = f"engine{e0._eid}", f"engine{e1._eid}"
    assert port_tserver.component_ready(name0)
    assert not port_tserver.component_ready(name1)
    st = port_tserver.readiness()[name1]
    assert st["draining"] and st["warmed"] and not st["degraded"]
    srv = port_telemetry.IntrospectionServer(0)
    try:
        def get(path):
            try:
                with urllib.request.urlopen(srv.url + path,
                                            timeout=30) as r:
                    return r.status, r.read()
            except urllib.error.HTTPError as e:
                return e.code, e.read()
        code, body = get("/healthz")
        assert code == 200 and body == b"ok\n"
        code, body = get("/readyz")
        assert code == 200 and b'"ready": true' in body
        code, body = get(f"/readyz?component={name1}")
        assert code == 503 and b'"ready": false' in body
        assert get(f"/readyz?component={name0}")[0] == 200
    finally:
        srv.close()
    e1.undrain()
    assert port_tserver.component_ready(name1)


# ---------------------------------------------------------------------------
# drain / rejoin and the rolling restart
# ---------------------------------------------------------------------------

def _drain_rejoin(side):
    engines = [side.engine(), side.engine()]
    router = side.router(engines)
    router.drain(0)
    out = dict(drains=router.stats["drains"], routable=router._routable())
    reqs = _reqs(side, 5)
    for r in reqs:
        router.submit(r)
    out["owners"] = [router._owner[r.id][0] for r in reqs]
    out["results"] = _results(_drive(router))
    out["audits"] = [e.audit_pages() for e in engines]
    router.rejoin(0)
    out["rejoined"] = sorted(router._routable())

    # rolling restart: drain replica 0 with migration mid-serve, warm it,
    # rejoin it, and send it new work
    rolling = _reqs(side, 5, prompt_seed=19)
    done = []
    for r in rolling:
        router.submit(r)
    for _ in range(3):
        done.extend(router.step())
    out["before"] = [router._owner[r.id][0] for r in rolling
                     if r.id in router._owner]
    router.drain(0, migrate=True)
    out["emptied"] = not engines[0].scheduler.has_work
    engines[0].mark_warm()
    router.rejoin(0)
    late = [side.Request(r.prompt, 6, request_id=f"late{i}")
            for i, r in enumerate(_reqs(side, 4, prompt_seed=23))]
    for r in late:
        router.submit(r)
    out["late_owners"] = [router._owner[r.id][0] for r in late]
    done.extend(_drive(router))
    out.update(rolling=_results(done), stats=router.stats,
               audits2=[e.audit_pages() for e in engines],
               oracle=_serve_alone(side, _reqs(side, 5)),
               oracle2=_serve_alone(side, _reqs(side, 5, prompt_seed=19)
                                    + [side.Request(r.prompt, 6,
                                                    request_id=f"late{i}")
                                       for i, r in enumerate(_reqs(
                                           side, 4, prompt_seed=23))]))
    return out


def test_drain_rejoin_and_rolling_restart_match_jax(sides):
    want, got = _both(sides, _drain_rejoin)
    assert got == want
    assert got["drains"] == 1 and got["routable"] == [1]
    assert got["owners"] == [1] * 5
    assert got["results"] == got["oracle"]
    assert got["audits"] == got["audits2"] == [[], []]
    assert got["rejoined"] == [0, 1]
    assert 0 in got["before"] and got["emptied"]
    assert got["stats"]["migrated"] >= 1 and got["stats"]["drains"] == 2
    assert 0 in got["late_owners"]            # back in the rotation
    assert got["rolling"] == got["oracle2"]


# ---------------------------------------------------------------------------
# hedged dispatch
# ---------------------------------------------------------------------------

def _hedges(side):
    out = {}
    # direction 1: the primary wedges, the hedge wins
    engines = [side.engine(), side.engine()]
    router = side.router(engines, hedge_after_s=0.0, watchdog_ticks=10 ** 6)
    req = _reqs(side, 1)[0]
    router.submit(req)
    primary = router._owner[req.id][0]
    plan = side.ReplicaFaultPlan(hang={1: primary},
                                 hang_ticks=None).install(router)
    done = _drive(router)
    plan.uninstall()
    out["won"] = dict(ids=[r.id for r in done], results=_results(done),
                      stats=router.stats, primary=primary,
                      cancelled=engines[primary].stats["requests_cancelled"],
                      audits=[e.audit_pages() for e in engines])
    # direction 2: nothing is wrong, the primary wins
    engines = [side.engine(), side.engine()]
    router = side.router(engines, hedge_after_s=0.0, watchdog_ticks=10 ** 6)
    req = _reqs(side, 1, prompt_seed=23)[0]
    router.submit(req)
    primary = router._owner[req.id][0]
    done = _drive(router)
    out["wasted"] = dict(
        ids=[r.id for r in done], results=_results(done), stats=router.stats,
        primary=primary,
        cancelled=engines[1 - primary].stats["requests_cancelled"],
        audits=[e.audit_pages() for e in engines])
    out["oracle"] = (_serve_alone(side, _reqs(side, 1)),
                     _serve_alone(side, _reqs(side, 1, prompt_seed=23)))
    return out


def test_hedge_winner_cancels_loser_both_directions_like_jax(sides):
    want, got = _both(sides, _hedges)
    assert got == want
    won, wasted = got["won"], got["wasted"]
    assert won["ids"] == ["r0"] and won["results"] == got["oracle"][0]
    assert (won["stats"]["hedges"], won["stats"]["hedges_won"],
            won["stats"]["hedges_wasted"]) == (1, 1, 0)
    assert won["cancelled"] == 1 and won["audits"] == [[], []]
    assert wasted["ids"] == ["r0"]
    assert wasted["results"] == got["oracle"][1]
    assert (wasted["stats"]["hedges"], wasted["stats"]["hedges_won"],
            wasted["stats"]["hedges_wasted"]) == (1, 0, 1)
    assert wasted["cancelled"] == 1 and wasted["audits"] == [[], []]


# ---------------------------------------------------------------------------
# failover: a replica killed mid-decode
# ---------------------------------------------------------------------------

def _schedules(done, page_size):
    """int8 pages: each request's KV write schedule (tokens attached from
    the prefix cache, on the chunk grid, then the chunks fed, then one
    token a decode), over every position it wrote."""
    out = {}
    for r in done:
        plan, head = [], int(r.kv_attach)
        while head > 0:
            plan.append(min(head, page_size))
            head -= plan[-1]
        plan += [int(c) for c in r.kv_history]
        total = r.prompt_len + len(r.output_tokens) - 1
        out[r.id] = plan + [1] * (total - sum(plan))
    return out


def _kill(side, ekw, sampled, out_dir):
    engines = [side.engine(**ekw), side.engine(**ekw)]
    router = side.router(engines)
    side.telemetry.request_log.clear()
    rec = side.telemetry.flight.install(out_dir=out_dir, stall_timeout=1e9,
                                        queue_full_threshold=10 ** 6)
    plan = side.ReplicaFaultPlan(kill={4: 0}).install(router)
    try:
        for r in _reqs(side, 10, sampled=sampled):
            router.submit(r)
        done = _drive(router)
        latched = list(rec.latched)
        dumps = len(rec.dumps)
    finally:
        plan.uninstall()
        side.telemetry.flight.uninstall()
    recent = side.telemetry.request_log.recent(200)
    alone = side.engine(num_slots=4, **ekw).serve(
        _reqs(side, 10, sampled=sampled))
    quant = ekw.get("kv_dtype") == "int8"
    return dict(
        schedules=_schedules(done, ENGINE["page_size"]) if quant else None,
        oracle_schedules=_schedules(alone, ENGINE["page_size"])
        if quant else None,
        results=_results(done), kills=plan.counts["kill"],
        state=(router.replicas[0].state, router.replicas[0].down_reason),
        stats=router.stats, audits=[e.audit_pages() for e in engines],
        latched=[r.replace(f"engine{engines[0]._eid}", "engine<0>")
                 for r in latched if r.startswith("replica_down:")],
        dumps=dumps,
        ready0=side.tserver.component_ready(f"engine{engines[0]._eid}"),
        migrated_traces=sum(1 for t in recent if t.get("migrated_from")),
        ended_migrated=sum(1 for t in recent if t["status"] == "migrated"),
        oracle=_results(alone))


def _held_kill(got):
    # int8 pages: a migrated request replays the write schedule it had
    # (its page scales come out byte-identical)
    assert got["schedules"] == got["oracle_schedules"]
    assert got["kills"] == 1 and got["state"] == ("down", "kill")
    assert {s for s, _ in got["results"].values()} == {"finished"}
    assert len(got["results"]) == 10
    assert got["results"] == got["oracle"]
    assert got["stats"]["migrated"] >= 1
    assert got["stats"]["replica_down"] == {"kill": 1}
    assert got["audits"] == [[], []]
    assert got["latched"] == ["replica_down:engine<0>"] and got["dumps"] == 1
    assert not got["ready0"]
    assert got["migrated_traces"] >= 1
    assert got["ended_migrated"] == got["migrated_traces"]


@pytest.mark.parametrize("pages", ["float32", "int8"])
def test_replica_kill_greedy_migrates_like_jax(sides, pages, tmp_path):
    ekw = INT8 if pages == "int8" else {}
    want, got = _both(sides, lambda side: _kill(
        side, ekw, False, str(tmp_path / side.name)))
    assert got == want
    _held_kill(got)


@pytest.mark.parametrize("pages", ["float32", "int8"])
def test_replica_kill_sampled_equals_fault_free_run(sides, pages, tmp_path):
    got = _kill(sides["port"], INT8 if pages == "int8" else {}, True,
                str(tmp_path))
    _held_kill(got)


# ---------------------------------------------------------------------------
# the aggregated rejection
# ---------------------------------------------------------------------------

def _rejections(side):
    R = side.Request
    engines = [side.engine(max_queue=2), side.engine(max_queue=2)]
    router = side.router(engines)
    for r in _reqs(side, 4):           # a finish history: real estimates
        router.submit(r)
    _drive(router)
    shed_before = [e.stats["shed"] for e in engines]
    accepted = []
    for r in _reqs(side, 12, prompt_seed=31):
        try:
            router.submit(r)
            accepted.append(r.id)
        except side.QueueFullError:
            break
    with pytest.raises(side.QueueFullError) as ei:
        router.submit(R([5, 6, 7], 4, request_id="over"))
    err = ei.value
    waits = [w for w in (e.estimated_queue_wait() for e in engines)
             if w is not None]
    out = dict(accepted=accepted, reason=err.reason, has_waits=bool(waits),
               retry_is_min=bool(waits) and err.retry_after_s
               == pytest.approx(min(waits)),
               shed_before=shed_before,
               shed_after=[e.stats["shed"] for e in engines],
               router_shed=dict(router.stats["shed"]))
    out["results"] = _results(_drive(router))
    out["audits"] = [e.audit_pages() for e in engines]
    router.drain(0)
    router.drain(1)
    with pytest.raises(side.ShedError) as ei2:
        router.submit(R([1, 2], 2, request_id="noone"))
    out.update(reason2=ei2.value.reason,
               has_retry2=hasattr(ei2.value, "retry_after_s"),
               stats=router.stats)
    return out


def test_aggregated_retry_after_counts_each_shed_once_like_jax(sides):
    want, got = _both(sides, _rejections)
    assert got == want
    assert got["reason"] == "queue_full"
    assert got["has_waits"] and got["retry_is_min"]
    assert got["shed_after"] == got["shed_before"]
    assert got["router_shed"]["queue_full"] >= 1
    assert {s for s, _ in got["results"].values()} == {"finished"}
    assert got["audits"] == [[], []]
    assert got["reason2"] == "no_ready_replica" and got["has_retry2"]
    assert got["stats"]["shed"] == dict(got["router_shed"],
                                        no_ready_replica=1)


# ---------------------------------------------------------------------------
# chaos soak: Poisson arrivals, kill + hang + poison across the fleet
# ---------------------------------------------------------------------------

def test_chaos_soak_kill_hang_poison_loses_no_request(sides, tmp_path):
    side = sides["port"]
    N = 104
    poison = {"c17": "both", "c61": "decode", "c88": "prefill"}

    def mk():
        rng = np.random.default_rng(11)
        reqs = []
        for i in range(N):
            prompt = rng.integers(1, 97, size=int(rng.integers(2, 10)))
            # decode-phase poison gains one token per re-prefill cycle: a
            # budget beyond max_retries makes quarantine win
            n_new = 12 if i == 61 else int(rng.integers(2, 7))
            reqs.append(side.Request(prompt, n_new, request_id=f"c{i}",
                                     do_sample=True, temperature=0.8,
                                     seed=1000 + i))
        return reqs

    want = _outputs(side.engine(num_slots=4).serve(mk()))
    assert len(want) == N
    engines = [side.engine(max_retries=6, retry_backoff_s=0.0)
               for _ in range(3)]
    # hedging off: a hedge clone's id is not in the poison map, so a
    # poisoned request could leave through its clone
    router = side.router(engines, hedge_min_samples=10 ** 9,
                         watchdog_ticks=6)
    rec = side.telemetry.flight.install(out_dir=str(tmp_path),
                                        stall_timeout=1e9,
                                        queue_full_threshold=10 ** 6)
    rplan = side.ReplicaFaultPlan(kill={20: 0}, hang={45: 1},
                                  hang_ticks=None).install(router)
    eplans = [side.FaultPlan(poison=dict(poison)).install(e)
              for e in engines]
    arrivals = np.random.default_rng(13)
    pending = mk()[::-1]
    done, shed, steps = [], [], 0
    try:
        while (pending or router.has_work) and steps < 20000:
            for _ in range(int(arrivals.poisson(2.0))):
                if pending:
                    r = pending.pop()
                    try:
                        router.submit(r)
                    except (side.QueueFullError, side.ShedError):
                        shed.append(r)
            done.extend(router.step())
            steps += 1
        latched = list(rec.latched)
    finally:
        rplan.uninstall()
        for p in eplans:
            p.uninstall()
        side.telemetry.flight.uninstall()
    assert steps < 20000, "chaos soak did not converge"
    assert rplan.counts["kill"] == 1 and rplan.counts["hang"] >= 1
    assert router.stats["replica_down"] == {"kill": 1, "stall": 1}
    assert router.stats["migrated"] >= 1
    got = _outputs(done)
    shed_ids = {r.id for r in shed}
    assert all(r.status == "shed" for r in shed)
    failed_ids = {r.id for r in done if r.status == "failed"}
    assert failed_ids <= set(poison)
    assert got == {k: v for k, v in want.items()
                   if k not in failed_ids and k not in shed_ids}
    assert len(got) + len(shed_ids) + len(failed_ids) == N
    for eng in engines:
        assert eng.audit_pages() == []
    down = [r for r in latched if r.startswith("replica_down:")]
    assert sorted(down) == sorted(f"replica_down:engine{e._eid}"
                                  for e in engines[:2])


# ---------------------------------------------------------------------------
# a fatal error is not a replica death
# ---------------------------------------------------------------------------

def test_kernel_error_leaves_router_step_and_migrates_nothing(sides):
    """Replicas share one process and one CUDA context: a kernel error in
    one would fail again on a survivor, so router.step() re-raises it
    (the engine latched it) instead of declaring the replica down."""
    side = sides["port"]
    engines = [side.engine(), side.engine()]
    router = side.router(engines)
    reqs = _reqs(side, 4)
    for r in reqs:
        router.submit(r)
    victim = router._owner["r0"][0]
    decodes = []

    def hook(engine, phase, requests):
        if phase == "decode":
            decodes.append(phase)
            if len(decodes) == 3:
                raise KernelError("ragged_attention: launch failed")
    engines[victim].dispatch_hook = hook
    with pytest.raises(KernelError):
        for _ in range(100):
            router.step()
    assert len(decodes) == 3
    st = router.stats
    assert st["migrated"] == 0 and st["replica_down"] == {}
    assert [rep.state for rep in router.replicas] == ["up", "up"]
    assert engines[victim]._fatal_error and not engines[victim].is_ready()
    # the victim's requests were not exported: still owned there, still in
    # its scheduler
    mine = [rid for rid, (idx, _) in router._owner.items() if idx == victim]
    assert "r0" in mine
    held = set(engines[victim].scheduler.queued_ids) | {
        engines[victim].scheduler.request_at(s).id
        for s in engines[victim].scheduler.active_slots}
    assert set(mine) <= held
    assert all(r.status != "exported" for r in reqs)
