"""The port's cross-process serving fleet against the JAX package's.

On weights carried across from the seeded JAX tiny GPT-2 of
tests/test_fleet.py (the same _CONFIG and _ENGINE; attn_impl="xla" on
the JAX side):

  * the wire: blobs round-trip byte for byte, and a port blob and a JAX
    blob of the same request are the same bytes, with float32 and int8
    KV payloads (each package decodes and re-encodes the other's);
  * the handoff seam across packages: a JAX export_handoff shipped
    through the JAX wire is adopted by a port engine, and a port payload
    by a JAX engine, in float32 and int8 pages; greedy streams equal the
    uninterrupted JAX run, with an adopted_payload event and no
    re-prefill;
  * bfloat16 payloads: the port ships them as 2-byte bit patterns and
    adopts its own (and the reference's '|V2' leaves) with no fallback,
    where the JAX engine falls back to the replay restart;
  * the in-process HTTP fleet, mixed and disaggregated (with and without
    the payload): greedy streams equal the JAX engine's serve, sampled
    streams the port's single engine; the handoff phase and
    steady_state_compiles 0; a wire-version mismatch answered 409;
  * the control plane (drain/undrain/stats) and the router refusing
    mixed chunk grids;
  * rendezvous placement equal to the JAX FleetRouter's over the same
    workers, and the JAX FleetRouter driving port workers;
  * real worker processes: two CPU workers, one SIGKILLed mid-decode,
    every stream equal to the uninterrupted port run (the int8 and w8
    kills and the disaggregated pair of processes run in the slow lane,
    as tests/test_fleet.py runs them).

Token streams and counters are held exactly. Every wait is bounded in
code (result timeouts, RPC timeouts, ready_timeout_s), and every worker,
router and process is closed in `finally`. Every JAX engine stays alive
until the module ends; the module fixture drops them and collects
garbage at teardown.
"""
import gc
import time
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402
import mxnet_tpu.serving as jax_serving  # noqa: E402
from mxnet_tpu import telemetry as jax_telemetry  # noqa: E402
from mxnet_tpu.models import GPT2Config as JaxConfig  # noqa: E402
from mxnet_tpu.models import GPT2ForCausalLM as JaxGPT2  # noqa: E402
from mxnet_tpu.serving.fleet import FleetRouter as JaxFleetRouter  # noqa: E402
from mxnet_tpu.serving.fleet import wire as jax_wire  # noqa: E402
import mxnet_tpu_torch.serving as port_serving  # noqa: E402
from mxnet_tpu_torch import telemetry as port_telemetry  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.models import (GPT2Config, GPT2ForCausalLM,  # noqa: E402
                                    load_jax_params)
from mxnet_tpu_torch.serving import ServingEngine, TokenStream  # noqa: E402
from mxnet_tpu_torch.serving.fleet import (  # noqa: E402
    FleetRouter, FleetWorker, WorkerClient, WorkerRejected, build_engine,
    launch, spawn_fleet, warm_engine, wire)

_CONFIG = dict(vocab_size=97, units=32, num_layers=2, num_heads=2,
               max_length=64, dropout=0.0, attention_dropout=0.0)
_ENGINE = dict(num_slots=2, max_length=32, page_size=8)
_SPEC = {"config": _CONFIG, "seed": 3, "init_std": 0.05,
         "engine": _ENGINE}
# the subprocess cases: 48-token generations, so that a kill after the
# second token lands mid-decode with room to spare
_KILL_SPEC = dict(_SPEC, engine=dict(_ENGINE, max_length=64))
_KILL_NEW = 48
_RESULT_S = 60


@pytest.fixture(scope="module")
def world():
    gc.collect()
    jnet = JaxGPT2(JaxConfig(**_CONFIG))
    mx.rng.seed(3)
    jnet.initialize(mx.init.Normal(0.05))
    arrays = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    cfg = GPT2Config(**_CONFIG)
    net = load_jax_params(GPT2ForCausalLM(cfg, device="cpu"), arrays)
    alive = []

    def jax_engine(**kw):
        eng = jax_serving.ServingEngine(jnet, attn_impl="xla",
                                        **dict(_ENGINE, **kw))
        alive.append(eng)
        return eng

    def port_engine(**kw):
        return ServingEngine(net, device="cpu", **dict(_ENGINE, **kw))

    refs = {}

    def jax_ref(**kw):
        """The uninterrupted JAX run of _PROMPT (8 greedy tokens) on an
        engine with `kw`, served once per module."""
        key = tuple(sorted(kw.items()))
        if key not in refs:
            r = _mk(jax_serving, _PROMPT, 8, request_id="ref")
            jax_engine(**kw).serve([r])
            assert r.status == "finished" and len(r.output_tokens) == 8
            refs[key] = [int(t) for t in r.output_tokens]
        return refs[key]

    w = SimpleNamespace(net=net, cfg=cfg, jax_engine=jax_engine,
                        port_engine=port_engine, jax_ref=jax_ref)
    yield w
    # the JAX engines die here, not inside a later module's engine build
    alive.clear()
    gc.collect()


def _mk(mod, prompt, n_new=6, **kw):
    kw.setdefault("request_id", "r")
    return mod.Request(list(prompt), n_new, **kw)


def _events(tel, rid, eid):
    return [e["event"] for t in tel.request_log.recent(256)
            if t["request_id"] == rid and str(t["engine"]) == str(eid)
            for e in t.get("events") or ()]


def _first_token(eng, r):
    eng.submit(r)
    for _ in range(50):
        eng.step()
        if r.output_tokens:
            return
    raise AssertionError(f"{r.id} emitted nothing in 50 steps")


def _drain(eng):
    n = 0
    while eng.has_work and n < 2000:
        eng.step()
        n += 1
    assert n < 2000, "engine did not drain"


# ---------------------------------------------------------------------------
# the wire: byte-for-byte round trips, equal to the JAX package's bytes
# ---------------------------------------------------------------------------

def _variant(mod, name):
    p = list(range(5, 14))
    if name == "plain":
        return _mk(mod, p[:4], request_id="v0")
    r = _mk(mod, p, 8, request_id="v1", do_sample=True, temperature=0.7,
            top_k=11, top_p=0.9, seed=42, eos_token_id=3, priority=0,
            deadline_ms=1500.0, adapter_id="ad1", tenant="t9")
    r.output_tokens = [7, 8, 9]
    r.kv_history = [8, 4]
    r.phases = {"queue_wait": 0.001, "prefill_chunks": 0.02}
    r.trace = {"trace_id": "ab" * 16, "t_begin": 12.5}
    return r


@pytest.mark.parametrize("name", ["plain", "loaded"])
def test_wire_round_trip_byte_identical_and_equal_to_jax(name):
    req = _variant(port_serving, name)
    d1 = wire.encode_request(req)
    b1 = wire.dumps(d1)
    req2 = wire.decode_request(wire.loads(b1))
    d2 = wire.encode_request(req2)
    assert d1 == d2 and wire.dumps(d2) == b1
    assert [int(t) for t in req2.prompt] == [int(t) for t in req.prompt]
    assert req2.output_tokens == list(req.output_tokens)
    assert req2.kv_history == list(req.kv_history or [])
    assert req2.seed == req.seed and req2.do_sample == req.do_sample
    assert req2.token_times == []
    # the JAX package writes the same request as the same bytes, and
    # each package reads the other's blob back to the same bytes
    jb = jax_wire.dumps(jax_wire.encode_request(_variant(jax_serving, name)))
    assert jb == b1
    assert wire.dumps(wire.encode_request(
        wire.decode_request(wire.loads(jb)))) == jb
    assert jax_wire.dumps(jax_wire.encode_request(
        jax_wire.decode_request(jax_wire.loads(b1)))) == b1


def test_wire_version_mismatch_rejects_structurally():
    d = wire.encode_request(_mk(port_serving, [1, 2, 3]))
    assert d["wire_version"] == wire.WIRE_VERSION == jax_wire.WIRE_VERSION
    bad = dict(d, wire_version=99)
    with pytest.raises(wire.WireVersionError) as ei:
        wire.check_version(bad)
    assert ei.value.got == 99 and ei.value.want == wire.WIRE_VERSION
    with pytest.raises(wire.WireVersionError):
        wire.loads(wire.dumps(bad))
    with pytest.raises(MXNetError):
        wire.loads(b"{not json")


def _export(side_engine, mod, kv, prompt, rid, **rkw):
    """A request run to its first token on a fresh engine, then
    export_handoff'ed: (engine, exported request)."""
    eng = side_engine(**kv)
    r = _mk(mod, prompt, 8, request_id=rid, **rkw)
    _first_token(eng, r)
    e = eng.export_handoff(r.id)
    assert e is not None and e.kv_payload is not None
    assert eng.audit_pages() == [] and not eng.has_work
    return eng, e


_KV = {"float32": {}, "int8": {"kv_dtype": "int8"}}
_PROMPT = [5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15]


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_payload_blobs_byte_identical_across_packages(world, kv):
    """A JAX payload blob decoded and re-encoded by the port is the same
    bytes, and a port payload blob re-encoded by the JAX package too;
    both packages ship the same leaves at the same dtypes and shapes."""
    _, je = _export(world.jax_engine, jax_serving, _KV[kv], _PROMPT, "j")
    jb = jax_wire.dumps(jax_wire.encode_request(je))
    got = wire.decode_request(wire.loads(jb))
    assert wire.dumps(wire.encode_request(got)) == jb
    _, pe = _export(world.port_engine,
                    port_serving, _KV[kv], _PROMPT, "p")
    pb = wire.dumps(wire.encode_request(pe))
    back = jax_wire.decode_request(jax_wire.loads(pb))
    assert jax_wire.dumps(jax_wire.encode_request(back)) == pb

    def leaves(blob):
        return [{k: (v["__nd__"]["dtype"], v["__nd__"]["shape"])
                 for k, v in page.items()}
                for page in wire.loads(blob)["kv_payload"]["pages"]]
    assert leaves(pb) == leaves(jb)
    want = {"k", "v", "ks", "vs"} if kv == "int8" else {"k", "v"}
    assert all(set(p) == want for p in leaves(pb))
    assert {p["k"][0] for p in leaves(pb)} == (
        {"|i1"} if kv == "int8" else {"<f4"})
    # the decode cursor agrees too
    for key in ("length", "cur_tok", "remaining", "counters"):
        assert pe.kv_payload[key] == je.kv_payload[key], key
    assert pe.output_tokens == je.output_tokens


@pytest.mark.parametrize("kv", ["float32", "int8"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_cross_package_handoff_continues_like_jax(world, kv, direction):
    """export_handoff on one package -> its wire -> the other's decode ->
    the other's engine adopts the payload and continues: greedy tokens
    equal the uninterrupted JAX run, with an adopted_payload event, no
    fallback and no re-prefill."""
    ref = world.jax_ref(**_KV[kv])
    if direction == "jax_to_port":
        _, e = _export(world.jax_engine, jax_serving, _KV[kv], _PROMPT, "x")
        raw = jax_wire.dumps(jax_wire.encode_request(e))
        req = wire.decode_request(wire.loads(raw))
        dst, tel = world.port_engine(**_KV[kv]), port_telemetry
    else:
        _, e = _export(world.port_engine, port_serving, _KV[kv], _PROMPT, "x")
        raw = wire.dumps(wire.encode_request(e))
        req = jax_wire.decode_request(jax_wire.loads(raw))
        dst, tel = world.jax_engine(**_KV[kv]), jax_telemetry
    assert len(req.output_tokens) == 1
    dst.adopt(req, migrated_from="wire")
    _drain(dst)
    assert req.status == "finished"
    assert list(req.output_tokens) == ref
    evs = _events(tel, "x", dst._eid)
    assert "adopted_payload" in evs and "handoff_fallback" not in evs
    assert dst.stats["prefill_tokens"] == 0
    assert dst.audit_pages() == []
    assert "handoff" in req.phases


def test_bfloat16_payload_lands_in_the_port_and_falls_back_in_jax(world):
    """The port ships bfloat16 pages as '<i2' bit patterns and adopts
    them (and the reference's '|V2' leaves) with no fallback; the JAX
    engine drops the same traffic's payload to the replay restart."""
    bf = {"dtype": "bfloat16"}
    ref = _mk(port_serving, _PROMPT, 8, request_id="ref")
    world.port_engine(**bf).serve([ref])
    _, pe = _export(world.port_engine, port_serving, bf, _PROMPT, "b")
    raw = wire.dumps(wire.encode_request(pe))
    assert {v["__nd__"]["dtype"]
            for page in wire.loads(raw)["kv_payload"]["pages"]
            for v in page.values()} == {"<i2"}
    req = wire.decode_request(wire.loads(raw))
    dst = world.port_engine(**bf)
    dst.adopt(req, migrated_from="wire")
    _drain(dst)
    assert req.output_tokens == ref.output_tokens
    evs = _events(port_telemetry, "b", dst._eid)
    assert "adopted_payload" in evs and "handoff_fallback" not in evs
    assert dst.stats["prefill_tokens"] == 0

    _, je = _export(world.jax_engine, jax_serving, bf, _PROMPT, "jb")
    jraw = jax_wire.dumps(jax_wire.encode_request(je))
    jreq = jax_wire.decode_request(jax_wire.loads(jraw))
    jdst = world.jax_engine(**bf)
    jdst.adopt(jreq, migrated_from="wire")
    _drain(jdst)
    assert list(jreq.output_tokens) == world.jax_ref(**bf)
    jevs = _events(jax_telemetry, "jb", jdst._eid)
    assert "handoff_fallback" in jevs and "adopted_payload" not in jevs
    # the reference's leaves ('<V2' written, '|V2' read) land in a port
    # bfloat16 engine as the same bits
    leaf = jax_wire.loads(jraw)["kv_payload"]["pages"][0]["k"]["__nd__"]
    assert leaf["dtype"] == "<V2"
    preq = wire.decode_request(wire.loads(jraw))
    assert preq.kv_payload["pages"][0]["k"].dtype.str == "|V2"
    assert wire.dumps(wire.encode_request(preq)) != jraw   # '<V2' -> '|V2'
    pdst = world.port_engine(**bf)
    pdst.adopt(preq, migrated_from="wire")
    pdst.step()
    pevs = _events(port_telemetry, "jb", pdst._eid)
    assert "adopted_payload" in pevs and "handoff_fallback" not in pevs
    # the first page holds prompt rows only: its slabs are the shipped
    # bits, untouched by the decode since
    slot = next(s for s in pdst.scheduler.active_slots
                if pdst.scheduler.request_at(s).id == "jb")
    page = int(pdst._table_host[slot][0])
    for name, pool in (("k", pdst._kp), ("v", pdst._vp)):
        shipped = np.asarray(je.kv_payload["pages"][0][name]).view(np.int16)
        assert np.array_equal(pool[:, page].view(torch.int16).numpy(),
                              shipped), name
    _drain(pdst)
    assert preq.status == "finished"


@pytest.mark.parametrize("why", ["geometry", "pool_pressure"])
def test_payload_that_cannot_land_falls_back_to_replay(world, why):
    """A payload that cannot land falls back to the replay restart with a
    handoff_fallback event and still finishes with the uninterrupted
    stream, as in the reference: float32 pages into an int8 engine, or a
    pool whose pages another request holds (the replay then waits for
    pages, as admission backpressure)."""
    out = {}
    for name, mod, make, tel in (
            ("jax", jax_serving, world.jax_engine, jax_telemetry),
            ("port", port_serving, world.port_engine, port_telemetry)):
        src, e = _export(make, mod, {}, _PROMPT, f"f{name}")
        if why == "geometry":
            dst = make(kv_dtype="int8")
        else:
            # four pages: one slot's row, which the hog holds first
            dst = make(hbm_budget_bytes=4 * src.page_pool.page_bytes,
                       retry_backoff_s=0.0)
            dst.submit(_mk(mod, _PROMPT[:9], 20, request_id="hog"))
            dst.step()
        dst.adopt(e, migrated_from="wire")
        _drain(dst)
        evs = _events(tel, f"f{name}", dst._eid)
        out[name] = (e.status, list(e.output_tokens),
                     evs.count("handoff_fallback"), "adopted_payload" in evs,
                     dst.stats["dispatch_retries"], dst.audit_pages())
    assert out["port"] == out["jax"]
    status, tokens, fallbacks, landed, retries, audit = out["port"]
    assert (status, fallbacks, landed, audit) == ("finished", 1, False, [])
    assert (retries > 0) == (why == "pool_pressure")
    assert tokens == world.jax_ref()


def test_export_handoff_none_cases_match_jax(world):
    """export_handoff answers None for an unknown id, a queued request
    and one still mid-prefill, as the reference does."""
    got = {}
    for name, mod, make in (("jax", jax_serving, world.jax_engine),
                            ("port", port_serving, world.port_engine)):
        eng = make(chunk_tokens=2)
        reqs = [_mk(mod, _PROMPT, 4, request_id=f"q{i}") for i in range(3)]
        for r in reqs:
            eng.submit(r)
        eng.step()
        got[name] = [eng.export_handoff("nope")] + [
            eng.export_handoff(r.id) for r in reqs]
        _drain(eng)
    assert got["port"] == got["jax"] == [None] * 4


# ---------------------------------------------------------------------------
# the in-process HTTP fleet
# ---------------------------------------------------------------------------

def _worker(world, role, warm=True, wid=None, ship_payload=True, **kw):
    eng = world.port_engine(**kw)
    if warm:
        warm_engine(eng, world.cfg)
    return FleetWorker(eng, role=role, worker_id=wid or f"{role}-t",
                       ship_payload=ship_payload)


def _prompts(seed=0, lens=(5, 11, 3)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 97, n).tolist() for n in lens]


def _traffic(mod, prompts, n_new, tag):
    return [_mk(mod, p, n_new, request_id=f"{tag}{i}", seed=i,
                do_sample=bool(i % 2)) for i, p in enumerate(prompts)]


def _oracle(world, prompts, n_new, **kw):
    """Greedy streams from the JAX engine's serve, sampled ones from the
    port's single engine (the port's own sampler)."""
    jreqs = _traffic(jax_serving, prompts, n_new, "o")
    world.jax_engine(**kw).serve(jreqs)
    preqs = _traffic(port_serving, prompts, n_new, "o")
    world.port_engine(**kw).serve(preqs)
    return {i: list((j if i % 2 == 0 else p).output_tokens)
            for i, (j, p) in enumerate(zip(jreqs, preqs))}, \
        {i: list(j.output_tokens) for i, j in enumerate(jreqs) if i % 2 == 0}


def _run(router, prompts, n_new, tag):
    reqs = _traffic(port_serving, prompts, n_new, tag)
    for r in reqs:
        r.stream = TokenStream(capacity=64)
        router.submit(r)
    for r in reqs:
        router.result(r, timeout=_RESULT_S)
    return reqs


def test_fleet_http_mixed_and_disagg_like_jax(world):
    """A two-worker mixed fleet and a prefill + decode pair over real
    HTTP: every request equals one engine's serve (greedy: the JAX
    engine's; sampled: the port's), the pair records a handoff phase on
    every request, ships every request's payload and compiles nothing
    after warmup; a mismatched blob is refused 409."""
    prompts = _prompts()
    want, greedy_jax = _oracle(world, prompts, 8)
    w1, w2 = _worker(world, "mixed"), _worker(world, "mixed")
    router = None
    try:
        router = FleetRouter([w1.url, w2.url])
        assert not router.disaggregated
        for i, r in enumerate(_run(router, prompts, 8, "m")):
            assert r.status == "finished", (r.id, r.status)
            assert list(r.output_tokens) == want[i], r.id
            assert r.stream.emitted == len(want[i])
    finally:
        if router is not None:
            router.close()
        w1.close(), w2.close()

    wp, wd = _worker(world, "prefill"), _worker(world, "decode")
    router = None
    try:
        router = FleetRouter([wp.url, wd.url])
        assert router.disaggregated
        dreqs = _run(router, prompts, 8, "d")
        for i, r in enumerate(dreqs):
            assert r.status == "finished", (r.id, r.status, r.phases)
            assert list(r.output_tokens) == want[i], r.id
            assert r.phases["handoff"] >= 0
        sp = WorkerClient(wp.url).stats()
        sd = WorkerClient(wd.url).stats()
        assert sp["role"] == "prefill" and sd["role"] == "decode"
        assert sp["handoffs"] == len(dreqs) and sp["handoffs_final"] == 0
        assert sp["stats"]["steady_state_compiles"] == 0
        assert sd["stats"]["steady_state_compiles"] == 0
        # the decode worker continued every request from its payload
        evs = [_events(port_telemetry, r.id, wd.engine._eid)
               for r in dreqs]
        assert all("adopted_payload" in e and "handoff_fallback" not in e
                   for e in evs)
        assert sd["stats"]["prefill_tokens"] == 0
        assert greedy_jax == {i: list(r.output_tokens)
                              for i, r in enumerate(dreqs) if i % 2 == 0}
        blob = wire.encode_request(_mk(port_serving, prompts[0],
            request_id="v"))
        blob["wire_version"] = 99
        with pytest.raises(WorkerRejected) as ei:
            WorkerClient(wd.url).adopt(blob)
        assert ei.value.code == 409
        assert ei.value.reason == "wire_version_mismatch"
        assert WorkerClient(wd.url).stats()["wire_version_rejects"] == 1
    finally:
        if router is not None:
            router.close()
        wp.close(), wd.close()


@pytest.mark.parametrize("kv", ["int8", "no_payload"])
def test_fleet_http_disagg_int8_and_without_payload(world, kv):
    """The prefill + decode pair on int8 pages (the payload's codes and
    scales land verbatim) and in the ablation arm (ship_payload=False:
    the decode worker replays, with no handoff phase): every stream
    equals one engine's serve."""
    ekw = {"kv_dtype": "int8"} if kv == "int8" else {}
    ship = kv != "no_payload"
    prompts = _prompts(seed=4)
    want, _ = _oracle(world, prompts, 8, **ekw)
    wp = _worker(world, "prefill", ship_payload=ship, **ekw)
    wd = _worker(world, "decode", **ekw)
    router = None
    try:
        router = FleetRouter([wp.url, wd.url])
        reqs = _run(router, prompts, 8, "d")
        for i, r in enumerate(reqs):
            assert r.status == "finished", (r.id, r.status)
            assert list(r.output_tokens) == want[i], r.id
            assert ("handoff" in r.phases) == ship, r.phases
        sd = WorkerClient(wd.url).stats()
        assert WorkerClient(wp.url).stats()["handoffs"] == len(reqs)
        assert (sd["stats"]["prefill_tokens"] == 0) == ship
        assert sd["stats"]["steady_state_compiles"] == 0
        assert wd.engine.audit_pages() == [] == wp.engine.audit_pages()
    finally:
        if router is not None:
            router.close()
        wp.close(), wd.close()


def test_fleet_worker_control_plane_drain_and_stats(world):
    """/fleet/drain turns admission off (503 with a structured body),
    /fleet/undrain turns it back on, /fleet/stats reports the geometry
    the router checks, /fleet/export hands back what is in flight."""
    w = _worker(world, "mixed", warm=False)
    c = WorkerClient(w.url)
    try:
        s = c.stats()
        assert s["wire_version"] == wire.WIRE_VERSION
        assert s["engine"]["chunk_tokens"] == _ENGINE["page_size"]
        assert s["engine"]["page_size"] == _ENGINE["page_size"]
        assert s["engine"]["kv_dtype"] == "float32"
        assert s["engine"]["device"] == "cpu"
        c.drain()
        assert c.stats()["draining"]
        with pytest.raises(WorkerRejected) as ei:
            list(c.generate({"prompt": [1, 2, 3], "max_new_tokens": 2}))
        assert ei.value.code == 503 and ei.value.reason == "draining"
        with pytest.raises(WorkerRejected):
            c.prefill({"prompt": [1, 2, 3], "max_new_tokens": 2})
        c.undrain()
        assert not c.stats()["draining"]
        ev = list(c.generate({"prompt": [1, 2, 3], "max_new_tokens": 2,
                              "request_id": "ok"}))
        assert ev[-1][0] == "done" and ev[-1][1]["status"] == "finished"
        assert c.export() == []
        assert c.cancel("nobody")["ok"]
        assert c.healthz()
        assert any(t["request_id"] == "ok" for t in c.requests(n=8))
        assert c.sloz()["worker_id"] == "mixed-t"
        assert c.flightz()["worker_id"] == "mixed-t"
        assert "serving_tokens_emitted_total" in c.metrics_text()
    finally:
        w.close()
    assert not WorkerClient(w.url, connect_retries=0).healthz()


def test_fleet_router_rejects_mixed_chunk_grids(world):
    """FleetRouter refuses workers whose prefill chunking disagrees (a
    replay plan synthesized for one would not be bit-identical on the
    other), and a worker that speaks another wire version."""
    w1 = _worker(world, "mixed", warm=False)
    w2 = _worker(world, "mixed", warm=False, chunk_tokens=16)
    try:
        assert w1.engine.chunk_tokens != w2.engine.chunk_tokens
        with pytest.raises(MXNetError, match="chunk_tokens"):
            FleetRouter([w1.url, w2.url])
        with pytest.raises(MXNetError, match="at least one worker"):
            FleetRouter([])
        client = WorkerClient(w1.url)
        client.stats = lambda timeout=10.0: dict(
            WorkerClient.stats(client), wire_version=2)
        with pytest.raises(MXNetError, match="wire_version"):
            FleetRouter([client])
    finally:
        w1.close(), w2.close()


def test_rendezvous_placement_and_jax_router_over_port_workers(world):
    """The port's FleetRouter ranks the workers exactly as the JAX
    FleetRouter does over the same workers (prompt heads with and
    without adapter ids, and with a worker excluded), and the JAX
    FleetRouter itself serves through port workers, mixed and
    disaggregated, with the JAX engine's greedy streams."""
    ws = [_worker(world, "mixed", wid=f"m{i}") for i in range(3)]
    routers = []
    try:
        urls = [w.url for w in ws]
        prt = FleetRouter(urls)
        routers.append(prt)
        jrt = JaxFleetRouter(urls)
        routers.append(jrt)
        rng = np.random.default_rng(11)
        prompts = [rng.integers(1, 97, size=10).tolist() for _ in range(32)]

        def order(router, mod, p, i, exclude=(), **kw):
            return [r.index for r in router._order(
                _mk(mod, p, 4, request_id=f"p{i}", **kw), "any", exclude)]
        for i, p in enumerate(prompts):
            for kw in ({}, {"adapter_id": f"ad{i % 3}"}):
                assert order(prt, port_serving, p, i, **kw) \
                    == order(jrt, jax_serving, p, i, **kw)
            assert order(prt, port_serving, p, i, exclude={1}) \
                == order(jrt, jax_serving, p, i, exclude={1})
        firsts = {order(prt, port_serving, p, i)[0]
                  for i, p in enumerate(prompts)}
        assert firsts == {0, 1, 2}

        traffic = _prompts(seed=9, lens=(6, 4, 9, 7))
        jreqs = [_mk(jax_serving, p, 6, request_id=f"j{i}")
                 for i, p in enumerate(traffic)]
        world.jax_engine().serve(jreqs)
        got = [_mk(jax_serving, p, 6, request_id=f"k{i}")
               for i, p in enumerate(traffic)]
        for r in got:
            r.stream = jax_serving.TokenStream(capacity=64)
            jrt.submit(r)
        for r in got:
            jrt.result(r, timeout=_RESULT_S)
        assert [r.status for r in got] == ["finished"] * len(got)
        assert [list(r.output_tokens) for r in got] \
            == [list(r.output_tokens) for r in jreqs]
    finally:
        for r in routers:
            r.close()
        for w in ws:
            w.close()

    wp, wd = _worker(world, "prefill"), _worker(world, "decode")
    jrt = None
    try:
        jrt = JaxFleetRouter([wp.url, wd.url])
        assert jrt.disaggregated
        got = [_mk(jax_serving, p, 6, request_id=f"h{i}")
               for i, p in enumerate(traffic)]
        for r in got:
            r.stream = jax_serving.TokenStream(capacity=64)
            jrt.submit(r)
        for r in got:
            jrt.result(r, timeout=_RESULT_S)
        assert [list(r.output_tokens) for r in got] \
            == [list(r.output_tokens) for r in jreqs]
        assert all("handoff" in r.phases for r in got)
        assert WorkerClient(wp.url).stats()["handoffs"] == len(got)
    finally:
        if jrt is not None:
            jrt.close()
        wp.close(), wd.close()


# ---------------------------------------------------------------------------
# real worker processes
# ---------------------------------------------------------------------------

def test_spawn_worker_names_the_port_module():
    assert launch.WORKER_MODULE == "mxnet_tpu_torch.serving.fleet.worker"


def _kill_mid_decode(spec, tag, n_new=_KILL_NEW, device="cpu"):
    """Two worker processes under a FleetRouter; once a request has two
    tokens, the worker streaming it is SIGKILLed. Returns the requests,
    the uninterrupted port run's streams, the router's view of the
    workers and the survivor's timelines."""
    prompts = [[3, 1, 4, 1, 5], list(range(11)), [9, 2, 6]]
    _, _, eng = build_engine(spec, device=device)
    ref = _traffic(port_serving, prompts, n_new, tag)
    eng.serve(ref)
    procs = spawn_fleet(spec, roles=("mixed", "mixed"), device=device,
                        ready_timeout_s=60)
    router = None
    try:
        router = FleetRouter(procs.urls)
        reqs = _traffic(port_serving, prompts, n_new, tag)
        for r in reqs:
            r.stream = TokenStream(capacity=64)
            router.submit(r)
        deadline = time.monotonic() + 30
        victim = None
        while victim is None and time.monotonic() < deadline:
            for tr in list(router._live.values()):
                if tr.rep is not None and len(tr.req.output_tokens) >= 2:
                    victim = tr.rep.index
                    break
            else:
                time.sleep(0.001)
        assert victim is not None, [len(r.output_tokens) for r in reqs]
        at_kill = [len(r.output_tokens) for r in reqs]
        procs.workers[victim].kill()
        for r in reqs:
            router.result(r, timeout=_RESULT_S)
        survivor = procs.workers[1 - victim]
        view = {w["index"]: w for w in router.fleet_stats()["workers"]}
        timelines = WorkerClient(survivor.url).requests()
        failovers = router._m["failovers"].value
        return SimpleNamespace(
            reqs=reqs, want=[list(r.output_tokens) for r in ref],
            victim=victim, at_kill=at_kill, view=view,
            timelines=timelines, failovers=failovers,
            alive=[w.alive for w in procs.workers])
    finally:
        if router is not None:
            router.close()
        procs.close()
        assert not any(w.alive for w in procs.workers)


def _kill_checks(out):
    for r, want in zip(out.reqs, out.want):
        assert r.status == "finished", (r.id, r.status)
        assert list(r.output_tokens) == want, r.id
    assert min(out.at_kill) < _KILL_NEW            # killed mid-decode
    assert out.failovers >= 1
    assert out.view[out.victim]["state"] == "down"
    assert out.view[1 - out.victim]["state"] == "up"
    assert out.alive[1 - out.victim] and not out.alive[out.victim]
    by_id = {t["request_id"]: t for t in out.timelines}
    moved = [r for r in out.reqs if r.id in by_id
             and by_id[r.id].get("migrated_from") == "wire"]
    assert moved, "no request was adopted by the survivor"
    assert all(by_id[r.id]["trace_id"] == r.trace["trace_id"]
               for r in moved)


def test_fleet_sigkill_mid_decode_two_cpu_processes():
    """Two REAL worker processes (`--device cpu`), one SIGKILLed
    mid-decode: every request finishes on the survivor equal to the
    uninterrupted port run, and the adopted requests carry their
    original trace id (one stitched trace)."""
    _kill_checks(_kill_mid_decode(_KILL_SPEC, "k"))


@pytest.mark.slow
def test_fleet_sigkill_mid_decode_int8_processes():
    """The SIGKILL failover on int8 pages: the router's natural-grid
    replay plan regenerates the same codes on the survivor."""
    _kill_checks(_kill_mid_decode(
        dict(_KILL_SPEC, engine=dict(_KILL_SPEC["engine"],
                                     kv_dtype="int8")), "i"))


@pytest.mark.slow
def test_fleet_sigkill_mid_decode_w8_processes():
    """The SIGKILL failover with int8 weights: every worker quantizes
    the same weights to the same codes, and advertises weight_dtype."""
    spec = dict(_KILL_SPEC, engine=dict(_KILL_SPEC["engine"],
                                        weight_dtype="int8"))
    out = _kill_mid_decode(spec, "w")
    _kill_checks(out)
    assert out.view[1 - out.victim]["stats"]["engine"]["weight_dtype"] \
        == "int8"


@pytest.mark.slow
def test_fleet_disagg_processes_with_and_without_payload():
    """Disaggregated prefill/decode across real processes: the handoff
    with the KV payload and the --no-ship-payload replay both finish
    every request equal to the uninterrupted port run."""
    prompts = [[2, 7, 1, 8], list(range(9))]
    _, _, eng = build_engine(_SPEC, device="cpu")
    ref = _traffic(port_serving, prompts, 8, "d")
    eng.serve(ref)
    for ship in (True, False):
        procs = spawn_fleet(_SPEC, roles=("prefill", "decode"),
                            ship_payload=ship, device="cpu",
                            ready_timeout_s=60)
        router = None
        try:
            router = FleetRouter(procs.urls)
            for r, want in zip(_run(router, prompts, 8, "d"), ref):
                assert r.status == "finished", (ship, r.id, r.status)
                assert r.output_tokens == want.output_tokens, (ship, r.id)
                assert ("handoff" in r.phases) == ship, (ship, r.phases)
            crossed = sum(w["stats"]["handoffs"]
                          for w in router.fleet_stats()["workers"]
                          if w["role"] == "prefill")
            assert crossed == len(prompts), (ship, crossed)
        finally:
            if router is not None:
                router.close()
            procs.close()
