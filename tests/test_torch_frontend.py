"""The port's HTTP frontend against the JAX package's.

A port ServingFrontend over a port ServingEngine and the JAX package's
ServingFrontend over a JAX ServingEngine (weights carried across from
a seeded JAX tiny GPT-2, attn_impl="xla" on the JAX side) serve the
same requests over loopback HTTP:

  * the SSE token streams (greedy) are identical to each other and to
    the same requests served by `engine.serve` on an engine of the same
    geometry; the non-stream JSON bodies are identical; a `traceparent`
    header is adopted and echoed;
  * the statuses are identical for a client that disconnects mid-stream
    (cancelled, pages released), a lagging reader with a 1-token stream
    buffer (an overflow error event, then cancelled) and a request
    posted after begin_drain() (503 with Retry-After, /readyz flipped),
    and for invalid bodies (400);
  * a KernelError out of a dispatch stops the port frontend's serving
    loop: the open stream ends with a backend_failed error, /readyz
    answers 503 and new POSTs 503 (the reference has no fatal class);
  * over a ServingRouter of two engines, a double cancel is idempotent
    (same results as JAX's), and a replica killed under a live SSE
    stream leaves the stream running to the end: greedy equal to the
    JAX frontend-over-router stream and to an unfaulted offline run,
    sampled equal to the port's offline run.

Every connection has a timeout, every server is closed in a `finally`
and every thread is joined with a timeout; servers bind port 0. The
JAX engines are kept alive until the module ends.
"""
import gc
import http.client
import json
import socket
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402
import mxnet_tpu.serving as jax_serving  # noqa: E402
from mxnet_tpu.models import GPT2Config as JaxConfig  # noqa: E402
from mxnet_tpu.models import GPT2ForCausalLM as JaxGPT2  # noqa: E402
from mxnet_tpu.serving import frontend as jax_frontend  # noqa: E402
import mxnet_tpu_torch.serving as port_serving  # noqa: E402
from mxnet_tpu_torch.models import (GPT2Config, GPT2ForCausalLM,  # noqa: E402
                                    load_jax_params)
from mxnet_tpu_torch.serving import frontend as port_frontend  # noqa: E402
from mxnet_tpu_torch.telemetry import server as port_tserver  # noqa: E402

KW = dict(vocab_size=97, units=32, num_layers=2, num_heads=2,
          max_length=64, dropout=0.0, attention_dropout=0.0)
ENGINE = dict(num_slots=2, max_length=64, page_size=8)
TIMEOUT = 60
# engine factories by serving package, and the routers' engines, which
# the module fixture keeps alive until the module ends
sides_engine = {}
sides_alive = []


@pytest.fixture(scope="module")
def sides():
    gc.collect()
    jnet = JaxGPT2(JaxConfig(**KW))
    mx.rng.seed(3)
    jnet.initialize(mx.init.Normal(0.05))
    arrays = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    net = load_jax_params(GPT2ForCausalLM(GPT2Config(**KW), device="cpu"),
                          arrays)
    engines = {
        "jax": jax_serving.ServingEngine(jnet, attn_impl="xla", **ENGINE),
        "port": port_serving.ServingEngine(net, device="cpu", **ENGINE)}
    for eng in engines.values():
        eng.mark_warm()
    out = {"jax": (jax_serving, jax_frontend, engines.pop("jax")),
           "port": (port_serving, port_frontend, engines.pop("port")),
           "net": net}
    sides_engine[jax_serving.__name__] = lambda: jax_serving.ServingEngine(
        jnet, attn_impl="xla", **ENGINE)
    sides_engine[port_serving.__name__] = lambda: port_serving.ServingEngine(
        net, device="cpu", **ENGINE)
    yield out
    # the engines die here, not inside a later module's engine build
    out.clear()
    sides_engine.clear()
    sides_alive.clear()
    gc.collect()


def _fe(side, **kw):
    mod, _, eng = side
    kw.setdefault("keepalive_s", 0.05)
    kw.setdefault("step_idle_s", 0.005)
    return mod.ServingFrontend(eng, **kw)


def _post(fe, body, headers=None):
    conn = http.client.HTTPConnection(fe.host, fe.port, timeout=TIMEOUT)
    try:
        conn.request("POST", "/v1/generate", json.dumps(body),
                     dict({"Content-Type": "application/json"},
                          **(headers or {})))
        r = conn.getresponse()
        return r.status, dict(r.getheaders()), r.read().decode()
    finally:
        conn.close()


def _get(fe, path):
    conn = http.client.HTTPConnection(fe.host, fe.port, timeout=TIMEOUT)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, dict(r.getheaders()), r.read().decode()
    finally:
        conn.close()


def _sse(text):
    """[(event, payload)] of a close-delimited SSE body (keepalive
    comments dropped)."""
    out = []
    for block in text.split("\n\n"):
        block = block.strip()
        if not block or block.startswith(":"):
            continue
        ev = payload = None
        for line in block.splitlines():
            if line.startswith("event: "):
                ev = line[len("event: "):]
            elif line.startswith("data: "):
                payload = json.loads(line[len("data: "):])
        if ev is not None:
            out.append((ev, payload))
    return out


def _tokens(events):
    toks = []
    for ev, p in events:
        if ev == "tokens":
            assert p["index"] == len(toks)
            toks.extend(p["tokens"])
    return toks


def _done(events):
    dones = [p for ev, p in events if ev == "done"]
    assert len(dones) == 1, events
    return dones[0]


def _quiesce(fe, eng):
    deadline = time.time() + TIMEOUT
    while time.time() < deadline:
        if (not eng.has_work and fe.stats["active_streams"] == 0
                and fe._cmd_q.empty()):
            return
        time.sleep(0.01)
    raise AssertionError(f"frontend did not quiesce: {fe.stats}")


def _bodies(n=6, seed=7):
    rng = np.random.default_rng(seed)
    return [{"prompt": rng.integers(1, 97, size=int(rng.integers(3, 20)))
             .tolist(), "max_new_tokens": int(rng.integers(3, 9)),
             "request_id": f"h{i}"} for i in range(n)]


def _concurrent(fe, bodies):
    """POST every body at once from its own thread; {request_id:
    (status, traceparent, events)}."""
    out, errors = {}, []

    def client(body):
        try:
            tp = "00-" + f"{len(out) + 1:032x}" + "-" + "a" * 16 + "-01"
            status, hdrs, text = _post(fe, body, {"traceparent": tp})
            out[body["request_id"]] = (status, hdrs.get("traceparent"),
                                       _sse(text), tp)
        except Exception as e:          # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(b,)) for b in bodies]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in threads) and errors == []
    return out


def test_sse_streams_equal_jax_and_engine_serve(sides):
    bodies = _bodies()
    streams = {}
    for key in ("jax", "port"):
        fe = _fe(sides[key])
        try:
            got = _concurrent(fe, bodies)
            _quiesce(fe, sides[key][2])
        finally:
            fe.close()
        streams[key] = {}
        for rid, (status, tp_back, evs, tp_sent) in got.items():
            assert status == 200
            assert _done(evs)["status"] == "finished"
            # the caller's trace id comes back, under a fresh span id
            assert tp_back.split("-")[1] == tp_sent.split("-")[1]
            streams[key][rid] = _tokens(evs)
    assert streams["port"] == streams["jax"]
    eng = port_serving.ServingEngine(sides["net"], device="cpu", **ENGINE)
    reqs = [port_serving.Request(b["prompt"], b["max_new_tokens"],
                                 request_id=b["request_id"]) for b in bodies]
    eng.serve(reqs)
    assert streams["port"] == {r.id: list(r.output_tokens) for r in reqs}
    assert sides["port"][2].audit_pages() == []


def test_nonstream_json_body_matches_jax(sides):
    out = {}
    for key in ("jax", "port"):
        fe = _fe(sides[key])
        try:
            status, hdrs, body = _post(fe, {"prompt": [5, 6, 7],
                                            "max_new_tokens": 4,
                                            "stream": False,
                                            "request_id": "json0"})
        finally:
            fe.close()
        assert status == 200 and hdrs["X-Request-Id"] == "json0"
        out[key] = json.loads(body)
    assert out["port"] == out["jax"]
    assert out["port"]["usage"] == {"prompt_tokens": 3,
                                    "completion_tokens": 4}


def _disconnect(side):
    _, _, eng = side
    eng.reset_stats()
    eng.dispatch_hook = lambda e: time.sleep(0.005)   # a paced engine
    fe = _fe(side)
    try:
        body = json.dumps({"prompt": [9, 8, 7], "max_new_tokens": 40,
                           "request_id": "gone"}).encode()
        sock = socket.create_connection((fe.host, fe.port), timeout=TIMEOUT)
        try:
            sock.sendall(b"POST /v1/generate HTTP/1.0\r\n"
                         b"Content-Type: application/json\r\n"
                         b"Content-Length: " + str(len(body)).encode()
                         + b"\r\n\r\n" + body)
            buf = b""
            while b"event: tokens" not in buf:
                chunk = sock.recv(4096)
                assert chunk, "server closed before the first token"
                buf += chunk
        finally:
            sock.close()                 # hang up mid-decode
        deadline = time.time() + TIMEOUT
        while time.time() < deadline and (
                eng.stats["requests_cancelled"] < 1 or eng.has_work
                or fe.stats["active_streams"]):
            time.sleep(0.01)
        st = fe.stats
        return (eng.stats["requests_cancelled"], st["disconnects"],
                st["cancels_issued"], eng.has_work, eng.audit_pages())
    finally:
        fe.close()
        eng.dispatch_hook = None


def test_disconnect_cancels_like_jax(sides):
    want = _disconnect(sides["jax"])
    got = _disconnect(sides["port"])
    assert got == want == (1, 1, 1, False, [])


def _overflow(side, monkeypatch):
    _, fr, eng = side
    eng.reset_stats()
    orig = fr.TokenStream.take

    def laggy_take(self, timeout=None):
        if self.capacity == 1:
            time.sleep(0.3)              # a reader that falls behind
        return orig(self, timeout)

    monkeypatch.setattr(fr.TokenStream, "take", laggy_take)
    fe = _fe(side)
    try:
        status, _, body = _post(fe, {"prompt": [7, 8, 9],
                                     "max_new_tokens": 16,
                                     "stream_buffer": 1,
                                     "request_id": "laggard"})
        evs = _sse(body)
        _quiesce(fe, eng)
        return (status, [p["error"] for ev, p in evs if ev == "error"],
                _done(evs)["status"], fe.stats["stream_overflows"],
                eng.stats["requests_cancelled"], eng.audit_pages())
    finally:
        fe.close()
        monkeypatch.setattr(fr.TokenStream, "take", orig)


def test_stream_overflow_cancels_like_jax(sides, monkeypatch):
    want = _overflow(sides["jax"], monkeypatch)
    got = _overflow(sides["port"], monkeypatch)
    assert got == want == (200, ["overflow"], "cancelled", 1, 1, [])


def _drain_reject(side):
    _, _, eng = side
    fe = _fe(side)
    try:
        name = fe._probe_name
        trace = [_get(fe, f"/readyz?component={name}")[0]]
        fe.begin_drain()
        status, hdrs, data = _post(fe, {"prompt": [1, 2],
                                        "max_new_tokens": 2})
        err = json.loads(data)["error"]
        trace += [status, "Retry-After" in hdrs, err["type"],
                  err["reason"], _get(fe, f"/readyz?component={name}")[0],
                  json.loads(_get(fe, "/readyz")[2])["components"][name][
                      "draining"]]
        return trace
    finally:
        fe.close()


def test_drain_rejects_new_posts_and_flips_readyz_like_jax(sides):
    want = _drain_reject(sides["jax"])
    got = _drain_reject(sides["port"])
    assert got == want == [200, 503, True, "ShedError", "draining", 503,
                           True]


def _invalid(side):
    fe = _fe(side)
    try:
        out = []
        for body in ({}, {"prompt": []}, {"prompt": "abc"},
                     {"prompt": [1, 2], "max_new_tokens": "lots"},
                     {"prompt": list(range(1, 70)), "max_new_tokens": 2}):
            status, _, data = _post(fe, body)
            out.append((status, json.loads(data)["error"]["reason"]))
        out.append(_get(fe, "/nope")[0])
        out.append(fe.stats["requests_by_code"])
        return out
    finally:
        fe.close()


def test_invalid_requests_answer_like_jax(sides):
    want = _invalid(sides["jax"])
    got = _invalid(sides["port"])
    assert got == want
    assert got[0] == (400, "invalid_request")


def test_engine_drain_maps_to_503_like_jax(sides):
    out = {}
    for key in ("jax", "port"):
        _, _, eng = sides[key]
        fe = _fe(sides[key])
        try:
            eng.drain()
            status, hdrs, data = _post(fe, {"prompt": [1, 2],
                                            "max_new_tokens": 2})
            out[key] = (status, "Retry-After" in hdrs,
                        json.loads(data)["error"]["reason"], eng.drained)
        finally:
            eng.undrain()
            fe.close()
    assert out["port"] == out["jax"] == (503, True, "draining", True)


def test_kernel_error_stops_the_loop_and_flips_readyz(sides):
    """A KernelError out of a dispatch is the engine's fatal class: the
    engine re-raises it and latches not ready, and the frontend ends the
    open stream with a backend_failed error, answers /readyz 503 for
    both components and new POSTs 503, and stops its serving loop
    instead of stepping the dead backend again."""
    from mxnet_tpu_torch.ops._build import KernelError
    eng = port_serving.ServingEngine(sides["net"], device="cpu", **ENGINE)
    eng.mark_warm()
    dispatches = []

    def hook(e, phase, requests):
        if phase == "decode":
            dispatches.append(phase)
            time.sleep(0.005)
            if len(dispatches) == 4:
                raise KernelError("ragged_attention: launch failed")

    eng.dispatch_hook = hook
    fe = _fe((port_serving, port_frontend, eng))
    try:
        names = (fe._probe_name, f"engine{eng._eid}")
        assert [_get(fe, f"/readyz?component={n}")[0] for n in names] \
            == [200, 200]
        status, _, text = _post(fe, {"prompt": [3, 4, 5],
                                     "max_new_tokens": 40,
                                     "request_id": "doomed"})
        evs = _sse(text)
        errs = [p for ev, p in evs if ev == "error"]
        assert status == 200 and 0 < len(_tokens(evs)) < 40
        assert [p["error"] for p in errs] == ["backend_failed"]
        assert "KernelError" in errs[0]["message"]
        assert _done(evs)["status"] == "error"
        fe._loop_thread.join(timeout=TIMEOUT)
        assert not fe._loop_thread.is_alive()
        assert len(dispatches) == 4            # never stepped again
        assert "KernelError" in fe.failed and not eng.is_ready()
        assert [_get(fe, f"/readyz?component={n}")[0] for n in names] \
            == [503, 503]
        comps = json.loads(_get(fe, "/readyz")[2])["components"]
        assert [comps[n]["degraded"] for n in names] == ["fatal", "fatal"]
        assert f"{names[0]}=fatal" in _get(fe, "/healthz")[2]
        status, hdrs, data = _post(fe, {"prompt": [1, 2],
                                        "max_new_tokens": 2})
        assert status == 503
        assert json.loads(data)["error"]["reason"] == "backend_failed"
        assert fe.stats["failed"] == fe.failed
    finally:
        fe.close()
        eng.dispatch_hook = None
    health = port_tserver.healthz_body()
    assert f"{names[0]}=fatal" not in health         # closed: cleared
    assert f"{names[1]}=fatal" in health             # the engine: sticky
    del eng, fe
    gc.collect()
    assert f"{names[1]}=fatal" not in port_tserver.healthz_body()


def _router(side, n=2, **kw):
    """A router over `n` fresh engines of the fixture's geometry (kept
    alive until the module ends)."""
    mod = side[0]
    make = sides_engine[mod.__name__]
    engines = [make() for _ in range(n)]
    router = mod.ServingRouter(engines, **kw)
    sides_alive.extend(engines + [router])
    return router, engines


def _double_cancel(side):
    mod = side[0]
    router, engines = _router(side)
    req = mod.Request([5, 5, 5], 6, request_id="dc")
    router.submit(req)
    first = router.cancel("dc")
    return (first is req, req.status, router.cancel("dc"),
            [e.cancel("dc") for e in engines],
            sum(e.stats["requests_cancelled"] for e in engines),
            [e.audit_pages() for e in engines])


def test_double_cancel_via_router_is_idempotent_like_jax(sides):
    out = {key: _double_cancel(sides[key]) for key in ("jax", "port")}
    assert out["port"] == out["jax"]
    assert out["port"] == (True, "cancelled", None, [False, False], 1,
                           [[], []])


def _kill_mid_stream(side, body):
    """POST `body` to a frontend over a two-replica router of paced
    engines; once the request has 3 tokens, kill the replica that owns
    it. (status, events, kills, audits)."""
    mod = side[0]
    router, engines = _router(side, hedge_after_s=1e9)
    for e in engines:
        e.dispatch_hook = lambda e: time.sleep(0.005)   # paced engines
    fe = mod.ServingFrontend(router, keepalive_s=0.05, step_idle_s=0.005)
    plan, out = None, {}
    try:
        def go():
            out["res"] = _post(fe, body)
        t = threading.Thread(target=go)
        t.start()
        deadline = time.time() + TIMEOUT
        owner = None
        while owner is None and time.time() < deadline:
            o = router._owner.get(body["request_id"])
            if o is not None and len(o[1].output_tokens) >= 3:
                owner = o[0]                # mid-decode on this replica
            time.sleep(0.002)
        assert owner is not None, "the request never started decoding"
        plan = mod.ReplicaFaultPlan(kill={1: owner}).install(router)
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()
    finally:
        if plan is not None:
            plan.uninstall()
        fe.close()
        for e in engines:
            e.dispatch_hook = None
    status, _, text = out["res"]
    return (status, _sse(text), plan.counts["kill"],
            router.stats["migrated"], router.stats["replica_down"],
            [(e.audit_pages(), e.audit_adapters()) for e in engines])


def _held_stream(res, want):
    status, evs, kills, migrated, down, audits = res
    assert status == 200 and kills == 1 and migrated == 1
    assert down == {"kill": 1}
    assert _done(evs)["status"] == "finished"
    assert _tokens(evs) == want
    assert audits == [([], []), ([], [])]


def test_replica_kill_mid_stream_survives_like_jax(sides):
    """A replica killed under a live greedy SSE stream: the router
    migrates the Request (stream attached) by export/adopt, and the
    client's stream runs on, equal to the JAX frontend-over-router
    stream and to an unfaulted offline run."""
    body = {"prompt": [11, 23, 42, 7, 56], "max_new_tokens": 24,
            "request_id": "k0"}
    out = {key: _kill_mid_stream(sides[key], body)
           for key in ("jax", "port")}
    ref = port_serving.Request(body["prompt"], 24, request_id="k0")
    port_serving.ServingEngine(sides["net"], device="cpu",
                               **ENGINE).serve([ref])
    assert ref.status == "finished" and len(ref.output_tokens) == 24
    _held_stream(out["jax"], list(ref.output_tokens))
    _held_stream(out["port"], list(ref.output_tokens))


def test_replica_kill_mid_stream_sampled_equals_offline_run(sides):
    """The same with a sampled stream (the port's own sampler): the
    migrated stream equals the port's unfaulted offline run."""
    body = {"prompt": [11, 23, 42, 7, 56], "max_new_tokens": 24,
            "request_id": "k1", "do_sample": True, "temperature": 0.9,
            "seed": 11}
    ref = port_serving.Request(body["prompt"], 24, request_id="k1",
                               do_sample=True, temperature=0.9, seed=11)
    port_serving.ServingEngine(sides["net"], device="cpu",
                               **ENGINE).serve([ref])
    assert ref.status == "finished" and len(ref.output_tokens) == 24
    _held_stream(_kill_mid_stream(sides["port"], body),
                 list(ref.output_tokens))
