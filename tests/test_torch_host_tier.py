"""The port's host KV tier against the JAX package.

HostPagePool (serving/host_tier.py, a copy) runs the same operation
sequences as the JAX package's and must answer and account identically.
gather_kv_pages / scatter_kv_pages move the same whole pages as the JAX
functions, bit for bit, in float32, bfloat16 and int8 with its scale
rows. The engine with `host_kv_bytes` (the spill workload and the
preemption schedule of the JAX package's tests/test_kv_spill.py, greedy,
on weights carried across from a seeded JAX tiny GPT-2, attn_impl="xla"
on the JAX side) emits the JAX engine's streams and equals its tier,
prefix and preemption counters, float and int8 pages; with sampling the
port's streams after spill, page-in, swap and restart equal its own
never-evicted and solo runs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ml_dtypes  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as mx  # noqa: E402
import mxnet_tpu.serving.host_tier as jax_host_tier  # noqa: E402
from mxnet_tpu.models import GPT2Config as JaxConfig  # noqa: E402
from mxnet_tpu.models import GPT2ForCausalLM as JaxGPT2  # noqa: E402
from mxnet_tpu.models import kv_cache as jax_kv  # noqa: E402
from mxnet_tpu.serving import Request as JaxRequest  # noqa: E402
from mxnet_tpu.serving import ServingEngine as JaxEngine  # noqa: E402
from mxnet_tpu.serving import SheddingPolicy as JaxPolicy  # noqa: E402
import mxnet_tpu_torch.serving.host_tier as port_host_tier  # noqa: E402
from mxnet_tpu_torch import MXNetError  # noqa: E402
from mxnet_tpu_torch.models import (GPT2Config, GPT2ForCausalLM,  # noqa: E402
                                    gather_kv_pages, load_jax_params,
                                    scatter_kv_pages)
from mxnet_tpu_torch.serving import (Request, ServingEngine,  # noqa: E402
                                     SheddingPolicy)

KW = dict(vocab_size=97, units=32, num_layers=2, num_heads=2,
          max_length=64, dropout=0.0, attention_dropout=0.0)
ENGINE = dict(num_slots=2, max_length=64, page_size=8, prefix_cache=True)
SAMPLED = dict(do_sample=True, temperature=0.8, top_k=20, top_p=0.95)
# the counters the port must equal the JAX engine's on
TIER_KEYS = ("kv_spill_pages", "kv_spill_bytes", "kv_pagein_pages",
             "kv_pagein_bytes", "kv_host_evictions", "kv_host_pages",
             "kv_host_bytes", "prefix_resident_pages",
             "prefix_spilled_pages", "prefix_hits", "prefix_misses",
             "prefix_tokens_saved", "prefill_tokens", "decode_dispatches",
             "tokens_emitted")
PREEMPT_KEYS = ("preempts", "preempt_resumed", "preempt_restarted",
                "kv_spill_pages", "kv_spill_bytes", "kv_pagein_pages",
                "kv_pagein_bytes", "dispatch_retries", "decode_dispatches",
                "prefill_tokens")


class Tick:
    """Injectable engine clock: deterministic preemption schedules."""

    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t


@pytest.fixture(scope="module")
def pair():
    jnet = JaxGPT2(JaxConfig(**KW))
    mx.rng.seed(3)
    jnet.initialize(mx.init.Normal(0.05))
    arrays = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    net = load_jax_params(GPT2ForCausalLM(GPT2Config(**KW), device="cpu"),
                          arrays)
    return jnet, net


# ---------------------------------------------------------------------------
# HostPagePool: the same operations on both packages' copies
# ---------------------------------------------------------------------------

def _pl(nbytes, fill=1):
    h = nbytes // 2
    return {"k": np.full(h, fill, np.uint8),
            "v": np.full(nbytes - h, fill, np.uint8), "tag": "not bytes"}


def _pool_scenario(name, mod):
    trace = []

    def rec(fn, *args):
        try:
            out = fn(*args)
            if isinstance(out, dict):
                out = sorted((k, v.nbytes) for k, v in out.items()
                             if isinstance(v, np.ndarray))
        except mod.MXNetError as e:
            out = ("raise", str(e))
        trace.append(out)
        trace.append((hp.bytes_used, hp.num_entries, hp.keys(),
                      hp.evictions, hp.rejected, hp.puts, hp.audit()))

    if name == "budget_lru":
        hp = mod.HostPagePool(100)
        for key in ("a", "b", "c"):
            rec(hp.put, key, _pl(40))
        rec(hp.put, "big", _pl(200))
        rec(hp.entry_bytes, "b")
        rec(hp.put, "b", _pl(10))          # duplicate key
    elif name == "checkout_pins":
        hp = mod.HostPagePool(100)
        rec(hp.put, "a", _pl(40))
        rec(hp.put, "b", _pl(40))
        rec(hp.checkout, "a")
        rec(hp.put, "c", _pl(40))          # evicts b: a is pinned
        rec(hp.checkout, "a")
        rec(hp.release, "a")
        rec(hp.release, "a", True)
        rec(hp.put, "d", _pl(60))
    elif name == "lease_discipline":
        hp = mod.HostPagePool(100)
        rec(hp.put, "a", _pl(10))
        rec(hp.checkout, "missing")
        rec(hp.release, "a")
        rec(hp.checkout, "a")
        rec(hp.discard, "a")
        rec(hp.release, "a")
        rec(hp.discard, "a")
        rec(hp.discard, "a")
    elif name == "evict_veto":
        hp = mod.HostPagePool(90, evict_cb=lambda key: key != "keep")
        rec(hp.put, "keep", _pl(40))
        rec(hp.put, "x", _pl(40))
        rec(hp.put, "new", _pl(40))        # x goes, keep is vetoed
        rec(hp.put, "huge", _pl(80))
    return trace


@pytest.mark.parametrize("name", ["budget_lru", "checkout_pins",
                                  "lease_discipline", "evict_veto"])
def test_host_pool_matches_jax(name):
    want = _pool_scenario(name, jax_host_tier)
    got = _pool_scenario(name, port_host_tier)
    assert got == want


# ---------------------------------------------------------------------------
# whole-page gather and scatter against the JAX functions
# ---------------------------------------------------------------------------

def _pools(dtype, seed=0, L=2, N=6, S=4, H=2, D=8):
    rng = np.random.default_rng(seed)
    shape = (L, N, S, H, D)
    if dtype == "int8":
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.random((L, N, H)).astype(np.float32)
        vs = rng.random((L, N, H)).astype(np.float32)
        return k, v, ks, vs
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    k = rng.standard_normal(shape).astype(np_dt)
    v = rng.standard_normal(shape).astype(np_dt)
    return k, v, None, None


def _to_torch(a):
    if a is None:
        return None
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(t):
    """A torch tensor or numpy/JAX array as comparable numpy bits."""
    if t is None:
        return None
    if torch.is_tensor(t):
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_gather_scatter_pages_bit_identical_to_jax(dtype):
    k, v, ks, vs = _pools(dtype)
    idx = [4, 0, 2]
    jg = jax_kv.gather_kv_pages(jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(idx, jnp.int32),
                                None if ks is None else jnp.asarray(ks),
                                None if vs is None else jnp.asarray(vs))
    tk, tv, tks, tvs = map(_to_torch, (k, v, ks, vs))
    pg = gather_kv_pages(tk, tv, idx, tks, tvs)
    for a, b in zip(pg, jg):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(_bits(a), _bits(b))
    # scatter fresh values into three other pages, verbatim
    nk, nv, nks, nvs = _pools(dtype, seed=1, N=3)
    dst = [5, 1, 3]
    js = jax_kv.scatter_kv_pages(
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(dst, jnp.int32),
        jnp.asarray(nk), jnp.asarray(nv),
        None if ks is None else jnp.asarray(ks),
        None if vs is None else jnp.asarray(vs),
        None if nks is None else jnp.asarray(nks),
        None if nvs is None else jnp.asarray(nvs))
    ps = scatter_kv_pages(tk, tv, dst, *map(_to_torch, (nk, nv)), tks, tvs,
                          *map(_to_torch, (nks, nvs)))
    assert ps[0] is tk                 # in place
    for a, b in zip(ps, js):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(_bits(a), _bits(b))
    # round trip: the gathered pages land elsewhere and read back equal
    back = gather_kv_pages(tk, tv, idx, tks, tvs)
    scatter_kv_pages(tk, tv, [3, 5, 1], back[0], back[1], tks, tvs,
                     back[2], back[3])
    again = gather_kv_pages(tk, tv, [3, 5, 1], tks, tvs)
    for a, b in zip(again, back):
        if b is not None:
            np.testing.assert_array_equal(_bits(a), _bits(b))


def test_host_kv_requires_prefix_cache(pair):
    _, net = pair
    with pytest.raises(MXNetError, match="prefix_cache"):
        ServingEngine(net, device="cpu", num_slots=2, max_length=64,
                      page_size=8, host_kv_bytes=1 << 20)


@pytest.mark.parametrize("dtype", [None, "int8", "bfloat16"])
def test_tier_gather_scatter_round_trips_engine_pages(pair, dtype):
    """Pages an engine wrote, spilled through _tier_gather and paged into
    fresh pages through _tier_scatter, read back bit for bit (codes and
    int8 scale rows); payload bytes are the reference's for the page
    (bfloat16 as 2-byte bits)."""
    _, net = pair
    kw = dict(host_kv_bytes=1 << 22, **ENGINE)
    if dtype == "int8":
        kw["kv_dtype"] = "int8"
    elif dtype == "bfloat16":
        kw["dtype"] = torch.bfloat16
    eng = ServingEngine(net, device="cpu", **kw)
    eng.serve([Request(list(range(1, 26)), 4, request_id="w")])
    member = np.nonzero(eng.prefix_cache.member_mask())[0]
    src = [int(p) for p in member[:2]]
    payloads = eng._tier_gather(src)
    L, _, S, H, D = eng._kp.shape
    item = 1 if dtype == "int8" else (2 if dtype == "bfloat16" else 4)
    want = 2 * L * S * H * D * item + (2 * L * H * 4 if dtype == "int8"
                                       else 0)
    assert port_host_tier._payload_bytes(payloads[0]) == want
    assert eng.page_pool.page_bytes == want
    if dtype == "bfloat16":
        assert payloads[0]["k"].dtype == np.int16
    fresh = eng.page_pool.alloc(len(src))
    eng._tier_scatter(list(zip(fresh, payloads)))
    pools = (eng._kp, eng._vp) + ((eng._ks, eng._vs) if dtype == "int8"
                                  else ())
    assert eng._kp[:, src[0]].abs().sum() > 0
    for t in pools:
        for s, d in zip(src, fresh):
            assert torch.equal(t[:, d], t[:, s])
    eng.page_pool.free(eng.page_pool.decref(fresh))
    assert eng.audit_pages() == []


# ---------------------------------------------------------------------------
# the engine with the tier against the JAX engine
# ---------------------------------------------------------------------------

def _spill_workload(seed=11):
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, 97, size=24).tolist()
    tails = [rng.integers(1, 97, size=6).tolist() for _ in range(2)]
    churn = [rng.integers(1, 97, size=17).tolist() for _ in range(6)]
    return shared, tails, churn


def _spill_run(make, req_cls, sampled=False, **kw):
    shared, tails, churn = _spill_workload()
    eng = make(**kw)
    knobs = SAMPLED if sampled else {}
    out = {}
    audits = []
    r0 = req_cls(shared + tails[0], 6, request_id="r0", seed=7, **knobs)
    eng.serve([r0])
    out["r0"] = list(r0.output_tokens)
    for i, p in enumerate(churn):
        r = req_cls(p, 3, request_id=f"c{i}", seed=i, **knobs)
        eng.serve([r])
        out[f"c{i}"] = list(r.output_tokens)
        audits += eng.audit_pages()
    r1 = req_cls(shared + tails[1], 6, request_id="r1", seed=9, **knobs)
    eng.serve([r1])
    out["r1"] = list(r1.output_tokens)
    return out, eng, audits


def _jax_engine(jnet, **kw):
    return JaxEngine(jnet, attn_impl="xla", **dict(ENGINE, **kw))


def _port_engine(net, **kw):
    return ServingEngine(net, device="cpu", **dict(ENGINE, **kw))


@pytest.mark.parametrize("kv_dtype,host_kv_bytes", [
    (None, 1 << 22), ("int8", 1 << 22), (None, 3 * 4096),
    ("int8", 3 * 1056)])
def test_engine_spill_and_pagein_match_jax(pair, kv_dtype, host_kv_bytes):
    """Greedy spill workload: the port's streams and every tier counter
    equal the JAX engine's, also when the host budget forces host-side
    evictions; and the streams equal the never-evicted run's."""
    jnet, net = pair
    kw = dict(kv_dtype=kv_dtype, prefix_cache_pages=4,
              host_kv_bytes=host_kv_bytes)
    want, jeng, _ = _spill_run(lambda **k: _jax_engine(jnet, **k),
                               JaxRequest, **kw)
    got, eng, audits = _spill_run(lambda **k: _port_engine(net, **k),
                                  Request, **kw)
    assert got == want
    js, ps = jeng.stats, eng.stats
    assert {k: ps[k] for k in TIER_KEYS} == {k: js[k] for k in TIER_KEYS}
    assert ps["kv_spill_pages"] >= 1
    if host_kv_bytes < 1 << 20:        # the tier drops; hits recompute
        assert ps["kv_host_evictions"] >= 1
    else:
        assert ps["kv_pagein_pages"] >= 1
    assert audits == [] and eng.audit_pages() == []
    assert eng.host_pool.audit() == []
    resident, _, _ = _spill_run(lambda **k: _port_engine(net, **k), Request,
                                kv_dtype=kv_dtype, prefix_cache_pages=64)
    assert got == resident


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_engine_sampled_streams_survive_spill(pair, kv_dtype):
    """Sampled traffic: the streams after spill and page-in equal the
    never-evicted run's (the port's own sampler on both sides)."""
    _, net = pair
    got, eng, _ = _spill_run(lambda **k: _port_engine(net, **k), Request,
                             sampled=True, kv_dtype=kv_dtype,
                             prefix_cache_pages=4, host_kv_bytes=1 << 22)
    want, _, _ = _spill_run(lambda **k: _port_engine(net, **k), Request,
                            sampled=True, kv_dtype=kv_dtype,
                            prefix_cache_pages=64)
    assert got == want
    assert eng.stats["kv_pagein_pages"] >= 1


# ---------------------------------------------------------------------------
# whole-request swap: preempt, resume or restart
# ---------------------------------------------------------------------------

def _preempt_specs(seed=5):
    rng = np.random.default_rng(seed)
    plow = rng.integers(1, 97, size=12).tolist()
    pa = rng.integers(1, 97, size=5).tolist()
    pb = rng.integers(1, 97, size=5).tolist()
    return [dict(prompt=plow, max_new=10, request_id="low", seed=3,
                 priority=2),
            dict(prompt=pa, max_new=4, request_id="a", seed=4, priority=0),
            dict(prompt=pb, max_new=4, request_id="b", seed=5, priority=0)]


def _mk(req_cls, spec, sampled):
    spec = dict(spec)
    return req_cls(spec.pop("prompt"), spec.pop("max_new"), **spec,
                   **(SAMPLED if sampled else {}))


def _preempt_run(make, req_cls, policy_cls, kv_dtype, host_kv_bytes,
                 sampled=False):
    pol = policy_cls(queue_low=1, queue_high=2, preempt=True)
    eng = make(num_slots=1, kv_dtype=kv_dtype, host_kv_bytes=host_kv_bytes,
               policy=pol, retry_backoff_s=0.0, clock=Tick())
    low, a, b = (_mk(req_cls, s, sampled) for s in _preempt_specs())
    eng.submit(low)
    steps = 0
    while len(low.output_tokens) < 2:       # mid-decode, past prefill
        eng.step()
        steps += 1
        assert steps < 50
    eng.submit(a)
    eng.submit(b)                           # queue >= high: overloaded
    eng.step()                              # preempts low for a
    assert low.status == "queued"
    audits = []
    while eng.has_work:
        eng.step()
        audits += eng.audit_pages()
        steps += 1
        assert steps < 200
    assert all(r.status == "finished" for r in (low, a, b))
    return {r.id: list(r.output_tokens) for r in (low, a, b)}, eng, audits


@pytest.mark.parametrize("kv_dtype,host_kv_bytes", [
    (None, 1 << 22), ("int8", 1 << 22), (None, 8), ("int8", 8)])
def test_preempt_resume_and_restart_match_jax(pair, kv_dtype,
                                              host_kv_bytes):
    """The JAX package's preemption schedule, greedy: with room in the
    tier the victim resumes from its swap, with 8 bytes it restarts
    (on int8 pages replaying its recorded write schedule); the streams
    and the preemption and tier counters equal the JAX engine's."""
    jnet, net = pair
    want, jeng = _preempt_run(lambda **k: _jax_engine(jnet, **k),
                              JaxRequest, JaxPolicy, kv_dtype,
                              host_kv_bytes)[:2]
    got, eng, audits = _preempt_run(lambda **k: _port_engine(net, **k),
                                    Request, SheddingPolicy, kv_dtype,
                                    host_kv_bytes)
    assert got == want
    js, ps = jeng.stats, eng.stats
    assert {k: ps[k] for k in PREEMPT_KEYS} \
        == {k: js[k] for k in PREEMPT_KEYS}
    resumed = host_kv_bytes > 8
    assert ps["preempts"] == 1
    assert (ps["preempt_resumed"], ps["preempt_restarted"]) \
        == ((1, 0) if resumed else (0, 1))
    assert audits == [] and eng.audit_pages() == []
    assert all(k[0] != "req" for k in eng.host_pool.keys())


@pytest.mark.parametrize("kv_dtype,host_kv_bytes", [
    (None, 1 << 22), ("int8", 8)])
def test_preempted_sampled_streams_equal_solo_runs(pair, kv_dtype,
                                                   host_kv_bytes):
    _, net = pair
    got, eng, _ = _preempt_run(lambda **k: _port_engine(net, **k), Request,
                               SheddingPolicy, kv_dtype, host_kv_bytes,
                               sampled=True)
    for spec in _preempt_specs():
        r = _mk(Request, spec, True)
        _port_engine(net, kv_dtype=kv_dtype).serve([r])
        assert got[r.id] == r.output_tokens, r.id
    assert eng.stats["preempts"] == 1
