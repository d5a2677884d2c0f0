"""The port's prefix cache against the JAX package.

The radix tree (serving/prefix_cache.py, a copy) runs the same operation
sequences as the JAX package's PrefixCache over the same kind of
PagePool and must answer and account identically at every step. The
engine with the cache on must emit the JAX engine's greedy streams
(float32, attn_impl="xla", same weights and traffic), equal its own
streams with the cache off (greedy and sampled, float32 and int8
pages), leave the tree's pages untouched through the copy-on-write
split of a fully cached prompt, skip the prefill of every cached token,
and keep the page-pool audit clean after every scheduling round.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402
import mxnet_tpu.serving.page_pool as jax_page_pool  # noqa: E402
import mxnet_tpu.serving.prefix_cache as jax_prefix_cache  # noqa: E402
from mxnet_tpu.models import GPT2Config as JaxConfig  # noqa: E402
from mxnet_tpu.models import GPT2ForCausalLM as JaxGPT2  # noqa: E402
from mxnet_tpu.serving import Request as JaxRequest  # noqa: E402
from mxnet_tpu.serving import ServingEngine as JaxEngine  # noqa: E402
import mxnet_tpu_torch.serving.page_pool as port_page_pool  # noqa: E402
import mxnet_tpu_torch.serving.prefix_cache as port_prefix_cache  # noqa: E402
from mxnet_tpu_torch.models import (GPT2Config, GPT2ForCausalLM,  # noqa: E402
                                    load_jax_params)
from mxnet_tpu_torch.serving import Request, ServingEngine  # noqa: E402

KW = dict(vocab_size=97, units=32, num_layers=2, num_heads=2,
          max_length=64, dropout=0.0, attention_dropout=0.0)
ENGINE = dict(num_slots=3, max_length=64, page_size=8, chunk_tokens=8)


# ---------------------------------------------------------------------------
# the radix tree: the same operations on both packages' copies
# ---------------------------------------------------------------------------

def _state(pool, pc):
    return (pc.num_pages, pc.hits, pc.misses, pc.tokens_matched,
            pc.evicted_pages, pool.num_free, pool.refcounts().tolist(),
            pc.member_mask().tolist())


def _scenario(name, pools, caches):
    """Run scenario `name` on (PagePool, PrefixCache) classes; returns
    the trace of every answer and of the accounting after each step."""
    trace = []

    def rec(x):
        trace.append(x)
        trace.append(_state(pool, pc))
        return x

    if name == "insert_match_release":
        pool = pools(8)
        pc = caches(pool, 4)
        toks = list(range(10))             # 2 full pages of 4 + a tail
        pages = rec(pool.alloc(2))
        rec(pc.insert(toks, pages))
        got = rec(pc.match(toks))
        got2 = rec(pc.match(list(range(4)) + [99, 98, 97, 96]))
        rec(pc.release(got + got2))
        rec(pc.release(pages))
        rec(pc.contains(toks[:8]))
        rec(pc.match([1, 2, 3]))           # < one page: a miss
    elif name == "lru_eviction_budget":
        pool = pools(16)
        pc = caches(pool, 2, budget_pages=3)
        a = rec(pool.alloc(2))
        rec(pc.insert([1, 2, 3, 4], a))
        b = rec(pool.alloc(2))
        rec(pc.insert([9, 9, 8, 8], b))
        rec(pc.release(a + b))             # over budget: LRU leaf goes
        pc.budget_pages = 2
        rec(pc.enforce_budget())
        rec(pc.release(rec(pc.match([9, 9, 8, 8]))))
    elif name == "leased_pinned_and_reclaim":
        pool = pools(4)
        pc = caches(pool, 2, budget_pages=0)
        a = rec(pool.alloc(1))
        rec(pc.insert([5, 6], a))
        rec(pc.enforce_budget())           # leased: survives budget 0
        rec(pc.release(a))                 # lease dropped: evicted
        pc.budget_pages = None
        b = rec(pool.alloc(2))
        rec(pc.insert([1, 2, 3, 4], b))
        rec(pc.release(b))
        rec(pc.reclaim(3))
        rec(pc.reclaim(5))                 # more than the pool: False
        rec(pc.clear())
    else:                                  # random churn
        rng = np.random.default_rng(int(name.split("_")[1]))
        pool = pools(24)
        pc = caches(pool, 2, budget_pages=10)
        held = []
        for _ in range(60):
            op = rng.integers(4)
            toks = rng.integers(0, 3, int(rng.integers(1, 9))).tolist()
            if op == 0 and pool.num_free >= 4:
                pages = pool.alloc(4)
                held.append(pages)
                rec(pages)
                rec(pc.insert(toks, pages))
            elif op == 1:
                got = rec(pc.match(toks))
                if got:
                    held.append(got)
            elif op == 2 and held:
                rec(pc.release(held.pop(int(rng.integers(len(held))))))
            else:
                rec(pc.reclaim(int(rng.integers(1, 12))))
        for pages in held:
            rec(pc.release(pages))
    return trace, pool, pc


@pytest.mark.parametrize("name", ["insert_match_release",
                                  "lru_eviction_budget",
                                  "leased_pinned_and_reclaim",
                                  "churn_0", "churn_1", "churn_2"])
def test_radix_tree_matches_jax(name):
    jt, _, _ = _scenario(name, jax_page_pool.PagePool,
                         jax_prefix_cache.PrefixCache)
    pt, pool, pc = _scenario(name, port_page_pool.PagePool,
                             port_prefix_cache.PrefixCache)
    assert pt == jt
    assert pc.evict_hook is None and pc.pagein_hook is None
    members = np.nonzero(pc.member_mask())[0]
    assert pool.audit(members=members) == [] or name.startswith("churn")


def test_radix_tree_basic_contract():
    pool = port_page_pool.PagePool(8)
    pc = port_prefix_cache.PrefixCache(pool, 4)
    pages = pool.alloc(2)
    assert pc.insert(list(range(10)), pages) == 2
    assert pc.match(list(range(10))) == pages
    assert all(pool.refcount(p) == 2 for p in pages)
    pc.release(pages)
    pc.release(pages)
    # zero-ref tree pages stay materialized (evictable), not freed
    assert pc.num_pages == 2 and pool.num_allocated == 2
    with pytest.raises(Exception):
        port_prefix_cache.PrefixCache(object(), 4)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    jnet = JaxGPT2(JaxConfig(**KW))
    mx.rng.seed(3)
    jnet.initialize(mx.init.Normal(0.05))
    arrays = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    net = load_jax_params(GPT2ForCausalLM(GPT2Config(**KW), device="cpu"),
                          arrays)
    return jnet, net


def _traffic(seed=11, n=9, sampled=False):
    """Shared-prefix traffic: most prompts extend a 24-token system
    prefix (3 pages of 8) with a unique tail, one is exactly the prefix
    (the copy-on-write split), the rest are distinct."""
    rng = np.random.default_rng(seed)
    system = rng.integers(0, KW["vocab_size"], 24).tolist()
    out = []
    for i in range(n):
        if i == n - 1:
            prompt = list(system)
        elif rng.random() < 0.75:
            prompt = system + rng.integers(
                0, KW["vocab_size"], int(rng.integers(1, 12))).tolist()
        else:
            prompt = rng.integers(0, KW["vocab_size"],
                                  int(rng.integers(4, 20))).tolist()
        out.append(dict(prompt=prompt, max_new_tokens=6, request_id=i,
                        seed=300 + i, do_sample=sampled and bool(i % 2),
                        temperature=0.8, top_k=20, top_p=0.95))
    return out


def _serve_port(net, traffic, audit_each_step=True, **kw):
    """Serve `traffic` step by step; the page audit must be clean after
    every round. Returns (engine, {id: tokens})."""
    eng = ServingEngine(net, device="cpu", **dict(ENGINE, **kw))
    reqs = [Request(**t) for t in traffic]
    for r in reqs:
        eng.submit(r)
    while eng.has_work:
        eng.step()
        if audit_each_step:
            assert eng.audit_pages() == []
    assert eng.audit_pages() == []
    assert all(r.status == "finished" for r in reqs)
    return eng, {r.id: r.output_tokens for r in reqs}


_JAX = {}


def _serve_jax(jnet, traffic_seed, **kw):
    key = (traffic_seed, tuple(sorted(kw.items())))
    if key not in _JAX:
        eng = JaxEngine(jnet, attn_impl="xla", **dict(ENGINE, **kw))
        reqs = [JaxRequest(**t) for t in _traffic(traffic_seed)]
        eng.serve(reqs)
        assert eng.audit_pages() == []
        _JAX[key] = ({r.id: r.output_tokens for r in reqs}, eng.stats)
    return _JAX[key]


@pytest.mark.parametrize("seed", [11, 12])
def test_engine_prefix_cache_greedy_matches_jax(pair, seed):
    jnet, net = pair
    want, jstats = _serve_jax(jnet, seed, prefix_cache=True)
    eng, got = _serve_port(net, _traffic(seed), prefix_cache=True)
    assert got == want
    for key in ("prefix_hits", "prefix_misses", "prefix_tokens_saved",
                "prefill_tokens"):
        assert eng.stats[key] == jstats[key], key
    assert eng.stats["prefix_hits"] > 0


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("sampled", [False, True])
def test_engine_prefix_cache_on_equals_off(pair, kv_dtype, sampled):
    """Enabling the cache changes no token, greedy or sampled, float or
    int8 pages (attach starts prefill at a page boundary, on the same
    chunk grid), and the cached tokens really are not recomputed."""
    _, net = pair
    traffic = _traffic(13, sampled=sampled)
    kw = dict(kv_dtype=kv_dtype, prefill_chunk_budget=64)
    off, want = _serve_port(net, traffic, audit_each_step=False, **kw)
    on, got = _serve_port(net, traffic, prefix_cache=True, **kw)
    assert got == want
    s = on.stats
    assert s["prefix_hits"] > 0 and s["prefix_tokens_saved"] > 0
    assert s["prefill_tokens"] + s["prefix_tokens_saved"] \
        == off.stats["prefill_tokens"]
    assert off.stats["prefix_hits"] == off.stats["prefix_misses"] == 0


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_engine_cow_of_a_fully_cached_prompt(pair, kv_dtype):
    """A prompt that is exactly two cached pages re-homes its last page
    to an exclusive copy (codes and int8 scales): one token recomputed,
    the same output, and the tree's pages byte-stable."""
    _, net = pair
    prompt = np.random.default_rng(12).integers(0, 97, 16).tolist()
    eng = ServingEngine(net, device="cpu", prefix_cache=True,
                        kv_dtype=kv_dtype, **ENGINE)
    (r1,) = eng.serve([Request(prompt, 5, request_id="a")])
    pc = eng.prefix_cache
    tree = sorted(pc._by_page)
    assert len(tree) >= 2
    leaves = [eng._kp, eng._vp] + ([eng._ks, eng._vs] if kv_dtype else [])
    before = [x[:, tree].clone() for x in leaves]
    (r2,) = eng.serve([Request(prompt, 5, request_id="b")])
    assert r2.output_tokens == r1.output_tokens
    assert eng.stats["prefix_tokens_saved"] == 15       # Tp - 1
    assert eng.stats["prefill_tokens"] == 16 + 1
    for b, x in zip(before, leaves):
        assert torch.equal(b, x[:, tree])
    assert eng.audit_pages() == []


def test_engine_prefix_hit_skips_prefill_tokens(pair):
    _, net = pair
    system = np.random.default_rng(13).integers(0, 97, 32).tolist()
    eng = ServingEngine(net, device="cpu", prefix_cache=True, **ENGINE)
    eng.serve([Request(system + [1, 2], 3, request_id=0)])
    base = eng.stats["prefill_tokens"]
    eng.serve([Request(system + [3, 4, 5], 3, request_id=1)])
    assert eng.stats["prefill_tokens"] - base == 3      # the tail only
    assert eng.stats["prefix_tokens_saved"] == 32


def test_engine_int8_prefix_attach_matches_jax_and_cache_off(pair):
    """tests/test_quant_kv.py's int8 attach case: one slot, a shared
    16-token prefix with two tails and then alone (the CoW split): the
    cache-on int8 streams equal the cache-off int8 run and the JAX int8
    engine with the cache on."""
    jnet, net = pair
    shared = np.random.default_rng(9).integers(1, 97, 16).tolist()
    prompts = [shared + [7], shared + [11], shared]
    kw = dict(num_slots=1, max_length=64, page_size=8, kv_dtype="int8")

    def port(**extra):
        eng = ServingEngine(net, device="cpu", **kw, **extra)
        reqs = [Request(p, 8, request_id=i) for i, p in enumerate(prompts)]
        eng.serve(reqs)
        assert eng.audit_pages() == []
        return eng, [r.output_tokens for r in reqs]

    _, off = port()
    eng, on = port(prefix_cache=True)
    jeng = JaxEngine(jnet, attn_impl="xla", prefix_cache=True, **kw)
    jreqs = [JaxRequest(p, 8, request_id=i) for i, p in enumerate(prompts)]
    jeng.serve(jreqs)
    assert on == off == [r.output_tokens for r in jreqs]
    assert eng.stats["prefix_hits"] == 2
    assert [r.kv_attach for r in jreqs] == [0, 16, 15]


def test_engine_churn_respects_budget_and_refcount_baseline(pair):
    """Admissions far past the tree's page budget: eviction keeps the
    tree within it, every lease returns to zero after the drain, and
    the pool's allocated pages are exactly the tree's."""
    _, net = pair
    rng = np.random.default_rng(14)
    eng = ServingEngine(net, num_slots=2, max_length=32, page_size=8,
                        prefix_cache=True, prefix_cache_pages=8,
                        device="cpu")
    reqs = [Request(rng.integers(0, 97, 24).tolist(), 2, request_id=i)
            for i in range(12)]
    eng.serve(reqs)
    pc, pool = eng.prefix_cache, eng.page_pool
    assert pc.num_pages <= 8 and pc.evicted_pages > 0
    assert (pool.refcounts() == 0).all()
    assert pool.num_allocated == pc.num_pages
    assert pool.num_free + pool.num_allocated == pool.num_pages
    assert eng.admission_capacity_estimate() == 2
    assert eng.audit_pages() == []


def test_engine_mid_flight_sharing_and_page_lock(pair):
    """A second request with the same prompt, admitted while the first
    still decodes, attaches its pages (shared, so locked on the device)
    and emits the same stream."""
    _, net = pair
    prompt = np.random.default_rng(16).integers(0, 97, 16).tolist()
    eng = ServingEngine(net, device="cpu", prefix_cache=True, **ENGINE)
    r1 = Request(prompt, 8, request_id="x")
    eng.submit(r1)
    eng.step()
    eng.step()                        # the final chunk adopts the pages
    assert len(r1.output_tokens) >= 1
    tree = sorted(eng.prefix_cache._by_page)
    assert bool(eng._d_lock[tree].all())
    r2 = Request(prompt, 8, request_id="y")
    eng.submit(r2)
    eng.step()
    assert int(eng.page_pool.shared_mask().sum()) >= 1
    assert r1.status == "running"
    while eng.has_work:
        eng.step()
        assert eng.audit_pages() == []
    assert r1.output_tokens == r2.output_tokens


def test_engine_backpressure_with_prefix_cache(pair):
    """A pool with room for one full slot and a little more: admissions
    wait for pages (requeued without blame), idle tree pages are
    reclaimed for them, and every request finishes with the streams of
    an unconstrained cache-on engine."""
    _, net = pair
    traffic = _traffic(15)
    page = 2 * KW["num_layers"] * 8 * KW["units"] * 4
    _, want = _serve_port(net, traffic, audit_each_step=False,
                          prefix_cache=True, prefill_chunk_budget=64)
    eng, got = _serve_port(net, traffic, prefix_cache=True,
                           prefill_chunk_budget=64, retry_backoff_s=0.0,
                           hbm_budget_bytes=page * 10)
    assert eng.page_pool.num_pages == 10
    assert eng.stats["dispatch_retries"] > 0
    assert got == want
