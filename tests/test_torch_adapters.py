"""The port's LoRA adapter pool and adapter serving against the JAX
package.

The pool's ledger (register validation, LRU acquire and release,
exhaustion, audit) runs the same script against both packages' pools;
the slab the port pages in holds the JAX slab's bytes (float and int8).
The engine, on the same seeded weights: the null adapter leaves every
stream exactly as an engine without a pool; in a mixed batch each slot's
greedy stream equals the JAX engine's with the same pool and a plain
engine's over the merged weights W + (BA)^T * alpha/r (for an int8 slab,
over the slab's effective weights); slab exhaustion is backpressure; an
unknown adapter is rejected at submit; w8 weights, int8 KV pages and an
int8 slab together give the JAX engine's streams.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402
import mxnet_tpu.serving.adapters as jax_adapters  # noqa: E402
from mxnet_tpu.models import GPT2Config as JaxConfig  # noqa: E402
from mxnet_tpu.models import GPT2ForCausalLM as JaxGPT2  # noqa: E402
from mxnet_tpu.serving import Request as JaxRequest  # noqa: E402
from mxnet_tpu.serving import ServingEngine as JaxEngine  # noqa: E402
import mxnet_tpu_torch.serving.adapters as port_adapters  # noqa: E402
from mxnet_tpu_torch import MXNetError  # noqa: E402
from mxnet_tpu_torch.models import (AdapterBatch, GPT2Config,  # noqa: E402
                                    GPT2ForCausalLM, load_jax_params)
from mxnet_tpu_torch.serving import (AdapterPool, Request,  # noqa: E402
                                     ServingEngine, merged_weights,
                                     random_lora)

KW = dict(vocab_size=97, units=32, num_layers=2, num_heads=4,
          max_length=64, dropout=0.0, attention_dropout=0.0)
ENGINE = dict(num_slots=4, max_length=64, page_size=8, chunk_tokens=8)
PROJ = ("query", "key", "value", "proj")


@pytest.fixture(scope="module")
def jax_model():
    jnet = JaxGPT2(JaxConfig(**KW))
    mx.rng.seed(3)
    jnet.initialize(mx.init.Normal(0.05))
    arrays = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    return jnet, arrays


def _port_net(arrays, lora=None):
    """A port model with `arrays`' weights, with `lora`'s deltas merged
    into every attention projection when given (the dense oracle)."""
    arrays = dict(arrays)
    if lora is not None:
        for li in range(KW["num_layers"]):
            for proj in PROJ:
                name = f"backbone.layer{li}.attn.{proj}.weight"
                arrays[name] = merged_weights(arrays[name], lora, proj, li)
    return load_jax_params(GPT2ForCausalLM(GPT2Config(**KW), device="cpu"),
                           arrays)


def _prompts(n=4, seed=0, lo=3, hi=14):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 97, size=int(rng.integers(lo, hi))).tolist()
            for _ in range(n)]


def _serve(eng, prompts, request_cls, wear=None, max_new=8, **kw):
    wear = wear or [None] * len(prompts)
    reqs = [request_cls(p, max_new, request_id=i, adapter_id=wear[i],
                        seed=50 + i, **kw) for i, p in enumerate(prompts)]
    eng.serve(reqs)
    return [r.output_tokens for r in reqs]


# ---------------------------------------------------------------------------
# the pool's ledger: one script, both packages
# ---------------------------------------------------------------------------

def _pool(mod, cfg, **kw):
    if mod is port_adapters:
        kw["device"] = "cpu"
    return mod.AdapterPool(cfg, **kw)


MODS = pytest.mark.parametrize("mod", [jax_adapters, port_adapters],
                               ids=["jax", "port"])


@MODS
def test_pool_register_validation(mod):
    cfg = JaxConfig(**KW)
    with pytest.raises(Exception, match="slots"):
        _pool(mod, cfg, slots=1)
    pool = _pool(mod, cfg, slots=3, max_rank=4)
    w = mod.random_lora(cfg, rank=2)
    for bad_id in (None, 0):
        with pytest.raises(Exception, match="reserved"):
            pool.register(bad_id, w)
    with pytest.raises(Exception, match="max_rank"):
        pool.register("big", mod.random_lora(cfg, rank=8))
    with pytest.raises(Exception, match="shapes"):
        pool.register("shape", dict(w, A=w["A"][:, :1]))
    with pytest.raises(Exception, match="not registered"):
        pool.acquire("ghost")
    pool.register("ok", w)
    assert pool.has("ok") and pool.has(None) and pool.has(0)
    assert not pool.has("ghost")
    assert pool.num_registered == 1 and pool.num_resident == 0


@MODS
def test_pool_acquire_release_lru_and_null(mod):
    cfg = JaxConfig(**KW)
    pool = _pool(mod, cfg, slots=3, max_rank=2)    # 2 usable slots
    for name in ("a", "b", "c"):
        pool.register(name, mod.random_lora(cfg, rank=2))
    assert pool.acquire(None) == 0 and pool.acquire(0) == 0
    sa, sb = pool.acquire("a"), pool.acquire("b")
    assert sa != sb and 0 not in (sa, sb)
    assert pool.page_ins == 2 and pool.num_resident == 2
    pool.release("a")
    pool.release("b")
    # both stay warm until a page-in needs a slot; 'a' is the LRU
    assert pool.num_resident == 2 and pool.num_pinned == 0
    assert pool.acquire("c") == sa and pool.evictions == 1
    assert pool.slot_of("a") is None and pool.slot_of("b") == sb
    before = pool.page_ins
    assert pool.acquire("b") == sb and pool.page_ins == before
    assert pool.audit(assignments=["c", "b"]) == []
    assert pool.snapshot()["pinned"] == {"b": 1, "c": 1}


@MODS
def test_pool_exhaustion_is_loud_and_pins_protect(mod):
    cfg = JaxConfig(**KW)
    pool = _pool(mod, cfg, slots=3, max_rank=2)
    for name in ("a", "b", "c"):
        pool.register(name, mod.random_lora(cfg, rank=2))
    pool.acquire("a")
    pool.acquire("b")
    with pytest.raises(mod.AdapterPoolExhausted):
        pool.acquire("c")
    with pytest.raises(Exception, match="pin"):
        pool.evict("a")
    with pytest.raises(Exception, match="pinned"):
        pool.register("a", mod.random_lora(cfg, rank=2))
    pool.release("a")
    assert pool.acquire("c") is not None       # LRU-evicts unpinned 'a'
    with pytest.raises(Exception, match="non-resident"):
        pool.release("a")
    pool.release("b")
    pool.release("c")
    assert pool.audit() == []


@MODS
def test_pool_audit_catches_leaked_and_missing_pins(mod):
    cfg = JaxConfig(**KW)
    pool = _pool(mod, cfg, slots=3, max_rank=2)
    pool.register("a", mod.random_lora(cfg, rank=2))
    slot = pool.acquire("a")
    assert any("leaked" in s for s in pool.audit(assignments=[]))
    assert any("pin count" in s
               for s in pool.audit(assignments=["a", "a"]))
    with pytest.raises(Exception, match="audit failed"):
        pool.audit(assignments=[], raise_on_error=True)
    pool.release("a")
    assert pool.audit(assignments=[]) == []
    pool._adapter_at[slot] = "a"               # corrupt behind the API
    pool._adapter_at[2 if slot != 2 else 1] = "a"
    assert any("resident" in s for s in pool.audit())


@pytest.mark.parametrize("dtype", [None, "int8"])
def test_random_lora_and_slab_bytes_equal_jax(dtype):
    cfg = JaxConfig(**KW)
    for seed, rank in ((1, 4), (2, 8), (3, 2)):
        a = random_lora(cfg, rank=rank, seed=seed, alpha=16.0)
        b = jax_adapters.random_lora(cfg, rank=rank, seed=seed, alpha=16.0)
        assert a.keys() == b.keys() and a["rank"] == b["rank"]
        for k in ("A", "B"):
            np.testing.assert_array_equal(a[k], b[k])
    port = AdapterPool(cfg, slots=4, max_rank=8, dtype=dtype, device="cpu")
    ref = jax_adapters.AdapterPool(cfg, slots=4, max_rank=8, dtype=dtype)
    for pool in (port, ref):
        for i in (1, 2, 3):
            pool.register(i, jax_adapters.random_lora(cfg, rank=2 + 2 * i,
                                                      seed=i))
            pool.acquire(i)
    leaves = ("A", "B", "scale") + (("a_scale", "b_scale") if dtype else ())
    for leaf in leaves:
        np.testing.assert_array_equal(getattr(port, leaf).numpy(),
                                      np.asarray(getattr(ref, leaf)))
    assert port.slab_bytes() == ref.slab_bytes()
    for i in (1, 2, 3):
        e, f = port.effective_weights(i), ref.effective_weights(i)
        np.testing.assert_array_equal(e["A"], f["A"])
        np.testing.assert_array_equal(e["B"], f["B"])


# ---------------------------------------------------------------------------
# the forward and the engine
# ---------------------------------------------------------------------------

def test_null_adapter_is_bit_identical_to_no_pool(jax_model):
    """Rows on slab slot 0 add an exact zero: the logits equal the
    adapter-free forward's bit for bit, and so do greedy and sampled
    engine streams (half the requests spell the null adapter 0)."""
    _, arrays = jax_model
    cfg = GPT2Config(**KW)
    net = _port_net(arrays)
    pool = AdapterPool(cfg, slots=3, max_rank=4, device="cpu")
    pool.register("unused", random_lora(cfg, rank=4, seed=9))
    pool.acquire("unused")
    ids = torch.from_numpy(np.random.default_rng(2).integers(0, 97, (3, 9)))
    with torch.no_grad():
        want = net(ids)
        got = net(ids, adapters=pool.batch(torch.zeros(3, dtype=torch.int32)))
    assert torch.equal(got, want)
    pool.release("unused")
    prompts = _prompts(5, seed=4)
    wear = [None, 0, None, 0, None]
    for kw in (dict(), dict(prefix_cache=True),
               dict(speculative=True, spec_tokens=3)):
        sk = dict(do_sample=True, temperature=0.8)
        plain = ServingEngine(net, device="cpu", **ENGINE, **kw)
        with_pool = ServingEngine(net, device="cpu", adapter_pool=pool,
                                  **ENGINE, **kw)
        assert _serve(with_pool, prompts, Request, wear) \
            == _serve(plain, prompts, Request)
        assert _serve(with_pool, prompts, Request, wear, **sk) \
            == _serve(plain, prompts, Request, **sk)
        assert with_pool.audit_pages() == []


@pytest.mark.parametrize("dtype", [None, "int8"])
def test_mixed_adapter_batch_matches_jax_and_the_merged_oracle(jax_model,
                                                               dtype):
    """Four slots, four adapters (one null) in the same dispatches: each
    slot's greedy stream equals the JAX engine's with the same pool and
    a plain engine's over its merged weights (for an int8 slab: over its
    effective weights)."""
    jnet, arrays = jax_model
    cfg = JaxConfig(**KW)
    adapters = {f"a{i}": random_lora(cfg, rank=2 + i % 3, seed=20 + i,
                                     scale=0.05) for i in range(3)}
    port_pool = AdapterPool(cfg, slots=5, max_rank=4, dtype=dtype,
                            device="cpu")
    jax_pool = jax_adapters.AdapterPool(cfg, slots=5, max_rank=4,
                                        dtype=dtype)
    for name, w in adapters.items():
        port_pool.register(name, w)
        jax_pool.register(name, w)
    prompts = _prompts(4, seed=2)
    wear = ["a0", "a1", "a2", None]
    eng = ServingEngine(_port_net(arrays), device="cpu",
                        adapter_pool=port_pool, **ENGINE)
    got = _serve(eng, prompts, Request, wear)
    assert eng.stats["prefills"] == 4 and eng.audit_pages() == []
    assert eng.stats["adapter_page_ins"] == 3
    jeng = JaxEngine(jnet, attn_impl="xla", adapter_pool=jax_pool, **ENGINE)
    assert got == _serve(jeng, prompts, JaxRequest, wear)
    for i, aid in enumerate(wear):
        lora = None if aid is None else port_pool.effective_weights(aid)
        oracle = ServingEngine(_port_net(arrays, lora), device="cpu",
                               **ENGINE)
        assert _serve(oracle, prompts[i:i + 1], Request) == [got[i]], i


def test_lora_delta_is_the_merged_weight_product(jax_model):
    """One forward with an adapter equals the merged-weight model's
    logits within 1e-5 relative (float32)."""
    _, arrays = jax_model
    cfg = GPT2Config(**KW)
    w = random_lora(cfg, rank=4, seed=7, scale=0.1)
    pool = AdapterPool(cfg, slots=2, max_rank=4, device="cpu")
    pool.register("x", w)
    slot = pool.acquire("x")
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, 97, (2, 11)))
    with torch.no_grad():
        got = _port_net(arrays)(ids, adapters=AdapterBatch(
            pool.A, pool.B, pool.scale,
            torch.full((2,), slot, dtype=torch.int32)))
        want = _port_net(arrays, w)(ids)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


def test_eviction_and_page_ins_under_churn(jax_model):
    """Four adapters over three usable slab slots: eviction and page-in
    run, the stats count them, every stream equals the JAX engine's."""
    jnet, arrays = jax_model
    cfg = JaxConfig(**KW)
    port_pool = AdapterPool(cfg, slots=4, max_rank=8, device="cpu")
    jax_pool = jax_adapters.AdapterPool(cfg, slots=4, max_rank=8)
    for i, rank in zip((1, 2, 3, 4), (4, 8, 8, 8)):
        w = random_lora(cfg, rank=rank, seed=i)
        port_pool.register(i, w)
        jax_pool.register(i, w)
    prompts = _prompts(8, seed=6)
    wear = [1, 2, None, 3, 4, 1, 0, 2]
    eng = ServingEngine(_port_net(arrays), device="cpu",
                        adapter_pool=port_pool, retry_backoff_s=0.0,
                        **ENGINE)
    got = _serve(eng, prompts, Request, wear)
    jeng = JaxEngine(jnet, attn_impl="xla", adapter_pool=jax_pool,
                     retry_backoff_s=0.0, **ENGINE)
    assert got == _serve(jeng, prompts, JaxRequest, wear)
    st = eng.stats
    assert st["adapter_evictions"] > 0
    assert st["adapter_page_ins"] == port_pool.page_ins \
        == jeng.stats["adapter_page_ins"]
    assert st["adapter_evictions"] == jeng.stats["adapter_evictions"]
    assert eng.audit_pages() == [] and port_pool.num_pinned == 0


def test_slab_exhaustion_is_backpressure(jax_model):
    _, arrays = jax_model
    cfg = GPT2Config(**KW)
    pool = AdapterPool(cfg, slots=2, max_rank=2, device="cpu")  # 1 usable
    pool.register("x", random_lora(cfg, rank=2, seed=1))
    pool.register("y", random_lora(cfg, rank=2, seed=2))
    eng = ServingEngine(_port_net(arrays), device="cpu", adapter_pool=pool,
                        retry_backoff_s=0.0, **ENGINE)
    reqs = [Request([5, 6, 7], 4, request_id="rx", adapter_id="x"),
            Request([5, 6, 8], 4, request_id="ry", adapter_id="y")]
    done = eng.serve(reqs)
    assert {r.id: r.status for r in done} == {"rx": "finished",
                                              "ry": "finished"}
    assert eng.stats["dispatch_retries"] > 0
    assert eng.audit_pages() == [] and pool.num_pinned == 0


def test_unknown_adapter_rejected_at_submit(jax_model):
    _, arrays = jax_model
    cfg = GPT2Config(**KW)
    net = _port_net(arrays)
    eng = ServingEngine(net, device="cpu", **ENGINE)
    with pytest.raises(MXNetError, match="no adapter pool"):
        eng.submit(Request([1, 2], 2, adapter_id="x"))
    pool = AdapterPool(cfg, slots=3, max_rank=2, device="cpu")
    eng = ServingEngine(net, device="cpu", adapter_pool=pool, **ENGINE)
    with pytest.raises(MXNetError, match="not registered"):
        eng.submit(Request([1, 2], 2, adapter_id="x"))
    assert eng.scheduler.num_queued == 0
    small = AdapterPool(GPT2Config(**dict(KW, num_layers=1)), slots=2,
                        max_rank=2, device="cpu")
    with pytest.raises(MXNetError, match="layers or units"):
        ServingEngine(net, device="cpu", adapter_pool=small, **ENGINE)


def test_w8_int8_kv_and_int8_slab_together_match_jax(jax_model):
    """The whole quantized stack in one engine (the reference's
    test_engine_w8_int8kv_adapter_matches_merged_oracle): w8 weights,
    int8 KV pages and an int8 LoRA slab give the JAX engine's greedy
    streams."""
    jnet, arrays = jax_model
    cfg = JaxConfig(**KW)
    w = random_lora(cfg, rank=3, alpha=8.0, seed=21)
    port_pool = AdapterPool(cfg, slots=3, max_rank=4, dtype="int8",
                            device="cpu")
    jax_pool = jax_adapters.AdapterPool(cfg, slots=3, max_rank=4,
                                        dtype="int8")
    port_pool.register("t", w)
    jax_pool.register("t", w)
    prompts = _prompts(4, seed=17)
    wear = ["t", "t", None, "t"]
    kw = dict(ENGINE, num_slots=2, weight_dtype="int8", kv_dtype="int8",
              prefill_chunk_budget=64)
    eng = ServingEngine(_port_net(arrays), device="cpu",
                        adapter_pool=port_pool, **kw)
    got = _serve(eng, prompts, Request, wear, max_new=6)
    jeng = JaxEngine(jnet, attn_impl="xla", adapter_pool=jax_pool, **kw)
    assert got == _serve(jeng, prompts, JaxRequest, wear, max_new=6)
    assert eng.audit_pages() == []
