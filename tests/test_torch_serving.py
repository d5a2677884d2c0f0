"""The port's serving engine, sampler, scheduler and page pool against
the JAX package, and the port's package rules.

The engine bar: on the same weights (a seeded JAX tiny GPT-2 carried
across as numpy arrays) and the same mixed-length traffic, the port's
greedy token streams are IDENTICAL to the JAX ServingEngine's
(attn_impl="xla"), at chunk_tokens 4 and 8, including a request that
runs its slot to max_length. Sampled streams follow the port's own
counter-based generator, so they are held to the port itself (schedule
independence) and to the sampling distribution (total variation).
"""
import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as mx  # noqa: E402
import mxnet_tpu.serving.page_pool as jax_page_pool  # noqa: E402
import mxnet_tpu.serving.scheduler as jax_scheduler  # noqa: E402
from mxnet_tpu.models import GPT2Config as JaxConfig  # noqa: E402
from mxnet_tpu.models import GPT2ForCausalLM as JaxGPT2  # noqa: E402
from mxnet_tpu.serving import Request as JaxRequest  # noqa: E402
from mxnet_tpu.serving import ServingEngine as JaxEngine  # noqa: E402
from mxnet_tpu.serving import sampling as jax_sampling  # noqa: E402
import mxnet_tpu_torch.serving.page_pool as port_page_pool  # noqa: E402
import mxnet_tpu_torch.serving.scheduler as port_scheduler  # noqa: E402
from mxnet_tpu_torch import MXNetError  # noqa: E402
from mxnet_tpu_torch.models import (GPT2Config, GPT2ForCausalLM,  # noqa: E402
                                    PagedKVCache, load_jax_params)
from mxnet_tpu_torch.serving import (QueueFullError, Request,  # noqa: E402
                                     ServingEngine, filtered_logits,
                                     sample_tokens)
from mxnet_tpu_torch.serving.sampling import uniforms  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
KW = dict(vocab_size=97, units=32, num_layers=2, num_heads=2,
          max_length=64, dropout=0.0, attention_dropout=0.0)
ENGINE = dict(num_slots=3, max_length=64, page_size=8)
# (prompt length, max_new_tokens): mixed lengths; the 40-token prompt
# asks for 30 and gets max_length - 40 + 1 = 25, running its slot to
# max_length (dead rows past the position table on its last dispatches)
TRAFFIC = [(3, 12), (9, 10), (17, 12), (5, 8), (40, 30), (1, 9), (26, 11)]


@pytest.fixture(scope="module")
def pair():
    jnet = JaxGPT2(JaxConfig(**KW))
    mx.rng.seed(3)
    jnet.initialize(mx.init.Normal(0.05))
    arrays = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    net = load_jax_params(GPT2ForCausalLM(GPT2Config(**KW), device="cpu"),
                          arrays)
    return jnet, net


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(21)
    return [rng.integers(0, KW["vocab_size"], n).tolist()
            for n, _ in TRAFFIC]


_JAX_STREAMS = {}


def _jax_streams(jnet, prompts, chunk_tokens):
    """The JAX engine's greedy streams for TRAFFIC (computed once per
    chunk size per test session)."""
    if chunk_tokens not in _JAX_STREAMS:
        eng = JaxEngine(jnet, attn_impl="xla", chunk_tokens=chunk_tokens,
                        **ENGINE)
        reqs = [JaxRequest(p, n, request_id=i)
                for i, (p, (_, n)) in enumerate(zip(prompts, TRAFFIC))]
        eng.serve(reqs)
        _JAX_STREAMS[chunk_tokens] = [r.output_tokens for r in reqs]
    return _JAX_STREAMS[chunk_tokens]


def _port_serve(net, reqs, **kw):
    eng = ServingEngine(net, device="cpu", **dict(ENGINE, **kw))
    done = eng.serve(reqs)
    assert eng.page_pool.audit(raise_on_error=True) == []
    assert eng.scheduler.num_free == eng.num_slots
    return eng, done


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk_tokens", [4, 8])
def test_engine_greedy_matches_jax(pair, prompts, chunk_tokens):
    jnet, net = pair
    want = _jax_streams(jnet, prompts, chunk_tokens)
    reqs = [Request(p, n, request_id=i)
            for i, (p, (_, n)) in enumerate(zip(prompts, TRAFFIC))]
    eng, done = _port_serve(net, reqs, chunk_tokens=chunk_tokens)
    assert [r.output_tokens for r in reqs] == want
    assert len(want[4]) == KW["max_length"] - 40 + 1      # ran to capacity
    assert [r.id for r in done] == list(range(len(reqs)))
    assert all(r.status == "finished" for r in reqs)
    assert eng.stats["requests_finished"] == len(reqs)
    assert eng.stats["tokens_emitted"] == sum(map(len, want))
    assert eng.stats["prefill_tokens"] == sum(n for n, _ in TRAFFIC)


def test_engine_eos_stops_at_first_eos(pair, prompts):
    """eos = a token of the JAX free-run stream that does not occur
    earlier in it: the port emits the stream through that token, then
    frees the slot; the other requests are untouched."""
    jnet, net = pair
    want = _jax_streams(jnet, prompts, 8)
    i, stream = 2, want[2]
    k = next(k for k in range(2, len(stream)) if stream[k] not in stream[:k])
    reqs = [Request(p, n, request_id=j,
                    eos_token_id=stream[k] if j == i else None)
            for j, (p, (_, n)) in enumerate(zip(prompts, TRAFFIC))]
    _port_serve(net, reqs, chunk_tokens=8)
    assert reqs[i].output_tokens == stream[:k + 1]
    assert reqs[i].status == "finished"
    for j, r in enumerate(reqs):
        if j != i:
            assert r.output_tokens == want[j]


def test_engine_greedy_invariant_to_chunking_and_budget(pair, prompts):
    """A one-chunk-per-dispatch prefill budget (slots take turns) emits
    the same greedy streams as the JAX engine at chunk 8."""
    jnet, net = pair
    want = _jax_streams(jnet, prompts, 8)
    reqs = [Request(p, n, request_id=i)
            for i, (p, (_, n)) in enumerate(zip(prompts, TRAFFIC))]
    _port_serve(net, reqs, chunk_tokens=4, prefill_chunk_budget=4)
    assert [r.output_tokens for r in reqs] == want


def test_greedy_rows_of_a_sampled_dispatch_match_jax(pair, prompts):
    """Greedy requests sharing dispatches with sampled ones take the
    argmax of the raw logits: still the JAX greedy stream."""
    jnet, net = pair
    want = _jax_streams(jnet, prompts, 8)
    reqs = [Request(p, n, request_id=i, do_sample=(i % 2 == 1),
                    temperature=0.8, top_k=20, top_p=0.95, seed=100 + i)
            for i, (p, (_, n)) in enumerate(zip(prompts, TRAFFIC))]
    _port_serve(net, reqs, chunk_tokens=8)
    for i, r in enumerate(reqs):
        if i % 2 == 0:
            assert r.output_tokens == want[i]
        assert len(r.output_tokens) == len(want[i])
        assert all(0 <= t < KW["vocab_size"] for t in r.output_tokens)


def test_sampled_streams_reproducible_across_admission_order(pair):
    _, net = pair
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, KW["vocab_size"], n).tolist()
               for n in (3, 7, 11, 5)]

    def run(order, slots, chunk):
        reqs = [Request(prompts[i], 6, do_sample=True, temperature=0.8,
                        top_k=20, top_p=0.95, seed=100 + i, request_id=i)
                for i in order]
        _port_serve(net, reqs, num_slots=slots, chunk_tokens=chunk)
        return {r.id: r.output_tokens for r in reqs}

    a = run([0, 1, 2, 3], 2, 4)
    assert a == run([3, 1, 0, 2], 4, 8)
    assert len({tuple(v) for v in a.values()}) == 4


def test_long_prefill_does_not_starve_decoders(pair):
    """While a long prompt streams its chunks, the running slots keep
    emitting exactly one token per dispatch."""
    _, net = pair
    rng = np.random.default_rng(9)
    eng = ServingEngine(net, chunk_tokens=8, device="cpu", **ENGINE)
    short = [Request(rng.integers(0, KW["vocab_size"], 3).tolist(), 20,
                     request_id=f"s{i}") for i in range(2)]
    for r in short:
        eng.submit(r)
    eng.step()
    eng.step()
    counts = {r.id: len(r.output_tokens) for r in short}
    assert all(c >= 1 for c in counts.values())
    long = Request(rng.integers(0, KW["vocab_size"], 48).tolist(), 2,
                   request_id="long")
    eng.submit(long)
    steps_to_first = 0
    while not long.output_tokens:
        eng.step()
        steps_to_first += 1
        for r in short:
            assert len(r.output_tokens) - counts[r.id] == 1
            counts[r.id] = len(r.output_tokens)
    assert steps_to_first == 48 // 8


def test_prefill_chunk_budget_round_robins_concurrent_prompts(pair):
    _, net = pair
    rng = np.random.default_rng(10)
    eng = ServingEngine(net, num_slots=2, max_length=64, page_size=8,
                        chunk_tokens=8, prefill_chunk_budget=8,
                        device="cpu")
    longs = [Request(rng.integers(0, KW["vocab_size"], 24).tolist(), 2,
                     request_id=f"L{i}") for i in range(2)]
    done = eng.serve(longs)
    assert len(done) == 2
    # 2 prompts x 3 chunks, one chunk per dispatch under the budget
    assert eng.stats["prefill_chunks"] == 6
    assert all(len(r.output_tokens) == 2 for r in longs)


# ---------------------------------------------------------------------------
# engine contract: options, rejections, devices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("option,value", [
    ("speculative", True), ("weight_dtype", "int8"), ("tp", 2),
    ("adapter_pool", object()), ("policy", object()),
    ("host_kv_bytes", 1 << 20)])
def test_unported_engine_options_raise(pair, option, value):
    _, net = pair
    with pytest.raises(MXNetError, match="not ported"):
        ServingEngine(net, device="cpu", **{option: value}, **ENGINE)


def test_engine_rejections(pair):
    _, net = pair
    with pytest.raises(TypeError):
        ServingEngine(net, device="cpu", bogus=1, **ENGINE)
    with pytest.raises(MXNetError):
        ServingEngine(net, num_slots=2, max_length=128, device="cpu")
    eng = ServingEngine(net, max_queue=1, device="cpu", **ENGINE)
    with pytest.raises(MXNetError):
        eng.submit(Request([1] * 65, 2))
    with pytest.raises(MXNetError, match="not ported"):
        eng.submit(Request([1, 2], 2, adapter_id="a"))
    with pytest.raises(MXNetError, match="not ported"):
        eng.submit(Request([1, 2], 2, deadline_ms=5.0))
    first, second = Request([1, 2], 2), Request([3], 2)
    eng.submit(first)
    with pytest.raises(QueueFullError):
        eng.submit(second)
    assert second.status == "shed"
    assert eng.serve([]) == [first]


def test_entry_points_default_to_cuda_and_raise_without_it(pair):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None is valid here")
    _, net = pair
    with pytest.raises(MXNetError, match="no CUDA device"):
        GPT2ForCausalLM(GPT2Config(**KW))
    with pytest.raises(MXNetError, match="no CUDA device"):
        ServingEngine(net, **ENGINE)
    with pytest.raises(MXNetError, match="no CUDA device"):
        PagedKVCache.create(1, 2, 1, 8, 2, page_size=4, lengths=[0, 0])


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

KNOBS = [(1.0, 0, 1.0), (0.7, 5, 1.0), (1.3, 0, 0.8), (0.8, 20, 0.95),
         (1.0, 1, 0.0), (0.5, 40, 0.5)]


def test_filtered_logits_equal_jax():
    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((len(KNOBS), 97)) * 3).astype(np.float32)
    temp = np.float32([k[0] for k in KNOBS])
    top_k = np.int32([k[1] for k in KNOBS])
    top_p = np.float32([k[2] for k in KNOBS])
    got = filtered_logits(*(torch.from_numpy(a)
                            for a in (logits, temp, top_k, top_p))).numpy()
    want = np.asarray(jax_sampling.filtered_logits(
        *(jnp.asarray(a) for a in (logits, temp, top_k, top_p))))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    keep = ~np.isneginf(want)
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-6, atol=1e-6)
    # the top-1 token always survives; top_k=1 leaves exactly it
    assert (keep.sum(axis=1) >= 1).all() and keep[4].sum() == 1


def test_sampled_frequencies_follow_the_filtered_distribution():
    """4000 draws of one 8-token row (token indices 0..3999 of one
    request) against softmax(filtered_logits): total variation <= 0.05."""
    n = 4000
    row = torch.tensor([[2.0, 1.5, 1.0, 0.5, 0.0, -0.5, -1.0, -3.0]])
    logits = row.expand(n, 8)
    temp = torch.full((n,), 0.9)
    top_k = torch.full((n,), 6, dtype=torch.int32)
    top_p = torch.full((n,), 0.97)
    seeds = torch.full((n,), 17, dtype=torch.int32)
    counters = torch.arange(n, dtype=torch.int32)
    toks = sample_tokens(logits, seeds, counters, torch.ones(n, dtype=bool),
                         temp, top_k, top_p)
    p = torch.softmax(filtered_logits(row, temp[:1], top_k[:1], top_p[:1]),
                      dim=-1)[0].numpy()
    freq = np.bincount(toks.numpy(), minlength=8) / n
    assert 0.5 * np.abs(freq - p).sum() <= 0.05
    assert (freq[p == 0] == 0).all()          # cut tokens never drawn
    greedy = sample_tokens(logits, seeds, counters,
                           torch.zeros(n, dtype=bool), temp, top_k, top_p)
    assert bool((greedy == 0).all())


def test_uniforms_are_a_pure_function_of_seed_and_counter():
    seeds = torch.tensor([1, 1, 2, -7], dtype=torch.int32)
    counters = torch.tensor([0, 0, 0, 3], dtype=torch.int32)
    u = uniforms(seeds, counters, 1000)
    assert torch.equal(u[0], u[1]) and not torch.equal(u[0], u[2])
    assert bool(((u > 0) & (u < 1)).all())
    assert abs(float(u.mean()) - 0.5) < 0.02
    assert torch.equal(uniforms(seeds[3:], counters[3:], 1000), u[3:])


# ---------------------------------------------------------------------------
# scheduler and page pool: the port's copies behave as the originals
# ---------------------------------------------------------------------------

SCHED = [jax_scheduler, port_scheduler]


@pytest.mark.parametrize("mod", SCHED, ids=["jax", "port"])
def test_scheduler_free_admit_release(mod):
    s = mod.SlotScheduler(2)
    r = [mod.Request([1], 4, request_id=i) for i in range(4)]
    for x in r:
        s.submit(x)
    assert [(sl, rq.id) for sl, rq in s.admit()] == [(0, 0), (1, 1)]
    assert s.num_free == 0 and s.num_queued == 2
    assert s.admit() == []
    assert s.release(0).id == 0
    assert [(sl, rq.id) for sl, rq in s.admit()] == [(0, 2)]
    with pytest.raises(Exception, match="not active"):
        s.release(5)


@pytest.mark.parametrize("mod", SCHED, ids=["jax", "port"])
def test_scheduler_priority_and_aging(mod):
    s = mod.SlotScheduler(1, aging_every=3)
    low = mod.Request([1], 2, request_id="low", priority=2)
    s.submit(low)
    order = []
    for i in range(4):
        s.submit(mod.Request([1], 2, request_id=f"hi{i}", priority=0))
    for _ in range(5):
        (slot, req), = s.admit()
        order.append(req.id)
        s.release(slot)
    # class 0 first, but every 3rd admission takes the oldest: "low"
    assert order == ["hi0", "hi1", "low", "hi2", "hi3"]
    assert not s.has_work


@pytest.mark.parametrize("mod", SCHED, ids=["jax", "port"])
def test_scheduler_bounded_queue(mod):
    s = mod.SlotScheduler(1, max_queue=1)
    s.submit(mod.Request([1], 2))
    with pytest.raises(mod.QueueFullError):
        s.submit(mod.Request([1], 2))
    assert mod.TERMINAL_STATUSES == frozenset(
        {"finished", "cancelled", "deadline", "failed", "shed"})


@pytest.mark.parametrize("mod", [jax_page_pool, port_page_pool],
                         ids=["jax", "port"])
def test_page_pool_lifecycle_and_audit(mod):
    pool = mod.PagePool(6)
    a = pool.alloc(4)
    assert pool.num_free == 2 and (pool.refcounts()[a] == 1).all()
    pool.incref(a[:1])
    assert pool.decref(a) == a[1:]
    pool.free(a[1:])
    assert pool.audit(leases=[a[:1]]) == []
    with pytest.raises(mod.PagePoolExhausted):
        pool.alloc(6)
    with pytest.raises(Exception, match="not allocated"):
        pool.free([a[1]])


# ---------------------------------------------------------------------------
# package rules
# ---------------------------------------------------------------------------

def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "mxnet_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = []
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "mxnet_tpu"):
                bad.append(f"{path.relative_to(ROOT)}: {name}")
    assert bad == []
