"""The port's speculative decoding against the JAX package.

The same seeded weights (a JAX tiny GPT-2 carried across with
load_jax_params) and the same traffic (prompts that repeat a pattern,
so that prompt lookup drafts and the model accepts some drafts) go
through both engines with speculative=True. The bar: greedy streams
equal the JAX engine's and the port's own speculation-off streams token
for token, with the same drafted and accepted counts as the JAX engine;
on int8 pages they equal the JAX engine's (rejected drafts raise page
scales in both, so speculation-off streams are not the oracle there).
The proposer is compared output for output; greedy verification on the
same logits exactly; the sampled verifier, which draws from the port's
own counter-hash streams, is held to the spec-off sampler (zero drafts,
bit for bit) and to the target distribution (total variation).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu.models import GPT2Config as JaxConfig  # noqa: E402
from mxnet_tpu.models import GPT2ForCausalLM as JaxGPT2  # noqa: E402
from mxnet_tpu.serving import PromptLookupProposer as JaxProposer  # noqa: E402
from mxnet_tpu.serving import Request as JaxRequest  # noqa: E402
from mxnet_tpu.serving import ServingEngine as JaxEngine  # noqa: E402
from mxnet_tpu.serving import verify_tokens as jax_verify  # noqa: E402
from mxnet_tpu_torch import MXNetError  # noqa: E402
from mxnet_tpu_torch.models import (GPT2Config, GPT2ForCausalLM,  # noqa: E402
                                    PagedKVCache, load_jax_params)
from mxnet_tpu_torch.serving import (PromptLookupProposer, Request,  # noqa: E402
                                     ServingEngine, filtered_logits,
                                     sample_tokens, verify_tokens)

KW = dict(vocab_size=97, units=32, num_layers=2, num_heads=4,
          max_length=64, dropout=0.0, attention_dropout=0.0)
ENGINE = dict(num_slots=3, max_length=64, page_size=8)
N_NEW = 16


@pytest.fixture(scope="module")
def pair():
    jnet = JaxGPT2(JaxConfig(**KW))
    mx.rng.seed(3)
    jnet.initialize(mx.init.Normal(0.05))
    arrays = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    net = load_jax_params(GPT2ForCausalLM(GPT2Config(**KW), device="cpu"),
                          arrays)
    return jnet, net


def _pattern_prompts(seed, n=6, prefix=()):
    """A random head of 2-5 tokens, then a 4-token pattern repeated 2-4
    times: prompt lookup finds drafts from the first decode on."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        head = rng.integers(0, KW["vocab_size"], int(rng.integers(2, 6)))
        pat = rng.integers(0, KW["vocab_size"], 4)
        out.append(list(prefix) + head.tolist()
                   + pat.tolist() * int(rng.integers(2, 5)))
    return out


def _jax_serve(jnet, prompts, **kw):
    eng = JaxEngine(jnet, attn_impl="xla", **dict(ENGINE, **kw))
    reqs = [JaxRequest(p, N_NEW, request_id=i) for i, p in enumerate(prompts)]
    eng.serve(reqs)
    return [r.output_tokens for r in reqs], eng.stats


def _port_serve(net, prompts, **kw):
    eng = ServingEngine(net, device="cpu", **dict(ENGINE, **kw))
    reqs = [Request(p, N_NEW, request_id=i) for i, p in enumerate(prompts)]
    eng.serve(reqs)
    assert eng.audit_pages() == []
    assert eng.scheduler.num_free == eng.num_slots
    return [r.output_tokens for r in reqs], eng


# ---------------------------------------------------------------------------
# the proposer and the verifier against the JAX functions
# ---------------------------------------------------------------------------

def test_proposer_drafts_equal_jax():
    rng = np.random.default_rng(0)
    cases = 0
    for max_draft, max_ng, min_ng in [(3, 3, 1), (7, 3, 1), (4, 2, 2),
                                      (1, 1, 1), (8, 4, 2)]:
        port = PromptLookupProposer(max_draft, max_ng, min_ng)
        ref = JaxProposer(max_draft, max_ng, min_ng)
        for n in range(0, 40, 3):
            for vocab in (3, 7, 50):
                h = rng.integers(0, vocab, n).tolist()
                got, want = port.propose(h), ref.propose(h)
                assert got.dtype == np.int32
                np.testing.assert_array_equal(got, want)
                cases += got.size > 0
    assert cases > 50               # most histories gave drafts
    with pytest.raises(ValueError):
        PromptLookupProposer(0)
    with pytest.raises(ValueError):
        PromptLookupProposer(3, max_ngram=1, min_ngram=2)


def _verify_inputs(B=6, S=4, V=11, seed=1):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, S, V)) * 2).astype(np.float32)
    greedy = logits.argmax(-1)
    # drafts: the greedy chain for a random prefix, then a wrong token
    drafts = rng.integers(0, V, (B, S - 1)).astype(np.int32)
    for b in range(B):
        k = b % S
        drafts[b, :k] = greedy[b, :k]
    n_draft = np.int32([0, 1, 2, 3, 3, 2])[:B]
    return logits, drafts, n_draft


def test_verify_greedy_equals_jax():
    logits, drafts, n_draft = _verify_inputs()
    B = logits.shape[0]
    knobs = dict(seeds=np.arange(B, dtype=np.int32),
                 counters=np.zeros(B, np.int32),
                 do_sample=np.zeros(B, bool),
                 temperature=np.ones(B, np.float32),
                 top_k=np.zeros(B, np.int32), top_p=np.ones(B, np.float32))
    want_e, want_n = jax_verify(jnp.asarray(logits), jnp.asarray(drafts),
                                jnp.asarray(n_draft),
                                *(jnp.asarray(v) for v in knobs.values()))
    for greedy_only in (True, False):
        got_e, got_n = verify_tokens(
            torch.from_numpy(logits), torch.from_numpy(drafts),
            torch.from_numpy(n_draft),
            *(torch.from_numpy(v) for v in knobs.values()),
            greedy_only=greedy_only)
        np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
        np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    assert np.asarray(want_n).tolist() == [0, 1, 2, 3, 0, 1]


def test_verify_zero_drafts_bit_match_the_sampler():
    """With no drafts every position j draws exactly what sample_tokens
    draws for token index counters + j: a zero-draft dispatch is the
    speculation-off sampler."""
    B, S, V = 5, 4, 40
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.standard_normal((B, S, V)).astype(
        np.float32) * 2)
    seeds = torch.tensor([3, 3, 9, -4, 1000], dtype=torch.int32)
    counters = torch.tensor([0, 7, 2, 11, 5], dtype=torch.int32)
    do_sample = torch.tensor([True, True, True, False, True])
    temp = torch.tensor([1.0, 0.7, 1.3, 1.0, 0.9])
    top_k = torch.tensor([0, 5, 0, 0, 12], dtype=torch.int32)
    top_p = torch.tensor([1.0, 0.9, 0.8, 1.0, 1.0])
    drafts = torch.from_numpy(rng.integers(0, V, (B, S - 1)).astype(np.int32))
    emitted, n_acc = verify_tokens(logits, drafts,
                                   torch.zeros(B, dtype=torch.int32), seeds,
                                   counters, do_sample, temp, top_k, top_p)
    assert n_acc.tolist() == [0] * B
    for j in range(S):
        want = sample_tokens(logits[:, j], seeds, counters + j, do_sample,
                             temp, top_k, top_p)
        assert torch.equal(emitted[:, j], want), j


@pytest.mark.parametrize("draft", [0, 2, 5])
def test_rejection_sampler_follows_the_filtered_distribution(draft):
    """2400 requests (seeds) verify one draft at position 0: the emitted
    token's frequencies lie within total variation 0.05 of
    softmax(filtered_logits), whatever the draft's own mass (token 0 is
    the most likely, 5 is cut by top-k)."""
    n, V = 2400, 8
    row = torch.tensor([2.0, 1.5, 1.0, 0.5, 0.0, -0.5, -1.0, -3.0])
    logits = row.expand(n, 2, V).contiguous()
    temp = torch.full((n,), 0.9)
    top_k = torch.full((n,), 5, dtype=torch.int32)
    top_p = torch.full((n,), 0.97)
    seeds = torch.arange(n, dtype=torch.int32) * 7 + 1
    emitted, n_acc = verify_tokens(
        logits, torch.full((n, 1), draft, dtype=torch.int32),
        torch.ones(n, dtype=torch.int32), seeds,
        torch.zeros(n, dtype=torch.int32), torch.ones(n, dtype=torch.bool),
        temp, top_k, top_p)
    p = torch.softmax(filtered_logits(row[None], temp[:1], top_k[:1],
                                      top_p[:1]), dim=-1)[0].numpy()
    freq = np.bincount(emitted[:, 0].numpy(), minlength=V) / n
    assert 0.5 * np.abs(freq - p).sum() <= 0.05, (freq, p)
    assert (freq[p == 0] == 0).all()
    # the accepted share is the draft's own mass
    assert abs(float(n_acc.float().mean()) - p[draft]) <= 0.04


# ---------------------------------------------------------------------------
# multi-token ragged writes (the reference's tests/test_speculative.py)
# ---------------------------------------------------------------------------

def test_write_decode_multitoken_lands_at_per_slot_offsets():
    B, H, D, S, t = 2, 1, 2, 4, 3
    cache = PagedKVCache.create(1, B, H, 12, D, page_size=S,
                                lengths=np.int32([1, 6]), device="cpu")
    val = (torch.arange(B * t, dtype=torch.float32).reshape(B, 1, t, 1)
           + 1.0).expand(B, H, t, D)
    cache.write_decode(0, val, 2 * val)
    pool = cache.k_pages[0, :cache.num_pages].numpy()
    table = cache.page_table.numpy()
    for b, length in enumerate([1, 6]):
        for j in range(t):
            page, slot = divmod(length + j, S)
            assert pool[table[b, page], slot, 0, 0] == b * t + j + 1.0
    assert (pool != 0).sum() == B * t * D   # nothing else touched


def test_write_decode_multitoken_drops_past_capacity_and_locked():
    """Slot 0 one position from capacity (7 of 8); slot 1 writes into a
    locked page: every dropped row leaves the pool untouched (the
    reference drops them; the port sends them to the trash page)."""
    B, H, D, S, t = 2, 1, 2, 4, 3
    c = PagedKVCache.create(1, B, H, 8, D, page_size=S,
                            lengths=np.int32([7, 2]), device="cpu")
    lock = torch.zeros(c.num_pages, dtype=torch.bool)
    lock[int(c.page_table[1, 0])] = True
    cache = PagedKVCache(c.k_pages, c.v_pages, c.page_table, c.length,
                         page_lock=lock)
    val = torch.full((B, H, t, D), 7.0)
    cache.write_decode(0, val, val)
    pool = cache.k_pages[0, :cache.num_pages].numpy()
    table = cache.page_table.numpy()
    # slot 0: position 7 written, 8 and 9 dropped (capacity)
    assert pool[table[0, 1], 3, 0, 0] == 7.0
    assert (pool[table[0]] != 0).sum() == D
    # slot 1: positions 2, 3 aimed at the locked page 0 -> dropped;
    # position 4 lands in page 1
    assert (pool[table[1, 0]] == 0).all()
    assert pool[table[1, 1], 0, 0, 0] == 7.0


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk_tokens", [4, 8])
def test_engine_spec_greedy_matches_jax_and_spec_off(pair, chunk_tokens):
    jnet, net = pair
    prompts = _pattern_prompts(2)
    want, jstats = _jax_serve(jnet, prompts, chunk_tokens=chunk_tokens,
                              speculative=True, spec_tokens=4)
    got, eng = _port_serve(net, prompts, chunk_tokens=chunk_tokens,
                           speculative=True, spec_tokens=4)
    off, off_eng = _port_serve(net, prompts, chunk_tokens=chunk_tokens)
    assert got == want
    assert got == off
    st = eng.stats
    assert st["spec_draft_tokens"] == jstats["spec_draft_tokens"]
    assert st["spec_accepted_tokens"] == jstats["spec_accepted_tokens"]
    assert st["spec_rollbacks"] == jstats["spec_rollbacks"]
    assert st["spec_accepted_tokens"] > 0
    assert st["decode_dispatches"] == jstats["decode_dispatches"] \
        < off_eng.stats["decode_dispatches"]
    assert st["tokens_emitted"] == sum(map(len, want)) == len(want) * N_NEW
    assert eng._width == max(chunk_tokens, 4)


def test_engine_spec_with_prefix_cache_matches_jax(pair):
    """Shared 16-token prefix (two pages) with the prefix cache on: the
    drafts' KV writes must not land in the cached pages (they are
    locked; the writes go to the trash page)."""
    jnet, net = pair
    prefix = np.random.default_rng(5).integers(0, 97, 16).tolist()
    prompts = _pattern_prompts(4, n=5, prefix=prefix) + [prefix]
    kw = dict(chunk_tokens=8, speculative=True, spec_tokens=4,
              prefix_cache=True)
    want, jstats = _jax_serve(jnet, prompts, **kw)
    got, eng = _port_serve(net, prompts, **kw)
    off, _ = _port_serve(net, prompts, chunk_tokens=8)
    assert got == want == off
    assert eng.stats["prefix_hits"] == jstats["prefix_hits"] > 0
    assert eng.stats["spec_accepted_tokens"] \
        == jstats["spec_accepted_tokens"]


def test_engine_spec_int8_matches_jax(pair):
    """On int8 pages rejected drafts raise the pages' scales in both
    packages alike: the port's streams equal the JAX engine's."""
    jnet, net = pair
    prompts = _pattern_prompts(2)
    kw = dict(chunk_tokens=8, speculative=True, spec_tokens=4,
              kv_dtype="int8")
    want, jstats = _jax_serve(jnet, prompts, **kw)
    got, eng = _port_serve(net, prompts, **kw)
    assert got == want
    assert eng.stats["spec_draft_tokens"] == jstats["spec_draft_tokens"]
    assert eng.stats["spec_accepted_tokens"] \
        == jstats["spec_accepted_tokens"]


def test_engine_spec_eos_and_budget_inside_an_accepted_run(pair):
    """eos inside an accepted run stops the stream there, and a budget
    smaller than the run cuts it: speculation on equals speculation
    off."""
    _, net = pair
    prompts = _pattern_prompts(7, n=3)
    free, _ = _port_serve(net, prompts, chunk_tokens=8)
    eos = {}
    for i, s in enumerate(free):
        k = next((k for k in range(2, len(s)) if s[k] not in s[:k]), None)
        if k is not None:
            eos[i] = s[k]
    assert eos
    for budget in (N_NEW, 5):
        outs = []
        for spec in (True, False):
            eng = ServingEngine(net, device="cpu", chunk_tokens=8,
                                speculative=spec, spec_tokens=5, **ENGINE)
            reqs = [Request(p, budget, request_id=i,
                            eos_token_id=eos.get(i))
                    for i, p in enumerate(prompts)]
            eng.serve(reqs)
            outs.append([r.output_tokens for r in reqs])
        assert outs[0] == outs[1]
        for i, s in enumerate(outs[0]):
            assert len(s) <= budget
            if i in eos and eos[i] in s:
                assert s.index(eos[i]) == len(s) - 1


def test_engine_spec_sampled_streams_are_schedule_independent(pair):
    """Sampled speculative streams depend only on (seed, token index,
    the request's own history): the same at num_slots 1 and 3."""
    _, net = pair
    prompts = _pattern_prompts(4, n=4)
    outs = []
    for slots in (1, 3):
        eng = ServingEngine(net, device="cpu", num_slots=slots,
                            max_length=64, page_size=8, chunk_tokens=8,
                            speculative=True, spec_tokens=4)
        reqs = [Request(p, 12, request_id=i, seed=40 + i, do_sample=True,
                        temperature=0.8, top_k=20)
                for i, p in enumerate(prompts)]
        eng.serve(reqs)
        outs.append([r.output_tokens for r in reqs])
        assert eng.stats["spec_draft_tokens"] > 0
    assert outs[0] == outs[1]
    assert all(len(s) == 12 for s in outs[0])


def test_engine_spec_rejects_short_window(pair):
    _, net = pair
    with pytest.raises(MXNetError, match="spec_tokens"):
        ServingEngine(net, device="cpu", speculative=True, spec_tokens=1,
                      **ENGINE)
