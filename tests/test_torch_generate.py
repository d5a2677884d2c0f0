"""The port's lockstep KV caches and GPT-2 `generate` against the JAX
package.

The contiguous KVCache and the scalar-length PagedKVCache (a permuted
page table, float and int8 pools) take the same writes as the
reference's: the returned (B, H, T_max, D) views and the buffers are the
same bytes (int8 views dequantized to 1e-6), and so are the key masks.
A tiny GPT-2 (the `_tiny` configuration of tests/test_serving.py) is
built and seeded in the JAX package and carried across with
models/convert.load_jax_params; its greedy `generate` emits the JAX
package's tokens over both cache kinds, with eos padding and the early
exit. Sampled decoding draws from a torch.Generator (not jax.random), so
it is held to its own contract: top_k=1 is greedy, every token lies in
the top-k set, a seed repeats its tokens and top_p=1.0 filters nothing.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu.models import GPT2Config as JaxConfig  # noqa: E402
from mxnet_tpu.models import GPT2ForCausalLM as JaxGPT2  # noqa: E402
from mxnet_tpu.models import KVCache as JaxKV  # noqa: E402
from mxnet_tpu.models import PagedKVCache as JaxPaged  # noqa: E402
from mxnet_tpu_torch import MXNetError  # noqa: E402
from mxnet_tpu_torch.models import (GPT2Config, GPT2ForCausalLM,  # noqa: E402
                                    KVCache, PagedKVCache, load_jax_params)

KW = dict(vocab_size=97, units=32, num_layers=2, num_heads=2,
          max_length=64, dropout=0.0, attention_dropout=0.0)
L, B, H, D = 2, 3, 2, 8


@pytest.fixture(scope="module")
def pair():
    """(JAX net, the port net with its parameters)."""
    jnet = JaxGPT2(JaxConfig(**KW))
    mx.rng.seed(3)
    jnet.initialize(mx.init.Normal(0.05))
    arrays = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    net = load_jax_params(GPT2ForCausalLM(GPT2Config(**KW), device="cpu"),
                          arrays)
    return jnet, net


def _prompts(seed=0, b=3, t=6):
    return np.random.default_rng(seed).integers(
        0, KW["vocab_size"], (b, t)).astype(np.int32)


def _kv(rng, t):
    return [rng.standard_normal((B, H, t, D)).astype(np.float32)
            for _ in range(2)]


# ---------------------------------------------------------------------------
# the caches
# ---------------------------------------------------------------------------

def test_kv_cache_matches_jax():
    rng = np.random.default_rng(0)
    T = 16
    jc = JaxKV.create(L, B, H, T, D)
    pc = KVCache.create(L, B, H, T, D, device="cpu")
    assert pc.max_length == T and not pc.ragged and int(pc.length) == 0
    for layer, t in ((0, 5), (1, 5), (0, 1), (1, 1), (0, 1)):
        k, v = _kv(rng, t)
        write = "write_prompt" if t > 1 else "write"
        jk, jv, jc = getattr(jc, write)(layer, jnp.asarray(k),
                                        jnp.asarray(v))
        pk, pv, pc2 = getattr(pc, write)(layer, torch.from_numpy(k),
                                         torch.from_numpy(v))
        assert pc2 is pc and pk.shape == (B, H, T, D)
        np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
        if layer == 1:
            jc, pc = jc.advance(t), pc.advance(t)
        np.testing.assert_array_equal(pc.key_mask(extra=1).numpy(),
                                      np.asarray(jc.key_mask(extra=1)))
    np.testing.assert_array_equal(pc.k.numpy(), np.asarray(jc.k))
    np.testing.assert_array_equal(pc.v.numpy(), np.asarray(jc.v))
    assert int(pc.length) == int(jc.length) == 6
    # beam search's reorder by parent: new buffers, rows permuted
    rows = torch.tensor([2, 2, 0])
    re = pc.reorder(rows)
    assert torch.equal(re.k, pc.k[:, rows]) and re.length is pc.length
    assert re.k.data_ptr() != pc.k.data_ptr()


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_lockstep_paged_cache_matches_jax(kv_dtype):
    """A scalar-length PagedKVCache over a permuted page table: a prompt
    that ends mid-page, then decode writes across a page boundary. Views
    equal the reference's (int8 pools dequantized to float32 with the
    current page scales), pools and scales are the same bytes."""
    rng = np.random.default_rng(1)
    S, T = 4, 16
    P = T // S
    N = B * P + 2
    table = rng.permutation(N)[:B * P].reshape(B, P).astype(np.int32)
    jc = JaxPaged.create(L, B, H, T, D, page_size=S, num_pages=N,
                         page_table=jnp.asarray(table), kv_dtype=kv_dtype)
    pc = PagedKVCache.create(L, B, H, T, D, page_size=S, num_pages=N,
                             page_table=table, kv_dtype=kv_dtype,
                             device="cpu")
    assert not pc.ragged and pc.length.dim() == 0 and pc.max_length == T
    for layer, t in ((0, 6), (1, 6), (0, 1), (1, 1), (0, 1), (1, 1),
                     (0, 1)):
        k, v = _kv(rng, t)
        write = "write_prompt" if t > 1 else "write"
        jk, jv, jc = getattr(jc, write)(layer, jnp.asarray(k),
                                        jnp.asarray(v))
        pk, pv, pc2 = getattr(pc, write)(layer, torch.from_numpy(k),
                                         torch.from_numpy(v))
        assert pc2 is pc and pk.shape == (B, H, T, D)
        if kv_dtype is None:
            np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
            np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
        else:
            assert pk.dtype == torch.float32
            np.testing.assert_allclose(pk.numpy(), np.asarray(jk),
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(pv.numpy(), np.asarray(jv),
                                       rtol=1e-6, atol=1e-6)
        if layer == 1:
            jc, pc = jc.advance(t), pc.advance(t)
        np.testing.assert_array_equal(pc.key_mask().numpy(),
                                      np.asarray(jc.key_mask()))
    assert int(pc.length) == int(jc.length) == 8
    # the port's pools carry the trash page after the N real ones
    np.testing.assert_array_equal(pc.k_pages[:, :N].numpy(),
                                  np.asarray(jc.k_pages))
    np.testing.assert_array_equal(pc.v_pages[:, :N].numpy(),
                                  np.asarray(jc.v_pages))
    if kv_dtype is not None:
        np.testing.assert_array_equal(pc.k_scale[:, :N].numpy(),
                                      np.asarray(jc.k_scale))
        np.testing.assert_array_equal(pc.v_scale[:, :N].numpy(),
                                      np.asarray(jc.v_scale))
    with pytest.raises(MXNetError, match="lockstep"):
        PagedKVCache.create(L, B, H, T, D, page_size=S, lengths=[0] * B,
                            device="cpu").write_prompt(
            0, torch.zeros(B, H, 2, D), torch.zeros(B, H, 2, D))


def test_make_cache_kinds(pair):
    _, net = pair
    c = net.make_cache(2, 32)
    assert isinstance(c, KVCache) and c.k.shape == (2, 2, 2, 32, 16)
    p = net.make_cache(2, 32, paged=True, page_size=8)
    assert isinstance(p, PagedKVCache) and not p.ragged
    r = net.make_cache(2, 32, paged=True, page_size=8, lengths=[0, 3])
    assert r.ragged
    with pytest.raises(MXNetError, match="paged"):
        net.make_cache(2, 32, kv_dtype="int8")


@pytest.mark.parametrize("paged", [False, True])
def test_lockstep_forward_logits_match_jax(pair, paged):
    """A prompt forward (the plain softmax attention under the (1, 1, t,
    T_max) mask) and two one-token forwards (the fused attention's plain
    version in BHTD, key padding (1, 1, 1, T_max)) over each cache kind."""
    jnet, net = pair
    ids = _prompts(5)
    jc = jnet.make_cache(B, 32, paged=paged, page_size=8)
    pc = net.make_cache(B, 32, paged=paged, page_size=8)
    toks = [ids] + [_prompts(6 + i, t=1) for i in range(2)]
    for tk in toks:
        jl, jc = jnet(mx.nd.array(tk, dtype="int32"), jc)
        with torch.no_grad():
            pl, pc = net(torch.from_numpy(tk), pc)
        np.testing.assert_allclose(pl.numpy(), jl.asnumpy(), rtol=1e-5,
                                   atol=1e-5)
    assert int(pc.length) == int(jc.length) == 8


# ---------------------------------------------------------------------------
# generate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("eos", [None, "stream"])
def test_generate_greedy_matches_jax(pair, paged, eos):
    """Greedy tokens equal the reference's; with eos set to a token the
    first row emits at step 1, that row emits it and pads with it."""
    jnet, net = pair
    ids = _prompts()
    n = 12
    if eos == "stream":
        eos = int(net.generate(torch.from_numpy(ids), 2)[0, 1])
    want = jnet.generate(mx.nd.array(ids, dtype="int32"), n,
                         eos_token_id=eos, paged=paged,
                         page_size=8).asnumpy()
    got = net.generate(torch.from_numpy(ids), n, eos_token_id=eos,
                       paged=paged, page_size=8)
    assert got.dtype == torch.int32 and got.shape == (3, n)
    np.testing.assert_array_equal(got.numpy(), want)
    if eos is not None:
        assert (got[0, 1:] == eos).all()


def _counting(net):
    calls = []
    handle = net.register_forward_hook(lambda m, a, o: calls.append(1))
    return calls, handle


@pytest.mark.parametrize("paged", [False, True])
def test_generate_early_exit(pair, paged):
    """Once every row has emitted eos the loop stops: two rows that emit
    eos at step 1 take the prefill and two single-token forwards."""
    jnet, net = pair
    ids = np.repeat(_prompts(b=1), 2, axis=0)
    eos = int(net.generate(torch.from_numpy(ids), 2)[0, 1])
    calls, handle = _counting(net)
    try:
        got = net.generate(torch.from_numpy(ids), 20, eos_token_id=eos,
                           paged=paged, page_size=8)
    finally:
        handle.remove()
    assert len(calls) == 3
    want = jnet.generate(mx.nd.array(ids, dtype="int32"), 20,
                         eos_token_id=eos, paged=paged,
                         page_size=8).asnumpy()
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[:, 1:] == eos).all()


def test_generate_refuses(pair):
    _, net = pair
    ids = torch.zeros((1, 60), dtype=torch.int64)
    with pytest.raises(MXNetError, match="max_length"):
        net.generate(ids, 8)
    with pytest.raises(MXNetError, match="not ported"):
        net.generate(ids[:, :4], 4, mesh=object())


def _step_logits(net, ids, out):
    """The logits each generated token was drawn from: the cache=None
    forward over prompt + tokens, at the position before each token."""
    full = torch.cat([ids.long(), out.long()], dim=1)
    with torch.no_grad():
        logits = net(full)
    return logits[:, ids.shape[1] - 1:-1].float()


def test_generate_sampling_contract(pair):
    _, net = pair
    ids = torch.from_numpy(_prompts(7))
    n = 10
    greedy = net.generate(ids, n)
    kw = dict(do_sample=True, temperature=0.9)
    assert torch.equal(net.generate(ids, n, top_k=1, seed=3, **kw), greedy)
    a = net.generate(ids, n, top_k=5, seed=11, **kw)
    assert torch.equal(net.generate(ids, n, top_k=5, seed=11, **kw), a)
    # every sampled token lies in the top-5 set of its step's logits
    top = _step_logits(net, ids, a).topk(5, dim=-1).indices
    assert bool((top == a.long()[..., None]).any(-1).all())
    # top_p = 1.0 keeps the whole distribution: the same draws as no filter
    assert torch.equal(net.generate(ids, n, top_p=1.0, seed=4, **kw),
                       net.generate(ids, n, seed=4, **kw))
    # nucleus sampling keeps at least the top-1 token
    p = net.generate(ids, n, top_p=0.0, seed=4, **kw)
    assert torch.equal(p, greedy)
    # another seed draws other tokens over the full distribution
    b = net.generate(ids, n, seed=12, **kw)
    assert not torch.equal(b, net.generate(ids, n, seed=13, **kw))
    assert not torch.equal(b, greedy)
