"""The port's GPT-2 serving forward and paged KV cache against the JAX
package.

A tiny GPT-2 (the `_tiny` configuration of tests/test_serving.py) is
built and seeded in the JAX package; its parameters cross over as numpy
arrays (models/convert.load_jax_params). Both packages then run the same
ragged-cache forwards: mixed prefill chunks, decode rows and idle slots
in one (B, W) grid, a slot near capacity, and the single-token decode
forward. Logits agree at rtol/atol 1e-4 over live positions (float32,
sums in another order); the cache writes are byte-identical.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu.models import GPT2Config as JaxConfig  # noqa: E402
from mxnet_tpu.models import GPT2ForCausalLM as JaxGPT2  # noqa: E402
from mxnet_tpu.models import PagedKVCache as JaxCache  # noqa: E402
from mxnet_tpu.ops import nn as jax_nn  # noqa: E402
from mxnet_tpu_torch import MXNetError  # noqa: E402
from mxnet_tpu_torch.models import (GPT2Config, GPT2ForCausalLM,  # noqa: E402
                                    KVCache, PagedKVCache, gpt2_774m_config,
                                    init_params, load_jax_params)
from mxnet_tpu_torch.ops import nn as port_nn  # noqa: E402

KW = dict(vocab_size=97, units=32, num_layers=2, num_heads=2,
          max_length=64, dropout=0.0, attention_dropout=0.0)


@pytest.fixture(scope="module")
def pair():
    """(JAX net, its params as numpy, the port net with those params)."""
    jnet = JaxGPT2(JaxConfig(**KW))
    mx.rng.seed(3)
    jnet.initialize(mx.init.Normal(0.05))
    arrays = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    net = load_jax_params(GPT2ForCausalLM(GPT2Config(**KW), device="cpu"),
                          arrays)
    return jnet, arrays, net


def _pools(L=2, N=24, S=8, H=2, D=16, seed=0):
    rng = np.random.default_rng(seed)
    kp = rng.standard_normal((L, N, S, H, D)).astype(np.float32)
    vp = rng.standard_normal((L, N, S, H, D)).astype(np.float32)
    return kp, vp


def _with_trash(pool):
    """The port's pools carry one trash page after the N real ones."""
    z = np.zeros(pool.shape[:1] + (1,) + pool.shape[2:], pool.dtype)
    return torch.from_numpy(np.concatenate([pool, z], axis=1))


# ---------------------------------------------------------------------------
# PagedKVCache.write_decode
# ---------------------------------------------------------------------------

def test_write_decode_byte_identical_to_jax():
    """A random write schedule with writes past capacity, dead span rows
    and locked pages: both packages' pools stay byte-identical."""
    rng = np.random.default_rng(7)
    L, B, H, D, S, P = 2, 4, 2, 8, 4, 3
    N = B * P + 2
    kp, vp = _pools(L, N, S, H, D, seed=1)
    table = rng.permutation(N)[:B * P].reshape(B, P).astype(np.int32)
    jk, jv = jnp.asarray(kp), jnp.asarray(vp)
    pk, pv = _with_trash(kp), _with_trash(vp)
    for step in range(8):
        t = (1, 3)[step % 2]
        lengths = rng.integers(0, P * S + 3, B).astype(np.int32)
        spans = rng.integers(0, t + 1, B).astype(np.int32)
        lock = rng.random(N) < 0.25
        k = rng.standard_normal((B, H, t, D)).astype(np.float32)
        v = rng.standard_normal((B, H, t, D)).astype(np.float32)
        layer = step % L
        jc = JaxCache(jk, jv, jnp.asarray(table), jnp.asarray(lengths),
                      page_lock=jnp.asarray(lock), spans=jnp.asarray(spans))
        jc = jc.write_decode(layer, jnp.asarray(k), jnp.asarray(v))
        jk, jv = jc.k_pages, jc.v_pages
        pc = PagedKVCache(pk, pv, torch.from_numpy(table),
                          torch.from_numpy(lengths),
                          page_lock=torch.from_numpy(lock),
                          spans=torch.from_numpy(spans))
        assert pc.write_decode(layer, torch.from_numpy(k),
                               torch.from_numpy(v)) is pc
        np.testing.assert_array_equal(pk[:, :N].numpy(), np.asarray(jk))
        np.testing.assert_array_equal(pv[:, :N].numpy(), np.asarray(jv))
    assert not np.array_equal(np.asarray(jk), kp)   # writes did land


def test_write_decode_lands_at_per_slot_offsets():
    B, H, D, S = 3, 1, 2, 4
    cache = PagedKVCache.create(1, B, H, 12, D, page_size=S,
                                lengths=[0, 5, 9], device="cpu")
    val = torch.arange(1, B + 1, dtype=torch.float32).reshape(B, 1, 1, 1)
    val = val.expand(B, H, 1, D)
    cache.write_decode(0, val, 2 * val)
    pool = cache.k_pages[0]
    table = cache.page_table
    for b, length in enumerate([0, 5, 9]):
        page, slot = divmod(length, S)
        assert pool[table[b, page], slot, 0, 0] == b + 1.0
    assert int((pool != 0).sum()) == B * D           # nothing else


def test_write_decode_full_slot_drops_instead_of_clobbering():
    B, H, D, S = 2, 1, 2, 4
    cache = PagedKVCache.create(1, B, H, 8, D, page_size=S,
                                lengths=[8, 3], device="cpu")
    cache.k_pages.fill_(1.0)
    cache.k_pages[:, cache.num_pages].zero_()        # the trash page
    val = torch.full((B, H, 1, D), 7.0)
    cache.write_decode(0, val, val)
    pool, table = cache.k_pages[0], cache.page_table.long()
    assert bool((pool[table[0]] == 1.0).all())       # at capacity: dropped
    assert pool[table[1, 0], 3, 0, 0] == 7.0


def test_key_mask_and_geometry():
    cache = PagedKVCache.create(1, 2, 1, 8, 2, page_size=4, lengths=[2, 5],
                                device="cpu")
    assert cache.ragged and cache.page_size == 4 and cache.max_length == 8
    assert cache.num_pages == 4 and cache.k_pages.shape[1] == 5
    m = cache.key_mask(extra=1).numpy()
    np.testing.assert_array_equal(m[0], [1, 1, 1, 0, 0, 0, 0, 0])
    np.testing.assert_array_equal(m[1], [1, 1, 1, 1, 1, 1, 0, 0])
    assert cache.advance(3).length.tolist() == [5, 8]


def test_cache_create_refuses_bad_geometry_and_unported_modes():
    with pytest.raises(MXNetError):
        PagedKVCache.create(1, 2, 1, 10, 2, page_size=4, lengths=[0, 0],
                            device="cpu")
    with pytest.raises(MXNetError):
        PagedKVCache.create(1, 2, 1, 8, 2, page_size=4, lengths=[0, 0],
                            page_table=[[0, 1], [2, 9]], device="cpu")
    # the lockstep (scalar length) cache is ported
    # (tests/test_torch_generate.py)
    lockstep = PagedKVCache.create(1, 2, 1, 8, 2, page_size=4, device="cpu")
    assert not lockstep.ragged and lockstep.length.shape == ()
    assert lockstep.key_mask(extra=1).tolist() == [True] + [False] * 7
    # int8 pages are ported (tests/test_torch_quant_kv.py); any other
    # kv_dtype is refused, as by the reference
    with pytest.raises(MXNetError, match="kv_dtype"):
        PagedKVCache.create(1, 2, 1, 8, 2, page_size=4, lengths=[0, 0],
                            kv_dtype="bfloat16", device="cpu")
    with pytest.raises(MXNetError):
        PagedKVCache.create(1, 2, 1, 8, 2, page_size=4, lengths=[0, 0],
                            attn_impl="xla", device="cpu")


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def test_parameter_names_and_shapes_match_jax(pair):
    jnet, arrays, net = pair
    port = {n: tuple(p.shape) for n, p in net.named_parameters()}
    assert port == {n: a.shape for n, a in arrays.items()}
    # the LM head is tied: no parameter of its own
    assert not any("head" in n for n in port)


def test_load_jax_params_refuses_missing_extra_and_misshaped(pair):
    _, arrays, _ = pair
    net = GPT2ForCausalLM(GPT2Config(**KW), device="cpu")
    bad = dict(arrays)
    bad.pop("backbone.ln_f.beta")
    with pytest.raises(MXNetError, match="missing"):
        load_jax_params(net, bad)
    with pytest.raises(MXNetError, match="unexpected"):
        load_jax_params(net, dict(arrays, **{"backbone.lm_head": arrays[
            "backbone.ln_f.beta"]}))
    bad = dict(arrays)
    bad["backbone.layer0.fc1.weight"] = bad["backbone.layer0.fc1.weight"].T
    with pytest.raises(MXNetError, match="shape"):
        load_jax_params(net, bad)


def test_init_params_seeded_and_structured():
    a = GPT2ForCausalLM(GPT2Config(**KW), device="cpu")
    b = init_params(GPT2ForCausalLM(GPT2Config(**KW), device="cpu"), seed=0)
    c = init_params(GPT2ForCausalLM(GPT2Config(**KW), device="cpu"), seed=1)
    pa_, pb, pc = (dict(m.named_parameters()) for m in (a, b, c))
    for n in pa_:
        assert torch.equal(pa_[n], pb[n])
    w = "backbone.layer0.attn.query.weight"
    assert not torch.equal(pb[w], pc[w])
    assert abs(float(pb[w].std()) - 0.02) < 0.005
    assert bool((pb["backbone.ln_f.gamma"] == 1).all())
    assert bool((pb["backbone.layer1.fc2.bias"] == 0).all())


def test_774m_config_widths():
    c = gpt2_774m_config()
    assert (c.num_layers, c.units, c.num_heads, c.vocab_size,
            c.max_length) == (36, 1280, 20, 50257, 1024)


# ---------------------------------------------------------------------------
# ops on the path
# ---------------------------------------------------------------------------

def test_ops_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    w = rng.standard_normal((7, 16)).astype(np.float32)
    b = rng.standard_normal(7).astype(np.float32)
    g = rng.standard_normal(16).astype(np.float32)
    be = rng.standard_normal(16).astype(np.float32)
    tx = torch.from_numpy(x)
    np.testing.assert_allclose(
        port_nn.fully_connected(tx, torch.from_numpy(w),
                                torch.from_numpy(b)).numpy(),
        np.asarray(jax_nn.FullyConnected(jnp.asarray(x), jnp.asarray(w),
                                         jnp.asarray(b), flatten=False)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        port_nn.layer_norm(tx, torch.from_numpy(g),
                           torch.from_numpy(be)).numpy(),
        np.asarray(jax_nn.LayerNorm(jnp.asarray(x), jnp.asarray(g),
                                    jnp.asarray(be))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        port_nn.activation(tx, "gelu_tanh").numpy(),
        np.asarray(jax_nn._act(jnp.asarray(x), "gelu_tanh")),
        rtol=1e-6, atol=1e-6)
    with pytest.raises(MXNetError):
        port_nn.activation(tx, "nope")


def test_layer_norm_bf16_rounds_before_affine():
    """bf16 LayerNorm: normalise in f32, round to bf16, THEN the affine
    step in bf16, as the JAX op does."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    xb, gb, bb = x.bfloat16(), g.bfloat16(), b.bfloat16()
    got = port_nn.layer_norm(xb, gb, bb)
    x32 = xb.float()
    y = ((x32 - x32.mean(-1, keepdim=True))
         * torch.rsqrt(x32.var(-1, unbiased=False, keepdim=True) + 1e-5))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, y.bfloat16() * gb + bb)
    ref = jax_nn.LayerNorm(jnp.asarray(x.numpy(), jnp.bfloat16),
                           jnp.asarray(g.numpy(), jnp.bfloat16),
                           jnp.asarray(b.numpy(), jnp.bfloat16))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), rtol=2e-2,
                               atol=2e-2)


# ---------------------------------------------------------------------------
# the ragged forward against the JAX model
# ---------------------------------------------------------------------------

def _forward_both(jnet, net, state, tokens, lengths, spans):
    """One ragged forward in each package over their own pools; returns
    both logits as numpy. state = [jax k, jax v, port k, port v, table]."""
    jk, jv, pk, pv, table = state
    jc = JaxCache(jk, jv, jnp.asarray(table), jnp.asarray(lengths),
                  spans=None if spans is None else jnp.asarray(spans),
                  attn_impl="xla")
    jl, jc = jnet(mx.nd.array(tokens, dtype="int32"), jc)
    state[0], state[1] = jc.k_pages, jc.v_pages
    pc = PagedKVCache(pk, pv, torch.from_numpy(table),
                      torch.from_numpy(lengths),
                      spans=None if spans is None else torch.from_numpy(spans))
    with torch.no_grad():
        pl, pc2 = net(torch.from_numpy(tokens), pc)
    assert pc2.length.tolist() == (lengths + tokens.shape[1]).tolist()
    return jl.asnumpy(), pl.numpy()


def _live_close(jl, pl, spans):
    for b, n in enumerate(spans):
        np.testing.assert_allclose(pl[b, :n], jl[b, :n], rtol=1e-4,
                                   atol=1e-4, err_msg=f"slot {b}")


def test_ragged_forward_matches_jax_over_mixed_spans(pair):
    jnet, _, net = pair
    rng = np.random.default_rng(11)
    B, S, P, W = 3, 8, 8, 6
    N = B * P
    table = rng.permutation(N).reshape(B, P).astype(np.int32)
    z = np.zeros((2, N, S, 2, 16), np.float32)
    state = [jnp.asarray(z), jnp.asarray(z), _with_trash(z), _with_trash(z),
             table]
    lengths = np.zeros(B, np.int32)
    # prefill chunks, a decode row and an idle slot in each (B, W) grid
    for spans in ([6, 3, 0], [6, 1, 4], [2, 0, 6]):
        spans = np.int32(spans)
        toks = rng.integers(0, KW["vocab_size"], (B, W)).astype(np.int32)
        jl, pl = _forward_both(jnet, net, state, toks, lengths, spans)
        _live_close(jl, pl, spans)
        lengths = lengths + spans
    np.testing.assert_allclose(state[2][:, :N].numpy(), np.asarray(state[0]),
                               rtol=1e-5, atol=1e-5)
    # the single-token ragged decode forward (the decode kernel's path)
    toks = rng.integers(0, KW["vocab_size"], (B, 1)).astype(np.int32)
    jl, pl = _forward_both(jnet, net, state, toks, lengths, None)
    np.testing.assert_allclose(pl, jl, rtol=1e-4, atol=1e-4)


def test_slot_near_capacity_clamps_dead_positions(pair):
    """Dead rows of a slot near capacity run past the position table (the
    JAX package reads NaN there); the port clamps them, and the live rows
    still match."""
    jnet, _, net = pair
    rng = np.random.default_rng(12)
    B, S, P, W = 3, 8, 8, 6
    N = B * P
    table = rng.permutation(N).reshape(B, P).astype(np.int32)
    kp, vp = _pools(N=N, seed=2)
    state = [jnp.asarray(kp), jnp.asarray(vp), _with_trash(kp),
             _with_trash(vp), table]
    lengths = np.int32([60, 10, 64])          # slot 2 parked at capacity
    spans = np.int32([4, 6, 0])
    toks = rng.integers(0, KW["vocab_size"], (B, W)).astype(np.int32)
    jl, pl = _forward_both(jnet, net, state, toks, lengths, spans)
    _live_close(jl, pl, spans)
    assert np.isfinite(pl).all()
    np.testing.assert_allclose(state[2][:, :N].numpy(), np.asarray(state[0]),
                               rtol=1e-5, atol=1e-5)


def test_unported_paths_raise(pair):
    """The lockstep paths once refused here (make_cache(paged=False),
    generate, the lockstep forward and the lockstep writes) are ported:
    each call now works (their oracles: tests/test_torch_generate.py).
    generate over a device mesh still raises."""
    _, _, net = pair
    ids = torch.zeros((1, 3), dtype=torch.int64)
    assert isinstance(net.make_cache(1, 64, paged=False), KVCache)
    out = net.generate(ids, 4)
    assert out.shape == (1, 4) and out.dtype == torch.int32
    with pytest.raises(MXNetError, match="not ported"):
        net.generate(ids, 4, mesh=object())
    lockstep = PagedKVCache(torch.zeros(2, 9, 8, 2, 16),
                            torch.zeros(2, 9, 8, 2, 16),
                            torch.arange(8, dtype=torch.int32)[None],
                            torch.zeros((), dtype=torch.int32))
    with torch.no_grad():
        logits, cache = net(ids, lockstep)
    assert logits.shape == (1, 3, KW["vocab_size"])
    assert int(cache.length) == 3
    kv = torch.ones(1, 2, 1, 16)
    k_all, _, _ = cache.write(0, kv, kv)
    assert k_all.shape == (1, 2, 64, 16) and bool((k_all[:, :, 3] == 1).all())
    k_all, _, _ = cache.write_prompt(1, 2 * kv, 2 * kv)
    assert bool((k_all[:, :, 3] == 2).all())
    assert KVCache.create(2, 1, 2, 64, 16, device="cpu").k.shape == \
        (2, 1, 2, 64, 16)
