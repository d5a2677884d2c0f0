"""The port's w8 weight serving against the JAX package.

The quantizer is held to the reference byte for byte (codes and scales
of column- and row-parallel weights), the w8 product to the reference's
`_w8_dequant_matmul` within 1e-5 relative in float32, and the engine two
ways: its greedy streams equal the JAX w8 engine's, and greedy and
seeded sampled streams equal those of a float engine whose weights are
the dequantized codes (the port's w8 oracle: w8 changes nothing but the
order of the product's sums against that model). Byte-denominated pool
sizing with the weights charged gives the JAX engine's page counts.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu.models import GPT2Config as JaxConfig  # noqa: E402
from mxnet_tpu.models import GPT2ForCausalLM as JaxGPT2  # noqa: E402
from mxnet_tpu.ops import nn as jax_nn  # noqa: E402
from mxnet_tpu.serving import Request as JaxRequest  # noqa: E402
from mxnet_tpu.serving import ServingEngine as JaxEngine  # noqa: E402
from mxnet_tpu.serving import weight_quant as jax_wq  # noqa: E402
from mxnet_tpu_torch import MXNetError  # noqa: E402
from mxnet_tpu_torch.models import (GPT2Config, GPT2ForCausalLM,  # noqa: E402
                                    load_jax_params)
from mxnet_tpu_torch.nn import Dense  # noqa: E402
from mxnet_tpu_torch.ops import nn as port_nn  # noqa: E402
from mxnet_tpu_torch.serving import (Request, ServingEngine,  # noqa: E402
                                     build_weight_plan, dequantize,
                                     pick_out_tile, quantize_weight)

KW = dict(vocab_size=97, units=32, num_layers=2, num_heads=4,
          max_length=64, dropout=0.0, attention_dropout=0.0)
ENGINE = dict(num_slots=3, max_length=64, page_size=8, chunk_tokens=8)


@pytest.fixture(scope="module")
def jax_model():
    jnet = JaxGPT2(JaxConfig(**KW))
    mx.rng.seed(3)
    jnet.initialize(mx.init.Normal(0.05))
    arrays = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    return jnet, arrays


def _port_net(arrays, plan=None):
    """A port model with `arrays`' weights; with a w8 `plan`, each
    quantized weight replaced by its dequantized codes (the oracle)."""
    arrays = dict(arrays)
    for q in plan or ():
        arrays[q.name] = dequantize(q)
    return load_jax_params(GPT2ForCausalLM(GPT2Config(**KW), device="cpu"),
                           arrays)


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(11)
    return [rng.integers(0, KW["vocab_size"], int(n)).tolist()
            for n in rng.integers(3, 20, 6)]


def _serve(eng, prompts, request_cls, sampled=False):
    skw = dict(do_sample=True, temperature=0.8, top_k=20,
               top_p=0.95) if sampled else {}
    reqs = [request_cls(p, 10, request_id=i, seed=100 + i, **skw)
            for i, p in enumerate(prompts)]
    eng.serve(reqs)
    return [r.output_tokens for r in reqs]


# ---------------------------------------------------------------------------
# the quantizer and the product
# ---------------------------------------------------------------------------

def test_pick_out_tile_equals_jax():
    for n in list(range(1, 300, 7)) + [1280, 3840, 5120, 50257]:
        for cap in (1, 16, 128):
            assert pick_out_tile(n, cap) == jax_wq.pick_out_tile(n, cap)
    assert pick_out_tile(1280 // 20) == 64 and pick_out_tile(97) == 97


@pytest.mark.parametrize("kind,shape,max_shards", [
    ("col", (96, 32), 4), ("col", (256, 40), 2), ("col", (128, 32), 4),
    ("row", (32, 128), None), ("row", (300, 7), None)])
def test_codes_and_scales_equal_jax(kind, shape, max_shards):
    rng = np.random.default_rng(sum(shape))
    w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    w[0, :] *= 40.0                           # one tile with a large range
    codes, scale, tile = quantize_weight(torch.from_numpy(w), kind,
                                         max_shards=max_shards)
    jc, js, jt, _ = jax_wq.quantize_weight(w, kind, max_shards=max_shards)
    assert tile == jt
    assert codes.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(js))
    assert (codes.abs() <= 127).all()
    with pytest.raises(MXNetError):
        quantize_weight(torch.zeros(3, 4, 5), kind)


def test_w8_fully_connected_matches_jax_dequant_matmul():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 5, 40)).astype(np.float32)
    w = (rng.standard_normal((96, 40)) * 0.1).astype(np.float32)
    b = rng.standard_normal(96).astype(np.float32)
    codes, scale, _ = quantize_weight(torch.from_numpy(w), "col",
                                      max_shards=4)
    jc, js = jnp.asarray(codes.numpy()), jnp.asarray(scale.numpy())
    jax_nn.register_w8_weight(jc, js)
    try:
        want = np.asarray(jax_nn._w8_dequant_matmul(jnp.asarray(x), jc)) + b
    finally:
        jax_nn.deregister_w8_weight(jc)
    got = port_nn.fully_connected(torch.from_numpy(x), codes,
                                  torch.from_numpy(b), scale=scale).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    # the Dense layer holds the codes and scales in place of its weight
    dense = Dense(40, 96, device="cpu")
    with torch.no_grad():
        dense.bias.copy_(torch.from_numpy(b))
    dense.quantize_(codes, scale)
    assert dense.weight is None and "weight" not in dict(
        dense.named_parameters())
    assert {n for n, _ in dense.named_buffers()} == {"codes", "scale"}
    assert torch.equal(dense(torch.from_numpy(x)),
                       torch.from_numpy(got))
    with pytest.raises(MXNetError, match="w8 scales"):
        port_nn.fully_connected(torch.from_numpy(x), codes)


def test_model_logits_match_the_dequantized_model(jax_model):
    """A w8 model's logits against a float model with the dequantized
    weights: within 1e-5 relative in float32."""
    _, arrays = jax_model
    net = _port_net(arrays)
    plan = build_weight_plan(net.named_parameters(), max_shards=4)
    assert [q.name.rsplit(".", 2)[-2] for q in plan[:6]] == [
        "query", "key", "value", "proj", "fc1", "fc2"]
    assert [q.kind for q in plan[:6]] == ["col"] * 3 + ["row", "col", "row"]
    for q in plan:
        net.get_submodule(q.name.rsplit(".", 1)[0]).quantize_(q.codes,
                                                              q.scale)
    oracle = _port_net(arrays, plan)
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, KW["vocab_size"], (2, 12)))
    with torch.no_grad():
        got, want = net(ids), oracle(ids)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def test_engine_w8_greedy_equals_jax_and_the_dequantized_engine(jax_model,
                                                                prompts):
    jnet, arrays = jax_model
    jeng = JaxEngine(jnet, attn_impl="xla", weight_dtype="int8", **ENGINE)
    want = _serve(jeng, prompts, JaxRequest)
    eng = ServingEngine(_port_net(arrays), device="cpu", weight_dtype="int8",
                        **ENGINE)
    got = _serve(eng, prompts, Request)
    assert got == want
    assert eng.weight_dtype == "int8" and len(eng._w8_plan) == 12
    for q, jq in zip(eng._w8_plan, jeng._w8_plan):
        assert q.name == jq.name and q.tile == jq.tile
        np.testing.assert_array_equal(q.codes.numpy(), np.asarray(jq.codes))
        np.testing.assert_array_equal(q.scale.numpy(), np.asarray(jq.scale))
    for key in ("weight_bytes_int8", "weight_bytes_float32"):
        assert eng.stats[key] == jeng.stats[key], key
    oracle = ServingEngine(_port_net(arrays, eng._w8_plan), device="cpu",
                           **ENGINE)
    assert _serve(oracle, prompts, Request) == got


def test_engine_w8_sampled_equals_the_dequantized_engine(jax_model,
                                                         prompts):
    _, arrays = jax_model
    eng = ServingEngine(_port_net(arrays), device="cpu", weight_dtype="int8",
                        **ENGINE)
    got = _serve(eng, prompts, Request, sampled=True)
    oracle = ServingEngine(_port_net(arrays, eng._w8_plan), device="cpu",
                           **ENGINE)
    assert _serve(oracle, prompts, Request, sampled=True) == got


@pytest.mark.parametrize("w8", [False, True])
@pytest.mark.parametrize("pages", [20, 40])
def test_engine_hbm_budget_includes_weights_equals_jax(jax_model, w8,
                                                       pages):
    """One budget of the float32 weights + `pages` pages: the same page
    count as the JAX engine, and w8's smaller weights buy more pages."""
    jnet, arrays = jax_model
    wkw = dict(weight_dtype="int8") if w8 else {}
    probe = ServingEngine(_port_net(arrays), device="cpu", **ENGINE)
    budget = sum(probe.weight_bytes.values()) \
        + pages * probe.page_pool.page_bytes
    kw = dict(ENGINE, hbm_budget_bytes=budget,
              hbm_budget_includes_weights=True, **wkw)
    port = ServingEngine(_port_net(arrays), device="cpu", **kw)
    ref = JaxEngine(jnet, attn_impl="xla", **kw)
    assert port.page_pool.num_pages == ref.page_pool.num_pages
    # the slots want 3 x 8 pages; w8 frees about 18 pages' bytes here
    assert port.page_pool.num_pages == min(24, pages if not w8 else 10 ** 6)
    assert port.weight_bytes["int8"] == (2 * (4 * 32 * 32 + 2 * 32 * 128)
                                         if w8 else 0)
    with pytest.raises(MXNetError, match="weights alone"):
        ServingEngine(_port_net(arrays), device="cpu",
                      hbm_budget_bytes=1000,
                      hbm_budget_includes_weights=True, **ENGINE)


@pytest.mark.parametrize("bad", ["float16", "bfloat16", "int4", 8])
def test_engine_rejects_other_weight_dtypes(jax_model, bad):
    _, arrays = jax_model
    with pytest.raises(MXNetError, match="weight_dtype"):
        ServingEngine(_port_net(arrays), device="cpu", weight_dtype=bad,
                      **ENGINE)
