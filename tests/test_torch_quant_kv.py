"""The port's int8 KV pages against the JAX package.

Three layers, each held to the JAX package on the same numpy inputs:

  * the int8 span attention's plain version (what a CPU tensor takes;
    the CUDA kernel is held to it on the card by chip_smoke.py) against
    the JAX dense reference `_ragged_span_reference(k_scale=, v_scale=)`
    and the Pallas `_ragged_span_quant_kernel` in interpret mode:
    float32 at 2e-5 (sums in another order), bfloat16 q at 1.2e-2 of the
    largest value (one bf16 rounding of q and of the output);
  * the cache quantizer: codes and scales BYTE-identical to the JAX
    int8 PagedKVCache after the same write schedule (dead rows, locked
    pages, writes past capacity, several rows of one page per chunk),
    codes independent of chunking, scales monotone;
  * the engine: greedy streams equal to the JAX int8 engine at
    chunk_tokens 4 and 8 (a divergence is accepted only where the JAX
    int8 top-2 logit gap at that token is below 1e-4), int8 against
    float32 where float32's margin is decisive, byte-denominated pool
    sizing equal to the JAX engine's, and admission backpressure.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu.models import GPT2Config as JaxConfig  # noqa: E402
from mxnet_tpu.models import GPT2ForCausalLM as JaxGPT2  # noqa: E402
from mxnet_tpu.models import PagedKVCache as JaxCache  # noqa: E402
from mxnet_tpu.ops import pallas_attention as pa  # noqa: E402
from mxnet_tpu.serving import Request as JaxRequest  # noqa: E402
from mxnet_tpu.serving import ServingEngine as JaxEngine  # noqa: E402
from mxnet_tpu_torch import MXNetError  # noqa: E402
from mxnet_tpu_torch.models import (GPT2Config, GPT2ForCausalLM,  # noqa: E402
                                    PagedKVCache, load_jax_params)
from mxnet_tpu_torch.ops import ragged_attention as ra  # noqa: E402
from mxnet_tpu_torch.serving import Request, ServingEngine  # noqa: E402

SCALE = 1.0 / np.sqrt(16)
BF16_REL_TOL = 1.2e-2
KW = dict(vocab_size=97, units=32, num_layers=2, num_heads=2,
          max_length=64, dropout=0.0, attention_dropout=0.0)
ENGINE = dict(num_slots=3, max_length=64, page_size=8)
# tests/test_torch_serving.py's traffic: (prompt length, max_new_tokens)
TRAFFIC = [(3, 12), (9, 10), (17, 12), (5, 8), (40, 30), (1, 9), (26, 11)]


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


# ---------------------------------------------------------------------------
# the int8 span attention
# ---------------------------------------------------------------------------

def _quant_pool(B=5, H=2, D=16, S=8, P=4, Sq=8, seed=0):
    """tests/test_quant_kv.py::_quant_pool as numpy: int8 codes of
    gaussian slabs with per-(page, head) absmax/127 scales."""
    rng = np.random.default_rng(seed)
    N = B * P
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((N, S, H, D))
    v = rng.standard_normal((N, S, H, D))
    ks = (np.abs(k).max(axis=(1, 3)) / 127.0).astype(np.float32)
    vs = (np.abs(v).max(axis=(1, 3)) / 127.0).astype(np.float32)
    kq = np.clip(np.round(k / ks[:, None, :, None]), -127, 127).astype(
        np.int8)
    vq = np.clip(np.round(v / vs[:, None, :, None]), -127, 127).astype(
        np.int8)
    table = rng.permutation(N).reshape(B, P).astype(np.int32)
    return q, kq, vq, table, ks, vs


def _span_int8_all(pool, L, qc, qdtype):
    """The port's plain version, the JAX reference and the JAX Pallas
    quant kernel (interpret mode) on the same inputs; q in `qdtype` on
    both sides."""
    q, kq, vq, table, ks, vs = pool
    port = ra.ragged_span_attention(
        _t(q, qdtype), _t(kq), _t(vq), _t(table), _t(np.int32(L)),
        q_counts=None if qc is None else _t(np.int32(qc)),
        k_scale=_t(ks), v_scale=_t(vs))
    assert port.dtype == qdtype
    jdt = jnp.float32 if qdtype == torch.float32 else jnp.bfloat16
    jq = jnp.asarray(q, jdt)
    jargs = (jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(table),
             jnp.asarray(np.int32(L)))
    jqc = jnp.full((len(L),), q.shape[1], jnp.int32) if qc is None \
        else jnp.asarray(np.int32(qc))
    ref = pa._ragged_span_reference(jq, *jargs, jqc, SCALE,
                                    k_scale=jnp.asarray(ks),
                                    v_scale=jnp.asarray(vs))
    kern = pa.ragged_span_attention(jq, *jargs, q_counts=jqc,
                                    interpret=True, k_scale=jnp.asarray(ks),
                                    v_scale=jnp.asarray(vs))
    return (port.float().numpy(), np.asarray(ref, np.float32),
            np.asarray(kern, np.float32))


@pytest.mark.parametrize("case", ["mixed_f32", "mixed_bf16", "sq1_f32"])
def test_int8_span_plain_matches_jax_reference_and_kernel(case):
    """decode (1), verify (4), full chunk (8), idle (0) and a ragged
    tail (5) in one call, a bfloat16 q over the same int8 pages, and
    Sq = 1 (int8 decode rides the span kernel)."""
    if case == "sq1_f32":
        pool = _quant_pool(Sq=1, seed=2)
        L, qc, dtype = [4, 11, 27, 2, 19], None, torch.float32
    else:
        pool = _quant_pool(seed=0 if case == "mixed_f32" else 1)
        L, qc = [9, 17, 1, 30, 12], [1, 4, 8, 0, 5]
        dtype = torch.float32 if case == "mixed_f32" else torch.bfloat16
    port, ref, kern = _span_int8_all(pool, L, qc, dtype)
    for other in (ref, kern):
        if dtype == torch.float32:
            np.testing.assert_allclose(port, other, rtol=2e-5, atol=2e-5)
        else:
            err = np.abs(port - other).max() / np.abs(other).max()
            assert err <= BF16_REL_TOL, err
    if qc is not None:
        dead = np.arange(8)[None, :] >= np.asarray(qc)[:, None]
        assert (port[dead] == 0).all()


def test_int8_span_scales_are_read_by_physical_page():
    """Doubling one physical page's scale doubles exactly the values
    the plain version reads from it: the lookup goes through the table,
    and a scale leaf with a spare row (the cache's trash page) is
    accepted."""
    q, kq, vq, table, ks, vs = _quant_pool(B=1, P=2, seed=5)
    L, qc = np.int32([16]), np.int32([1])
    args = (_t(q[:, :1]), _t(kq), _t(vq), _t(table), _t(L))
    extra = np.zeros((1, ks.shape[1]), np.float32)
    base = ra.ragged_span_attention(
        *args, q_counts=_t(qc), k_scale=_t(np.concatenate([ks, extra])),
        v_scale=_t(np.concatenate([vs, extra])))
    vs2 = vs.copy()
    vs2[table[0]] *= 2.0                      # every page the slot reads
    doubled = ra.ragged_span_attention(*args, q_counts=_t(qc),
                                       k_scale=_t(ks), v_scale=_t(vs2))
    np.testing.assert_allclose(doubled.numpy(), 2 * base.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_int8_cpu_tensors_take_the_plain_version_and_count_no_launch():
    ra.reset_launches()
    q, kq, vq, table, ks, vs = _quant_pool()
    args = (_t(q), _t(kq), _t(vq), _t(table), _t(np.int32([1, 2, 3, 4, 5])))
    kw = dict(k_scale=_t(ks), v_scale=_t(vs))
    auto = ra.ragged_span_attention(*args, **kw)
    plain = ra.ragged_span_attention(*args, impl="torch", **kw)
    assert torch.equal(auto, plain)
    assert set(ra.LAUNCHES.values()) == {0}
    assert "ragged_span_attention_int8" in ra.LAUNCHES


def test_int8_scales_both_or_neither():
    q, kq, vq, table, ks, vs = _quant_pool()
    args = (_t(q), _t(kq), _t(vq), _t(table), _t(np.int32([1, 2, 3, 4, 5])))
    with pytest.raises(MXNetError, match="both"):
        ra.ragged_span_attention(*args, k_scale=_t(ks))
    with pytest.raises(MXNetError, match="int8"):
        ra.ragged_span_attention(*args)               # codes without scales
    fq = _t(np.float32(kq))
    with pytest.raises(MXNetError, match="int8"):
        ra.ragged_span_attention(args[0], fq, fq, *args[3:],
                                 k_scale=_t(ks), v_scale=_t(vs))


def test_ragged_supported_int8_pools():
    q, kq, vq, table, ks, vs = _quant_pool(H=2, D=64, S=64, P=1)
    qf, qb = _t(q), _t(q, torch.bfloat16)
    assert ra.ragged_supported(qf, _t(kq))
    assert ra.ragged_supported(qb, _t(kq), _t(vq))
    # int8 on one side only, or an int8 q, is refused
    assert not ra.ragged_supported(qf, _t(kq), _t(np.float32(vq)))
    assert not ra.ragged_supported(qf, _t(np.float32(kq)), _t(vq))
    assert not ra.ragged_supported(_t(q).to(torch.int8), _t(kq))
    # int8 pages are staged as codes, one byte an element: a page of
    # 512 keys at D = 128 overflows a block's shared memory even staged
    # once
    q3, kq3, *_ = _quant_pool(B=1, H=1, D=128, S=512, P=1, Sq=1)
    assert not ra.ragged_supported(_t(q3), _t(kq3))


@pytest.mark.parametrize("bad", ["scale_dtype", "scale_rows", "scale_heads",
                                 "float_pools", "scale_contiguous"])
def test_int8_kernel_argument_check_refuses(bad):
    """What the wrapper refuses before an int8 launch (the check is
    device-agnostic, so it runs here on CPU tensors)."""
    q, kq, vq, table, ks, vs = _quant_pool()
    q, kq, vq, ks, vs = _t(q), _t(kq), _t(vq), _t(ks), _t(vs)
    ints = {"page_table": _t(table), "lengths": _t(np.int32([1] * 5)),
            "q_counts": _t(np.int32([1] * 5))}
    ra._check_kernel_args("span", q, kq, vq, ints, (ks, vs))
    spare = torch.cat([ks, ks[:1]])                   # N + 1 rows: fine
    ra._check_kernel_args("span", q, kq, vq, ints, (spare, vs))
    if bad == "scale_dtype":
        ks = ks.double()
    elif bad == "scale_rows":
        ks = ks[:-1]
    elif bad == "scale_heads":
        ks = ks[:, :1].contiguous()
    elif bad == "float_pools":
        kq, vq = kq.float(), vq.float()
    else:
        ks = torch.cat([ks, ks], dim=1)[:, ::2]
    with pytest.raises(MXNetError):
        ra._check_kernel_args("span", q, kq, vq, ints, (ks, vs))


@pytest.mark.parametrize("splits", ["1", "2", "P"])
@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
def test_int8_span_split_plain_matches_reference(splits, qdtype):
    """The plain version of the kernels' split over pages on int8 pages
    with scales: equal to the span reference (1e-6 in float32, 1.2e-2
    of the largest value in bfloat16) for 1, 2 and P splits, with idle
    slots, dead rows (exact zeros) and splits past the live pages."""
    q, kq, vq, table, ks, vs = _quant_pool(B=4, P=8, S=4, seed=7)
    dt = getattr(torch, qdtype)
    n = {"1": 1, "2": 2, "P": 8}[splits]
    qc = np.int32([4, 5, 8, 0])
    args = (_t(q, dt), _t(kq), _t(vq), _t(table),
            _t(np.int32([13, 28, 1, 6])), _t(qc), SCALE)
    kw = dict(k_scale=_t(ks), v_scale=_t(vs))
    ref = ra._ragged_span_reference(*args, **kw).float()
    got = ra._ragged_span_split_reference(*args, n, **kw).float()
    if dt == torch.float32:
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6,
                                   atol=1e-6)
    else:
        assert (got - ref).abs().max() <= BF16_REL_TOL * ref.abs().max()
    dead = np.arange(8)[None, :] >= qc[:, None]
    assert (got.numpy()[dead] == 0).all()


def test_int8_codes_exact_in_bfloat16():
    """The tensor-core kernel widens int8 codes to bfloat16 in shared
    memory: every code in [-127, 127] survives the round trip."""
    codes = torch.arange(-127, 128, dtype=torch.int8)
    assert torch.equal(codes.to(torch.bfloat16).to(torch.int8), codes)
    assert torch.equal(codes.to(torch.bfloat16).float(), codes.float())


def test_int8_scales_leave_the_products():
    """Both span kernels keep the (page, head) scales out of the
    products: (q . codes) * k_scale equals q . (codes * k_scale), and
    (p * v_scale) . codes equals p . (codes * v_scale), at 1e-6."""
    q, kq, vq, table, ks, vs = _quant_pool(B=1, H=2, D=16, S=8, P=2)
    qf = _t(q[0, :, 0])                       # (Sq, D), head 0
    codes_k = _t(kq[0, :, 0]).float()         # (S, D), page 0
    codes_v = _t(vq[0, :, 0]).float()
    k0, v0 = float(ks[0, 0]), float(vs[0, 0])
    np.testing.assert_allclose((qf @ codes_k.T * k0).numpy(),
                               (qf @ (codes_k * k0).T).numpy(), rtol=1e-6,
                               atol=1e-6)
    p = torch.softmax(qf @ codes_k.T * k0 * SCALE, dim=-1)
    np.testing.assert_allclose(((p * v0) @ codes_v).numpy(),
                               (p @ (codes_v * v0)).numpy(), rtol=1e-6,
                               atol=1e-6)


def _pv_terms(p, codes, n):
    """What the int8 tensor-core kernel does with P (v_scale folded in)
    in P.V: P as n bfloat16 terms, term i = bf16(p - terms 0..i-1), each
    times the int8 codes (exact in bfloat16), the products summed in
    float32. The kernel takes three; one is a single rounding of P."""
    out, rest = 0.0, p
    for _ in range(n):
        term = rest.to(torch.bfloat16).float()
        out = out + term @ codes.float()
        rest = rest - term
    return out


def test_int8_p_split_keeps_float32_accuracy():
    """P rounded once to bfloat16 before P.V misses the float32 product
    (the Pallas quant kernel's) by more than 1e-3 of its largest value on
    this seeded input; hi + lo terms stay within 1e-5 of it, and the
    kernel's three terms within 1e-6."""
    rng = np.random.default_rng(0)
    codes = _t(rng.integers(-127, 128, (64, 64)).astype(np.int8))
    x = _t(rng.standard_normal((16, 64)).astype(np.float32))
    p = torch.softmax(x, dim=-1) * 0.0123        # P times a page's v_scale
    exact = p @ codes.float()
    top = exact.abs().max()
    assert (_pv_terms(p, codes, 1) - exact).abs().max() > 1e-3 * top
    assert (_pv_terms(p, codes, 2) - exact).abs().max() <= 1e-5 * top
    assert (_pv_terms(p, codes, 3) - exact).abs().max() <= 1e-6 * top


def test_int8_span_route():
    """int8 pages take the tensor cores under bfloat16 q, the CUDA
    cores under float32 q, and count under their own keys."""
    q, kq, vq, *_ = _quant_pool(H=2, D=64, S=64, P=1)
    assert ra.span_route(_t(q, torch.bfloat16), _t(kq), _t(vq)) == \
        "tensor_core"
    assert ra.span_route(_t(q), _t(kq), _t(vq)) == "cuda_core"
    q2, kq2, vq2, *_ = _quant_pool(H=2, D=40, S=12, P=1)
    assert ra.span_route(_t(q2, torch.bfloat16), _t(kq2), _t(vq2)) == \
        "cuda_core"


# ---------------------------------------------------------------------------
# the cache quantizer
# ---------------------------------------------------------------------------

def _trash_row(a):
    """numpy pool/scale leaf -> the port's layout: one extra (trash)
    page row after the N real ones."""
    z = np.zeros(a.shape[:1] + (1,) + a.shape[2:], a.dtype)
    return torch.from_numpy(np.concatenate([a, z], axis=1))


def test_int8_write_decode_byte_identical_to_jax():
    """A random write schedule (chunks of 1, 3 and 5 rows over pages of
    4, so several rows of one chunk share a page; dead span rows; locked
    pages; writes past capacity; values of growing magnitude so scales
    keep rising): codes and scales byte-identical to the JAX int8 cache
    after every write. The port's trash page is excluded."""
    rng = np.random.default_rng(7)
    L, B, H, D, S, P = 2, 4, 2, 8, 4, 3
    N = B * P + 2
    table = rng.permutation(N)[:B * P].reshape(B, P).astype(np.int32)
    jc0 = JaxCache.create(L, B, H, P * S, D, page_size=S, num_pages=N,
                          page_table=table, lengths=np.zeros(B),
                          kv_dtype="int8", attn_impl="xla")
    jk, jv, jks, jvs = jc0.k_pages, jc0.v_pages, jc0.k_scale, jc0.v_scale
    pk, pv = _trash_row(np.asarray(jk)), _trash_row(np.asarray(jv))
    pks, pvs = _trash_row(np.asarray(jks)), _trash_row(np.asarray(jvs))
    for step in range(12):
        t = (1, 3, 5)[step % 3]
        lengths = rng.integers(0, P * S + 3, B).astype(np.int32)
        spans = rng.integers(0, t + 1, B).astype(np.int32)
        lock = rng.random(N) < 0.25
        mag = 1.0 + step
        k = (mag * rng.standard_normal((B, H, t, D))).astype(np.float32)
        v = (mag * rng.standard_normal((B, H, t, D))).astype(np.float32)
        layer = step % L
        jc = JaxCache(jk, jv, jnp.asarray(table), jnp.asarray(lengths),
                      page_lock=jnp.asarray(lock), spans=jnp.asarray(spans),
                      k_scale=jks, v_scale=jvs)
        jc = jc.write_decode(layer, jnp.asarray(k), jnp.asarray(v))
        jk, jv, jks, jvs = jc.k_pages, jc.v_pages, jc.k_scale, jc.v_scale
        pc = PagedKVCache(pk, pv, torch.from_numpy(table),
                          torch.from_numpy(lengths),
                          page_lock=torch.from_numpy(lock),
                          spans=torch.from_numpy(spans), k_scale=pks,
                          v_scale=pvs)
        assert pc.quantized
        assert pc.write_decode(layer, torch.from_numpy(k),
                               torch.from_numpy(v)) is pc
        for got, want in ((pk, jk), (pv, jv), (pks, jks), (pvs, jvs)):
            assert got.dtype in (torch.int8, torch.float32)
            np.testing.assert_array_equal(got[:, :N].numpy(),
                                          np.asarray(want))
    assert (np.asarray(jks) > 0).any() and (np.asarray(jk) != 0).any()


def _int8_cache(B=2, P=4, S=8, H=2, D=16, L=1):
    return PagedKVCache.create(L, B, H, P * S, D, page_size=S,
                               lengths=np.zeros(B), kv_dtype="int8",
                               device="cpu")


def _feed(k, v, chunks):
    """Write the (B, H, T, D) stream chunk by chunk through write_decode
    (every row live) and advance; returns the cache."""
    c = _int8_cache()
    t0 = 0
    for n in chunks:
        c.write_decode(0, torch.from_numpy(k[:, :, t0:t0 + n]),
                       torch.from_numpy(v[:, :, t0:t0 + n]))
        c = c.advance(n)
        t0 += n
    return c


def test_int8_codes_independent_of_chunking():
    """Codes and scales are a pure function of the token stream: one
    shot, page-aligned, ragged and token-at-a-time chunkings land the
    same bytes, and they equal the JAX cache's one-shot write."""
    rng = np.random.default_rng(0)
    T, H, D = 20, 2, 16
    k = rng.standard_normal((2, H, T, D)).astype(np.float32)
    v = rng.standard_normal((2, H, T, D)).astype(np.float32)
    a = _feed(k, v, [20])
    for chunks in ([8, 8, 4], [5, 7, 8], [1] * 20):
        b = _feed(k, v, chunks)
        for x, y in ((a.k_pages, b.k_pages), (a.v_pages, b.v_pages),
                     (a.k_scale, b.k_scale), (a.v_scale, b.v_scale)):
            assert torch.equal(x, y)
    jc = JaxCache.create(1, 2, H, 32, D, page_size=8, kv_dtype="int8",
                         lengths=np.zeros(2))
    jc = jc.write_decode(0, jnp.asarray(k), jnp.asarray(v))
    N = a.num_pages
    np.testing.assert_array_equal(a.k_pages[:, :N].numpy(),
                                  np.asarray(jc.k_pages))
    np.testing.assert_array_equal(a.k_scale[:, :N].numpy(),
                                  np.asarray(jc.k_scale))


def test_int8_scales_monotone_no_rewrite_of_history():
    """An append never re-rounds written codes: a huge-magnitude append
    raises page 2's scale but leaves pages 0 and 1 and page 2's first 4
    written slots byte-stable."""
    rng = np.random.default_rng(1)
    H, D = 2, 16
    k1 = rng.standard_normal((1, H, 20, D)).astype(np.float32)
    big = 50.0 * rng.standard_normal((1, H, 4, D)).astype(np.float32)
    c = PagedKVCache.create(1, 1, H, 32, D, page_size=8, lengths=[0],
                            kv_dtype="int8", device="cpu")
    c.write_decode(0, torch.from_numpy(k1), torch.from_numpy(k1))
    c = c.advance(20)
    k0, s0 = c.k_pages.clone(), c.k_scale.clone()
    c.write_decode(0, torch.from_numpy(big), torch.from_numpy(big))
    table = c.page_table[0].long()
    assert torch.equal(k0[0, table[:2]], c.k_pages[0, table[:2]])
    assert torch.equal(k0[0, table[2], :4], c.k_pages[0, table[2], :4])
    assert torch.equal(s0[0, table[:2]], c.k_scale[0, table[:2]])
    assert bool((c.k_scale[0, table[2]] >= s0[0, table[2]]).all())
    assert bool((c.k_scale[0, table[2]] > s0[0, table[2]]).any())


def test_int8_cache_create_and_make_cache(pair):
    _, net = pair
    c = _int8_cache()
    assert c.quantized and c.k_pages.dtype == torch.int8
    assert c.k_scale.shape == (1, c.num_pages + 1, 2)
    assert c.advance(1).k_scale is c.k_scale
    assert not PagedKVCache.create(1, 2, 2, 32, 16, page_size=8,
                                   lengths=[0, 0], device="cpu").quantized
    m = net.make_cache(2, 64, page_size=8, lengths=[0, 0], kv_dtype="int8")
    assert m.quantized and m.k_pages.shape[0] == KW["num_layers"]
    with pytest.raises(MXNetError):
        PagedKVCache.create(1, 1, 2, 16, 4, page_size=8, lengths=[0],
                            kv_dtype="fp16", device="cpu")


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


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(21)
    return [rng.integers(0, KW["vocab_size"], n).tolist()
            for n, _ in TRAFFIC]


_JAX_STREAMS = {}


def _jax_int8_streams(jnet, prompts, chunk_tokens):
    """The JAX int8 engine's greedy streams for TRAFFIC and each
    request's recorded prompt write schedule (once per chunk size per
    session)."""
    if chunk_tokens not in _JAX_STREAMS:
        eng = JaxEngine(jnet, attn_impl="xla", chunk_tokens=chunk_tokens,
                        kv_dtype="int8", **ENGINE)
        reqs = [JaxRequest(p, n, request_id=i)
                for i, (p, (_, n)) in enumerate(zip(prompts, TRAFFIC))]
        eng.serve(reqs)
        assert eng.audit_pages() == []
        _JAX_STREAMS[chunk_tokens] = (
            [r.output_tokens for r in reqs],
            [list(r.kv_history) for r in reqs])
    return _JAX_STREAMS[chunk_tokens]


def _jax_int8_gap(jnet, prompt, emitted, history):
    """The JAX int8 path's top-2 logit gap at the token after `prompt +
    emitted`, replaying the engine's write schedule for that request
    alone: the prompt in its recorded chunks (`history`), then each
    emitted token as a one-row write. (The chunking is part of the int8
    numerics; a slot's rows never mix with another slot's.)"""
    L, H = KW["num_layers"], KW["num_heads"]
    cache = JaxCache.create(L, 1, H, KW["max_length"],
                            KW["units"] // H, page_size=ENGINE["page_size"],
                            lengths=np.zeros(1), kv_dtype="int8",
                            attn_impl="xla")
    cuts = np.cumsum([0] + list(history))
    feeds = [prompt[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
    feeds += [[t] for t in emitted]
    for toks in feeds:
        logits, cache = jnet(mx.nd.array(np.int32([toks]), dtype="int32"),
                             cache)
    top = np.sort(logits.asnumpy()[0, -1])[-2:]
    return float(top[1] - top[0])


def _held_to_jax(got, want, jnet, prompts, histories):
    """Streams equal, except where the JAX int8 top-2 gap at the first
    differing token is below 1e-4 (the comparison stops there). Returns
    the accepted divergences [(request, token, gap)]."""
    accepted = []
    for i, (a, b) in enumerate(zip(got, want)):
        if a == b:
            continue
        j = next(k for k in range(min(len(a), len(b))) if a[k] != b[k])
        gap = _jax_int8_gap(jnet, prompts[i], b[:j], histories[i])
        assert gap < 1e-4, (i, j, gap, a, b)
        accepted.append((i, j, gap))
    return accepted


def _port_serve(net, reqs, **kw):
    eng = ServingEngine(net, device="cpu", **dict(ENGINE, **kw))
    done = eng.serve(reqs)
    assert eng.audit_pages() == []
    assert eng.scheduler.num_free == eng.num_slots
    return eng, done


@pytest.mark.parametrize("chunk_tokens", [4, 8])
def test_engine_int8_greedy_matches_jax(pair, prompts, chunk_tokens):
    jnet, net = pair
    want, histories = _jax_int8_streams(jnet, prompts, chunk_tokens)
    reqs = [Request(p, n, request_id=i)
            for i, (p, (_, n)) in enumerate(zip(prompts, TRAFFIC))]
    eng, _ = _port_serve(net, reqs, chunk_tokens=chunk_tokens,
                         kv_dtype="int8")
    got = [r.output_tokens for r in reqs]
    accepted = _held_to_jax(got, want, jnet, prompts, histories)
    assert len(accepted) <= 1, accepted
    assert [len(g) for g in got] == [len(w) for w in want]
    assert eng.kv_dtype == "int8" and eng._kp.dtype == torch.int8
    # the write schedule is recorded as the JAX engine records it
    assert [r.kv_history for r in reqs] == histories
    assert all(r.kv_attach == 0 for r in reqs)


def test_engine_int8_gap_rule_is_sound(pair, prompts):
    """The divergence rule's oracle: replaying request 2's write
    schedule alone in the JAX int8 cache picks the JAX engine's own
    next token (its argmax) — the gap is read where the engine decided."""
    jnet, _ = pair
    want, histories = _jax_int8_streams(jnet, prompts, 8)
    for i in (2, 4):
        prompt, stream, hist = prompts[i], want[i], histories[i]
        for j in range(4):
            # the replay's argmax is the engine's token: a positive gap
            # whenever the picks agree
            L, H = KW["num_layers"], KW["num_heads"]
            cache = JaxCache.create(L, 1, H, KW["max_length"],
                                    KW["units"] // H, page_size=8,
                                    lengths=np.zeros(1), kv_dtype="int8",
                                    attn_impl="xla")
            cuts = np.cumsum([0] + hist)
            feeds = [prompt[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
            for toks in feeds + [[t] for t in stream[:j]]:
                logits, cache = jnet(mx.nd.array(np.int32([toks]),
                                                 dtype="int32"), cache)
            assert int(logits.asnumpy()[0, -1].argmax()) == stream[j]
        assert _jax_int8_gap(jnet, prompt, stream[:3], hist) > 0


def test_engine_int8_tracks_float32_where_the_margin_is_decisive(pair,
                                                                 prompts):
    """int8 against float32 (tests/test_quant_kv.py's margin-aware
    oracle): first tokens agree wherever float32's top-2 gap exceeds
    0.01, and most whole streams match."""
    _, net = pair
    reqs = lambda: [Request(p, n, request_id=i)  # noqa: E731
                    for i, (p, (_, n)) in enumerate(zip(prompts, TRAFFIC))]
    fp, q8 = reqs(), reqs()
    _port_serve(net, fp, chunk_tokens=8)
    _port_serve(net, q8, chunk_tokens=8, kv_dtype="int8")
    match = sum(a.output_tokens == b.output_tokens for a, b in zip(fp, q8))
    assert match >= len(fp) // 2
    for i, p in enumerate(prompts):
        cache = net.make_cache(1, 64, page_size=8, lengths=[0])
        with torch.no_grad():
            lg = net(torch.tensor([p]), cache)[0][0, -1].numpy()
        top2 = np.sort(lg)[-2:]
        if top2[1] - top2[0] > 0.01:
            assert q8[i].output_tokens[0] == int(lg.argmax()), i


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("budget", ["loose", "tight", "one_slot",
                                    "prefix"])
def test_engine_hbm_budget_pages_equal_jax(pair, kv_dtype, budget):
    """Byte-denominated pool sizing: the same page cost and page count
    as the JAX engine for the same budget; int8 pages are about 4x
    cheaper, so a budget buys more of them."""
    jnet, net = pair
    fp_page = 2 * KW["num_layers"] * 8 * KW["units"] * 4
    kw = dict(ENGINE)
    b = {"loose": 10 ** 7, "tight": fp_page * 16,
         "one_slot": fp_page * 8 + 1, "prefix": fp_page * 40}[budget]
    if budget == "prefix":
        kw["prefix_cache"] = True
    port = ServingEngine(net, device="cpu", hbm_budget_bytes=b,
                         kv_dtype=kv_dtype, **kw)
    ref = JaxEngine(jnet, attn_impl="xla", hbm_budget_bytes=b,
                    kv_dtype=kv_dtype, **kw)
    assert port.page_pool.page_bytes == ref.page_pool.page_bytes
    assert port.page_pool.num_pages == ref.page_pool.num_pages
    assert port._kp.shape[1] == port.page_pool.num_pages + 1
    assert port.admission_capacity_estimate() \
        == ref.admission_capacity_estimate()
    if kv_dtype == "int8":
        assert port.page_pool.page_bytes < fp_page / 3


def test_engine_page_limited_serves_everything_by_backpressure(pair,
                                                               prompts):
    """A pool that holds two slots' pages for three slots: admissions the
    pool cannot map are requeued (no blame, no error) and every request
    finishes with the streams of an unconstrained engine."""
    _, net = pair
    page = 2 * KW["num_layers"] * 8 * KW["units"] + 2 * KW["num_layers"] \
        * KW["num_heads"] * 4
    reqs = [Request(p, n, request_id=i)
            for i, (p, (_, n)) in enumerate(zip(prompts, TRAFFIC))]
    # a prefill budget that never binds keeps every prompt on the same
    # chunk grid whatever the admission order (int8 numerics depend on
    # the grid, not on co-scheduling)
    kw = dict(chunk_tokens=8, prefill_chunk_budget=64, kv_dtype="int8")
    eng, done = _port_serve(net, reqs, hbm_budget_bytes=page * 16,
                            retry_backoff_s=0.0, **kw)
    assert eng.page_pool.num_pages == 16
    assert {r.status for r in done} == {"finished"} and len(done) == 7
    assert eng.stats["dispatch_retries"] > 0
    want = [Request(p, n, request_id=i)
            for i, (p, (_, n)) in enumerate(zip(prompts, TRAFFIC))]
    _port_serve(net, want, **kw)
    assert [r.output_tokens for r in reqs] == [r.output_tokens for r in want]
    assert eng.page_pool.num_free == eng.page_pool.num_pages


@pytest.mark.parametrize("bad", [dict(hbm_budget_bytes=100),
                                 dict(kv_dtype="fp16"),
                                 dict(kv_dtype="bfloat16"),
                                 dict(prefix_cache=True,
                                      prefix_cache_pages=-1)])
def test_engine_int8_rejections(pair, bad):
    _, net = pair
    with pytest.raises(MXNetError):
        ServingEngine(net, device="cpu", **bad, **ENGINE)
