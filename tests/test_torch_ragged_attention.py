"""The port's ragged paged attention against the JAX package.

The same numpy inputs go through the port's plain versions (what a CPU
tensor takes) and through the JAX package's dense references AND its
Pallas kernels in interpret mode, on the `_pool` shapes and q_counts
cases of tests/test_chunked_prefill.py and tests/test_serving.py.
Tolerances: float32 2e-5 (sums in another order); bfloat16 2e-2 against
the float32 oracle (bf16 rounding of inputs and output). The CUDA
kernels themselves run only on a card (chip_smoke.py holds them to
these plain versions there); here the wrapper's gate and dispatch rules
are checked.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mxnet_tpu.ops import pallas_attention as pa  # noqa: E402
from mxnet_tpu_torch import MXNetError  # noqa: E402
from mxnet_tpu_torch.ops import _build  # noqa: E402
from mxnet_tpu_torch.ops import ragged_attention as ra  # noqa: E402

SCALE = 1.0 / np.sqrt(16)


def _pool(B=5, H=2, D=16, S=8, P=4, Sq=8, seed=0):
    """numpy inputs of tests/test_chunked_prefill.py::_pool."""
    rng = np.random.default_rng(seed)
    N = B * P
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    kp = rng.standard_normal((N, S, H, D)).astype(np.float32)
    vp = rng.standard_normal((N, S, H, D)).astype(np.float32)
    table = rng.permutation(N).reshape(B, P).astype(np.int32)
    return q, kp, vp, table


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _span_all(q, kp, vp, table, L, qc, dtype=torch.float32):
    """Port plain version, JAX reference and JAX interpret-mode kernel
    on the same inputs (JAX in f32 for the oracle)."""
    port = ra.ragged_span_attention(
        _t(q, dtype), _t(kp, dtype), _t(vp, dtype), _t(table),
        _t(np.int32(L)), q_counts=_t(np.int32(qc)))
    jq, jk, jv = map(jnp.asarray, (q, kp, vp))
    jl, jqc, jt = (jnp.asarray(np.int32(x)) for x in (L, qc, table))
    ref = pa._ragged_span_reference(jq, jk, jv, jt, jl, jqc, SCALE)
    kern = pa.ragged_span_attention(jq, jk, jv, jt, jl, q_counts=jqc,
                                    interpret=True)
    return port.float().numpy(), np.asarray(ref), np.asarray(kern)


def test_span_mixed_batch_one_dispatch():
    """decode (1), verify (4), full chunk (8), idle (0) and a ragged
    tail (5) in one call; dead rows are exact zeros."""
    q, kp, vp, table = _pool()
    qc = [1, 4, 8, 0, 5]
    port, ref, kern = _span_all(q, kp, vp, table, [9, 17, 1, 30, 12], qc)
    np.testing.assert_allclose(port, ref, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(port, kern, rtol=2e-5, atol=2e-5)
    dead = np.arange(8)[None, :] >= np.asarray(qc)[:, None]
    assert (port[dead] == 0).all()


@pytest.mark.parametrize("qc", [[0, 0, 0, 0, 0], [1, 1, 1, 1, 1],
                                [8, 8, 8, 8, 8], [3, 7, 2, 6, 1]])
def test_span_q_counts_edges(qc):
    q, kp, vp, table = _pool(seed=1)
    port, ref, kern = _span_all(q, kp, vp, table, [5, 1, 24, 13, 8], qc)
    np.testing.assert_allclose(port, ref, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(port, kern, rtol=2e-5, atol=2e-5)
    dead = np.arange(8)[None, :] >= np.asarray(qc)[:, None]
    assert (port[dead] == 0).all()


def test_span_bf16_tolerance():
    q, kp, vp, table = _pool(seed=3)
    qc = [2, 8, 0, 1, 6]
    port, ref, kern = _span_all(q, kp, vp, table, [7, 20, 13, 3, 26], qc,
                                dtype=torch.bfloat16)
    np.testing.assert_allclose(port, ref, rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(port, kern, rtol=2e-2, atol=2e-2)
    dead = np.arange(8)[None, :] >= np.asarray(qc)[:, None]
    assert (port[dead] == 0).all()


def test_span_q_counts_none_means_every_row_live():
    q, kp, vp, table = _pool(seed=2)
    L = _t(np.int32([4, 11, 27, 2, 19]))
    args = (_t(q), _t(kp), _t(vp), _t(table), L)
    full = ra.ragged_span_attention(*args, q_counts=_t(np.full(5, 8,
                                                               np.int32)))
    assert torch.equal(ra.ragged_span_attention(*args), full)


@pytest.mark.parametrize("lengths", [[5, 17, 32], [0, 1, 8],
                                     [32, 32, 32], [0, 0, 0]])
def test_decode_matches_jax(lengths):
    """tests/test_serving.py's decode cases: port plain version against
    the JAX dense reference and the interpret-mode kernel."""
    q4, kp, vp, table = _pool(B=3, Sq=1)
    q = q4[:, 0]
    L = np.int32(lengths)
    port = ra.ragged_decode_attention(_t(q), _t(kp), _t(vp), _t(table),
                                      _t(L)).numpy()
    jargs = tuple(map(jnp.asarray, (q, kp, vp, table, L)))
    ref = pa._ragged_reference(*jargs, SCALE)
    kern = pa.ragged_decode_attention(*jargs, interpret=True)
    np.testing.assert_allclose(port, np.asarray(ref), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(port, np.asarray(kern), rtol=2e-5,
                               atol=2e-5)
    assert (port[L == 0] == 0).all()


def test_decode_bf16_tolerance():
    q4, kp, vp, table = _pool(B=3, Sq=1)
    q = q4[:, 0]
    L = np.int32([7, 20, 13])
    port = ra.ragged_decode_attention(
        _t(q, torch.bfloat16), _t(kp, torch.bfloat16),
        _t(vp, torch.bfloat16), _t(table), _t(L))
    assert port.dtype == torch.bfloat16
    ref = pa._ragged_reference(*map(jnp.asarray, (q, kp, vp, table, L)),
                               SCALE)
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref),
                               rtol=2e-2, atol=2e-2)


def test_decode_equals_span_at_one_row_in_plain_versions():
    q4, kp, vp, table = _pool(B=3, Sq=1, seed=4)
    L = _t(np.int32([3, 9, 25]))
    args = (_t(kp), _t(vp), _t(table), L)
    dec = ra.ragged_decode_attention(_t(q4[:, 0]), *args)
    span = ra.ragged_span_attention(_t(q4), *args)
    np.testing.assert_allclose(dec.numpy(), span[:, 0].numpy(), rtol=1e-6,
                               atol=1e-6)


# the decode split's edge lengths at S = 8, P = 4: an idle slot, one key,
# a full page, one key past it, every page
DECODE_EDGES = [0, 1, 8, 9, 32]


@functools.lru_cache(maxsize=None)
def _decode_edges_jax():
    """The JAX package's decode on the edge lengths, computed once: its
    XLA reference and its Pallas kernel in interpret mode."""
    q4, kp, vp, table = _pool(B=5, Sq=1, seed=7)
    jargs = tuple(map(jnp.asarray, (q4[:, 0], kp, vp, table,
                                    np.int32(DECODE_EDGES))))
    return ((q4[:, 0], kp, vp, table),
            np.asarray(pa.ragged_decode_attention(*jargs, impl="xla")),
            np.asarray(pa.ragged_decode_attention(*jargs, impl="pallas",
                                                  interpret=True)))


@pytest.mark.parametrize("splits", ["1", "2", "P"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_split_plain_matches_jax(splits, dtype):
    """The plain version of the decode kernel's split over pages against
    the JAX package's ragged_decode_attention (impl="xla" and the Pallas
    kernel in interpret mode) at lengths 0, 1, S, S + 1 and P * S, with
    1, 2 and P splits: float32 at 1e-5, bfloat16 as
    test_decode_bf16_tolerance; a length-0 slot gives exact zeros."""
    (q, kp, vp, table), xla, kern = _decode_edges_jax()
    P = table.shape[1]
    n = {"1": 1, "2": 2, "P": P}[splits]
    dt = getattr(torch, dtype)
    got = ra._ragged_decode_split_reference(
        _t(q, dt), _t(kp, dt), _t(vp, dt), _t(table),
        _t(np.int32(DECODE_EDGES)), SCALE, n)
    assert got.dtype == dt
    tol = 1e-5 if dtype == "float32" else 2e-2
    for ref in (xla, kern):
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=tol,
                                   atol=tol)
    assert (got[0] == 0).all()


def test_decode_split_plan():
    # the decode cell: 160 (slot, head) rows -> 8 splits of 2 pages
    assert ra.decode_split_plan(8, 20, 16, 132) == 8
    assert ra.decode_split_plan(0, 20, 16, 132) == 1
    assert ra.decode_split_plan(1, 1, 1, 132) == 1
    # a grid that fills the card alone takes no split
    assert ra.decode_split_plan(256, 32, 16, 132) == 1
    for B, H, P in [(1, 1, 64), (1, 2, 5), (2, 3, 9), (8, 20, 16),
                    (3, 1, 33), (1, 1, 2), (64, 20, 16)]:
        n = ra.decode_split_plan(B, H, P, 132)
        pps = -(-P // n)
        assert 1 <= n <= ra._MAX_SPLITS
        assert (n - 1) * pps < P            # no split left empty
    import inspect
    assert list(inspect.signature(ra.decode_split_plan).parameters) == [
        "B", "H", "P", "sms"]
    with pytest.raises(TypeError):
        ra.decode_split_plan(torch.tensor(8), 20, 16, 132)


# ---------------------------------------------------------------------------
# dispatch rules and the kernel gate
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    ra.reset_launches()
    q, kp, vp, table = _pool()
    args = (_t(q), _t(kp), _t(vp), _t(table), _t(np.int32([1, 2, 3, 4, 5])))
    auto = ra.ragged_span_attention(*args)
    plain = ra.ragged_span_attention(*args, impl="torch")
    assert torch.equal(auto, plain)
    assert ra.LAUNCHES == {"ragged_span_attention": 0,
                           "ragged_span_attention_int8": 0,
                           "ragged_span_attention_tc": 0,
                           "ragged_span_attention_int8_tc": 0,
                           "ragged_decode_attention": 0}


@pytest.mark.parametrize("impl", ["xla", "pallas", "cuda"])
def test_unknown_impl_rejected(impl):
    q, kp, vp, table = _pool()
    args = (_t(q), _t(kp), _t(vp), _t(table), _t(np.int32([1, 2, 3, 4, 5])))
    with pytest.raises(ValueError):
        ra.ragged_span_attention(*args, impl=impl)
    with pytest.raises(ValueError):
        ra.ragged_decode_attention(args[0][:, 0], *args[1:], impl=impl)


def test_ragged_supported_gate():
    q, kp, _, _ = _pool(H=2, D=64, S=64)
    assert ra.ragged_supported(_t(q), _t(kp))
    assert ra.ragged_supported(_t(q, torch.bfloat16),
                               _t(kp, torch.bfloat16))
    # pool dtype must be q's; int, f16 and head dims past 128 refused
    assert not ra.ragged_supported(_t(q), _t(kp, torch.bfloat16))
    assert not ra.ragged_supported(_t(q, torch.float16),
                                   _t(kp, torch.float16))
    assert not ra.ragged_supported(_t(q).int(), _t(kp).int())
    q2, kp2, _, _ = _pool(H=1, D=160, S=8)
    assert not ra.ragged_supported(_t(q2), _t(kp2))
    # a page whose staging overflows a Hopper block's shared memory
    q3, kp3, _, _ = _pool(B=1, H=1, D=128, S=256, P=1, Sq=1)
    assert not ra.ragged_supported(_t(q3), _t(kp3))


@pytest.mark.parametrize("bad", ["dtype", "contiguous", "table_dtype",
                                 "heads", "lengths_shape"])
def test_kernel_argument_check_refuses(bad):
    """What the CUDA wrapper refuses before it launches (the check is
    device-agnostic, so it runs here on CPU tensors)."""
    q, kp, vp, table = _pool()
    q, kp, vp, table = _t(q), _t(kp), _t(vp), _t(table)
    ints = {"page_table": table, "lengths": _t(np.int32([1] * 5)),
            "q_counts": _t(np.int32([1] * 5))}
    ra._check_kernel_args("span", q, kp, vp, ints)   # the good call
    if bad == "dtype":
        q = q.double()
    elif bad == "contiguous":
        q = q.transpose(0, 1)
    elif bad == "table_dtype":
        ints["page_table"] = table.long()
    elif bad == "heads":
        kp = vp = kp[:, :, :1].contiguous()
    else:
        ints["lengths"] = _t(np.int32([1] * 4))
    with pytest.raises(MXNetError):
        ra._check_kernel_args("span", q, kp, vp, ints)


def test_kernel_sources_and_build_names():
    for name, src in _build.SOURCES.items():
        assert src.is_file()
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR
        assert path == _build.library_path(name)    # stable digest
        assert path.name.startswith(name + "-")
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


# ---------------------------------------------------------------------------
# the span kernels' split over pages, route rule and shared-memory mirrors
# ---------------------------------------------------------------------------

def _split_cases():
    """(pool kwargs, lengths, q_counts): idle slots, dead rows, slots
    whose keys end on a split boundary or leave splits with no live
    page, every page live (length P*S - q_count + 1), and a second
    64-row query tile."""
    return [(dict(B=5, P=4, S=8, Sq=8), [9, 17, 1, 30, 12], [1, 4, 8, 0, 5]),
            (dict(B=4, P=8, S=4, Sq=8), [13, 28, 1, 6], [4, 5, 8, 0]),
            (dict(B=2, P=6, S=16, Sq=70, H=1), [30, 96 - 70 + 1],
             [70, 70])]


@pytest.mark.parametrize("case", range(3))
@pytest.mark.parametrize("splits", ["1", "2", "P"])
def test_span_split_plain_matches_reference(case, splits):
    """The plain version of the kernels' split, partials and combine
    equals the span reference at 1e-6 for 1, 2 and P splits; dead rows
    and idle slots are exact zeros."""
    kw, lens, qc = _split_cases()[case]
    q, kp, vp, table = _pool(**kw)
    P = table.shape[1]
    n = {"1": 1, "2": 2, "P": P}[splits]
    args = (_t(q), _t(kp), _t(vp), _t(table), _t(np.int32(lens)),
            _t(np.int32(qc)), SCALE)
    ref = ra._ragged_span_reference(*args)
    got = ra._ragged_span_split_reference(*args, n)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6,
                               atol=1e-6)
    dead = np.arange(q.shape[1])[None, :] >= np.asarray(qc)[:, None]
    assert (got.numpy()[dead] == 0).all()


def test_span_split_plain_matches_reference_bf16():
    q, kp, vp, table = _pool(B=4, P=8, S=4, seed=6)
    args = (_t(q, torch.bfloat16), _t(kp, torch.bfloat16),
            _t(vp, torch.bfloat16), _t(table),
            _t(np.int32([13, 28, 1, 6])), _t(np.int32([4, 5, 8, 0])), SCALE)
    ref = ra._ragged_span_reference(*args).float()
    got = ra._ragged_span_split_reference(*args, 4).float()
    assert (got - ref).abs().max() <= 1.2e-2 * ref.abs().max()


def test_span_split_plan():
    # the kernel cell and the serve's dispatch: 160 tiles -> 4 splits
    # (about four blocks an SM), 4 pages each
    assert ra.span_split_plan(8, 20, 64, 16, 132) == 4
    # a grid that fills the card alone takes no split
    assert ra.span_split_plan(64, 20, 64, 16, 132) == 1
    assert ra.span_split_plan(0, 20, 64, 16, 132) == 1
    # one page: nothing to split
    assert ra.span_split_plan(1, 1, 1, 1, 132) == 1
    for B, H, Sq, P in [(1, 1, 1, 64), (1, 2, 8, 5), (2, 3, 130, 9),
                        (8, 20, 64, 16), (3, 1, 64, 33), (1, 1, 64, 2)]:
        n = ra.span_split_plan(B, H, Sq, P, 132)
        pps = -(-P // n)
        assert 1 <= n <= ra._MAX_SPLITS
        assert n == 1 or pps >= 2           # never under 2 pages a split
        assert (n - 1) * pps < P            # no split left empty


def test_span_split_plan_reads_static_shapes_only():
    """The plan takes plain integers (shapes and the SM count), never a
    tensor: the wrapper decides it without reading device values."""
    import inspect
    assert list(inspect.signature(ra.span_split_plan).parameters) == [
        "B", "H", "Sq", "P", "sms"]
    with pytest.raises(TypeError):
        ra.span_split_plan(torch.tensor(8), 20, 64, 16, 132)


def _route(qdtype, D=64, S=64, pool=None, offset=0):
    q = torch.zeros(2, 8, 2, D, dtype=qdtype)
    n = 4 * S * 2 * D
    buf = torch.zeros(n + 16, dtype=pool or qdtype)
    kp = buf[offset:offset + n].view(4, S, 2, D)
    return ra.span_route(q, kp, kp)


def test_span_route_rule():
    bf = torch.bfloat16
    assert _route(bf) == "tensor_core"
    assert _route(bf, pool=torch.int8) == "tensor_core"
    assert _route(bf, D=128, S=16) == "tensor_core"
    assert _route(bf, D=40, S=256) == "tensor_core"   # pads to 64
    # float32 q stays on the CUDA cores (1e-5 needs float32 FMAs)
    assert _route(torch.float32) == "cuda_core"
    assert _route(torch.float32, pool=torch.int8) == "cuda_core"
    # head dim, page size and alignment the tensor cores refuse
    assert _route(bf, D=12) == "cuda_core"
    assert _route(bf, D=40, S=12) == "cuda_core"
    assert _route(bf, S=8) == "cuda_core"
    assert _route(bf, S=272) == "cuda_core"
    assert _route(bf, offset=4) == "cuda_core"         # 8 bytes off
    assert _route(bf, pool=torch.int8, offset=4) == "cuda_core"
    assert ra.span_launch_key("tensor_core", False) == \
        "ragged_span_attention_tc"
    assert ra.span_launch_key("tensor_core", True) == \
        "ragged_span_attention_int8_tc"
    assert ra.span_launch_key("cuda_core", False) == "ragged_span_attention"
    assert ra.span_launch_key("cuda_core", True) == \
        "ragged_span_attention_int8"
    assert set(ra.LAUNCHES) == {ra.span_launch_key(r, qt) for r in (
        "tensor_core", "cuda_core") for qt in (False, True)} | {
        "ragged_decode_attention"}


def _constants(path):
    import re
    text = path.read_text()
    return {m[0]: int(m[1]) for m in re.findall(
        r"constexpr (?:int|size_t) (\w+) = (\d+);", text)}


def test_shared_memory_mirrors_match_kernel_constants():
    """The wrapper's mirrors of the kernels' compile-time constants."""
    csrc = _build.SOURCES["ragged_attention"].parent
    split = _constants(csrc / "span_split.cuh")
    cc = _constants(csrc / "ragged_attention.cu")
    tc = _constants(csrc / "ragged_attention_tc.cu")
    assert split["SPAN_TILE"] == ra._SPAN_TILE == 64
    assert split["SPAN_MAX_SPLITS"] == ra._MAX_SPLITS
    assert tc["STAGES"] == ra._TC_STAGES
    assert tc["BN"] == ra._SPAN_TILE
    assert cc["MAX_SMEM"] == ra._MAX_SMEM
    assert cc["MAX_D"] == ra._MAX_D
    # span_combine's static weights: SPAN_MAX_SPLITS x SPAN_TILE floats
    # and a flag (ptxas reports 4112 bytes of static shared memory)
    assert ra._STATIC_SMEM == 4 * ra._MAX_SPLITS * ra._SPAN_TILE + 16
    # K rows: an odd count of 16-byte words, the row and a word at least
    for row in (40, 48, 64, 80, 128, 160, 256, 512):
        w = ra._k_stride(row) // 16
        assert w % 2 == 1 and 16 * w >= row + 16
    # the tensor-core staging: Q tile + 3 stages of K and V (bfloat16),
    # or Q + widened K/V + 3 stages of codes and scales (int8)
    assert ra._tc_smem(64, False) == 1024 + 8192 + 3 * 16384
    assert ra._tc_smem(128, False) == 1024 + 16384 + 3 * 32768
    assert ra._tc_smem(64, True) == 1024 + 8192 + 16384 + 3 * (8192 + 512)
    assert ra._tc_smem(40, True) == ra._tc_smem(64, True)
    # the CUDA-core staging at the serve's shapes: two stages fit
    assert ra._span_smem(64, 64, 4, 2) + ra._STATIC_SMEM <= ra._MAX_SMEM
    assert ra._span_smem(128, 128, 4, 2) + ra._STATIC_SMEM > ra._MAX_SMEM
    assert ra._span_smem(128, 128, 4, 1) + ra._STATIC_SMEM <= ra._MAX_SMEM
    # the decode ring: 32-key chunk slots of K rows (odd 16-byte words)
    # and V rows; 8 slots where they fit in DEC_RING_BYTES, else 4, and
    # never more than a split's chunks
    assert cc["DEC_CHUNK"] == ra._DEC_CHUNK == 32
    assert cc["DEC_RING_BYTES"] == ra._DEC_RING_BYTES
    assert cc["DEC_THREADS"] == 32 * ra._DEC_WARPS
    assert ra._decode_slots(64, 2, 64, 2) == 4      # bf16, 2 pages: 4 chunks
    assert ra._decode_slots(64, 2, 64, 16) == 8     # 8 x 8704 bytes fit
    assert ra._decode_slots(64, 4, 64, 16) == 4     # 8 x 16896 do not
    assert ra._decode_slots(64, 4, 16, 1) == 1
    assert ra._decode_smem(64, 2, 4) == 256 + 4 * 32 * (144 + 128) \
        + 4 * 4 * 66
    assert ra._decode_smem(64, 4, 4) == 256 + 4 * 32 * (272 + 256) \
        + 4 * 4 * 66
    for D, item in ((128, 4), (128, 2), (40, 4), (12, 2)):
        nc = ra._decode_slots(D, item, 256, 16)
        assert ra._decode_smem(D, item, nc) + ra._STATIC_SMEM \
            <= ra._MAX_SMEM
