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
