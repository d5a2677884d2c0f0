"""The port's mx.np / mx.npx against NumPy and the JAX package's mx.np.

The cases of tests/test_np_semantics.py (elementwise, reductions,
einsum, products, advanced indexing, where / clip, dtype promotion,
sorting and search, linalg with a recorded gradient, stacking, NaN
handling), each held to NumPy's values and to the reference's values
and dtypes; then the names the port lifts from torch through its table
(numpy keywords, the reference's promotion with 0-d arrays, stable
sorts), the sub-namespaces, the not_ported refusal and mx.npx.
"""
import numpy as onp
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as jmx  # noqa: E402

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import MXNetError  # noqa: E402

np_ = mx.np
jnp_ = jmx.np
CPU = mx.cpu()


def _nd(a):
    return mx.nd.array(onp.asarray(a), ctx=CPU)


def _jd(a):
    return jmx.nd.array(onp.asarray(a))


def _check(got, want, ref=None, rtol=1e-5, atol=1e-6):
    """got (port) against NumPy's want, and against the reference's
    result in value and dtype."""
    g = onp.asarray(got.asnumpy())
    onp.testing.assert_allclose(g, want, rtol=rtol, atol=atol)
    if ref is not None:
        r = onp.asarray(ref.asnumpy())
        assert g.dtype == r.dtype and g.shape == r.shape
        onp.testing.assert_allclose(g, r, rtol=rtol, atol=atol)


RNG = onp.random.default_rng(0)
A = RNG.standard_normal((3, 4)).astype(onp.float32)
B = RNG.standard_normal((4, 5)).astype(onp.float32)
V = RNG.standard_normal(4).astype(onp.float32)

UNARY = ["sin", "cos", "tan", "arcsin", "arccos", "arctan", "sinh",
         "cosh", "tanh", "exp", "expm1", "log1p", "sqrt", "cbrt",
         "floor", "ceil", "rint", "sign", "square", "reciprocal",
         "degrees", "radians"]


@pytest.mark.parametrize("name", UNARY)
def test_unary_matches_numpy_and_reference(name):
    x = onp.clip(A, -0.9, 0.9) if name in ("arcsin", "arccos") else \
        onp.abs(A) + 0.1 if name in ("sqrt", "log1p", "reciprocal") else A
    _check(getattr(np_, name)(_nd(x)), getattr(onp, name)(x),
           getattr(jnp_, name)(_jd(x)))


BINARY = ["add", "subtract", "multiply", "divide", "maximum", "minimum",
          "arctan2", "hypot", "fmod", "copysign", "logaddexp"]


@pytest.mark.parametrize("name", BINARY)
def test_binary_broadcasting(name):
    _check(getattr(np_, name)(_nd(A), _nd(V)), getattr(onp, name)(A, V),
           getattr(jnp_, name)(_jd(A), _jd(V)))


REDUCE = [("sum", {}), ("mean", {}), ("max", {}), ("min", {}),
          ("prod", {}), ("std", {}), ("var", {}),
          ("sum", {"axis": 1}), ("mean", {"axis": 0}),
          ("sum", {"axis": 1, "keepdims": True}),
          ("argmax", {"axis": 1}), ("argmin", {"axis": 0}),
          ("cumsum", {"axis": 1}), ("cumprod", {"axis": 0})]


@pytest.mark.parametrize("name,kw", REDUCE,
                         ids=[f"{n}-{k}" for n, k in REDUCE])
def test_reductions(name, kw):
    _check(getattr(np_, name)(_nd(A), **kw), getattr(onp, name)(A, **kw),
           getattr(jnp_, name)(_jd(A), **kw))


def test_einsum_and_products():
    for spec, ops in [("ij,jk->ik", (A, B)), ("ij,j->i", (A, V)),
                      ("ij->ji", (A,)), ("ij,ij->", (A, A)),
                      ("ij,kj->ik", (A, A))]:
        _check(np_.einsum(spec, *[_nd(o) for o in ops]),
               onp.einsum(spec, *ops),
               jnp_.einsum(spec, *[_jd(o) for o in ops]), rtol=1e-4,
               atol=1e-5)
    _check(np_.matmul(_nd(A), _nd(B)), A @ B, jnp_.matmul(_jd(A), _jd(B)))
    _check(np_.dot(_nd(A), _nd(B)), onp.dot(A, B), jnp_.dot(_jd(A), _jd(B)))
    _check(np_.tensordot(_nd(A), _nd(B), axes=1),
           onp.tensordot(A, B, axes=1),
           jnp_.tensordot(_jd(A), _jd(B), axes=1))
    _check(np_.outer(_nd(V), _nd(V)), onp.outer(V, V),
           jnp_.outer(_jd(V), _jd(V)))


def test_advanced_indexing():
    x, jx = _nd(A), _jd(A)
    idx = onp.asarray([2, 0, 1])
    _check(x[_nd(idx)], A[idx], jx[_jd(idx)])
    cols = onp.asarray([3, 1])
    _check(x[:, _nd(cols)], A[:, cols], jx[:, _jd(cols)])
    mask = A > 0
    _check(x[_nd(mask)], A[mask], jx[_jd(mask)])
    _check(x[1:3, ::2], A[1:3, ::2], jx[1:3, ::2])
    _check(x[::-1], A[::-1], jx[::-1])
    _check(x[..., -1], A[..., -1], jx[..., -1])


def test_where_clip_abs():
    _check(np_.where(_nd(A > 0), _nd(A), _nd(-A)), onp.where(A > 0, A, -A),
           jnp_.where(_jd(A > 0), _jd(A), _jd(-A)))
    _check(np_.clip(_nd(A), -0.5, 0.5), onp.clip(A, -0.5, 0.5),
           jnp_.clip(_jd(A), -0.5, 0.5))
    _check(np_.abs(_nd(A)), onp.abs(A), jnp_.abs(_jd(A)))


def test_dtype_promotion_corners():
    """The reference's lattice (no 64-bit types): numpy's within it."""
    def pair(vals, dt):
        return _nd(onp.asarray(vals, dt)), _jd(onp.asarray(vals, dt))
    i8, ji8 = pair([1, 2], onp.int8)
    i32, ji32 = pair([1, 2], onp.int32)
    f32, jf32 = pair([1.0, 2.0], onp.float32)
    u8, ju8 = pair([1, 2], onp.uint8)
    for p, j, want in [(i8 + i32, ji8 + ji32, onp.int32),
                       (i8 + f32, ji8 + jf32, onp.float32),
                       (i32 + f32, ji32 + jf32, onp.float32),
                       (u8 + i8, ju8 + ji8, onp.int16),
                       (i32 * 2.5, ji32 * 2.5, onp.float32),
                       (np_.sqrt(i32), jnp_.sqrt(ji32), onp.float32)]:
        assert p.dtype == want == j.dtype
    # a lifted binary: 0-d arrays count like any other (torch would keep
    # int16 / float16 here), Python numbers stay weak
    i16 = _nd(onp.asarray([1, -2], onp.int16))
    s32 = _nd(onp.asarray(3, onp.int32))
    assert np_.fmax(i16, s32).dtype == onp.int32 == \
        jnp_.fmax(_jd(onp.asarray([1, -2], onp.int16)),
                  _jd(onp.asarray(3, onp.int32))).dtype
    h = _nd(onp.asarray([1, 2], onp.float16))
    assert np_.fmax(h, _nd(onp.asarray(1.0, onp.float32))).dtype == \
        onp.float32
    assert np_.fmax(h, 1.5).dtype == onp.float16
    assert np_.heaviside(i32, 0.5).dtype == onp.float32 == \
        jnp_.heaviside(ji32, 0.5).dtype


def test_sorting_and_search():
    x = RNG.standard_normal(20).astype(onp.float32)
    _check(np_.sort(_nd(x)), onp.sort(x), jnp_.sort(_jd(x)))
    got = onp.asarray(np_.argsort(_nd(x)).asnumpy())
    onp.testing.assert_array_equal(got, onp.argsort(x))
    assert got.dtype == jnp_.argsort(_jd(x)).asnumpy().dtype
    ties = onp.asarray([2, 1, 2, 1, 2, 1], onp.float32)   # stable
    onp.testing.assert_array_equal(np_.argsort(_nd(ties)).asnumpy(),
                                   onp.argsort(ties, kind="stable"))
    xs = onp.sort(x)
    q = onp.asarray([-0.3, 0.1], onp.float32)
    _check(np_.searchsorted(_nd(xs), _nd(q)), onp.searchsorted(xs, q),
           jnp_.searchsorted(_jd(xs), _jd(q)))
    u = onp.asarray([3, 1, 3, 2])
    _check(np_.unique(_nd(u), size=3), onp.unique(u),
           jnp_.unique(_jd(u), size=3))


def test_linalg():
    M = (A.T @ A + 3 * onp.eye(4)).astype(onp.float32)
    _check(np_.linalg.norm(_nd(A)), onp.linalg.norm(A),
           jnp_.linalg.norm(_jd(A)))
    _check(np_.linalg.norm(_nd(A), axis=1, keepdims=True),
           onp.linalg.norm(A, axis=1, keepdims=True),
           jnp_.linalg.norm(_jd(A), axis=1, keepdims=True))
    _check(np_.linalg.inv(_nd(M)), onp.linalg.inv(M),
           jnp_.linalg.inv(_jd(M)), rtol=1e-3, atol=1e-4)
    _check(np_.linalg.det(_nd(M)), onp.linalg.det(M),
           jnp_.linalg.det(_jd(M)), rtol=1e-4)
    _check(np_.linalg.solve(_nd(M), _nd(V)), onp.linalg.solve(M, V),
           jnp_.linalg.solve(_jd(M), _jd(V)), rtol=1e-4, atol=1e-5)
    # the lifted linalg records: grad of sum(inv(M)) against the reference
    x, jx = _nd(M), _jd(M)
    x.attach_grad()
    jx.attach_grad()
    with mx.autograd.record():
        y = np_.linalg.inv(x).sum()
    y.backward()
    with jmx.autograd.record():
        jy = jnp_.linalg.inv(jx).sum()
    jy.backward()
    onp.testing.assert_allclose(x.grad.asnumpy(), jx.grad.asnumpy(),
                                rtol=1e-3, atol=1e-5)
    with pytest.raises(MXNetError, match="mx.np.linalg.tensorinv"):
        np_.linalg.tensorinv


def test_fft():
    x = RNG.standard_normal(8).astype(onp.float32)
    got = np_.fft.rfft(_nd(x)).asnumpy()
    onp.testing.assert_allclose(got, onp.fft.rfft(x), rtol=1e-5, atol=1e-5)
    onp.testing.assert_allclose(got, jnp_.fft.rfft(_jd(x)).asnumpy(),
                                rtol=1e-5, atol=1e-5)
    X = RNG.standard_normal((4, 4)).astype(onp.float32)
    onp.testing.assert_allclose(
        np_.fft.fft2(_nd(X), axes=(0, 1)).asnumpy(),
        onp.fft.fft2(X, axes=(0, 1)), rtol=1e-4, atol=1e-5)


def test_stacking_shapes():
    _check(np_.concatenate([_nd(A), _nd(A)], axis=0),
           onp.concatenate([A, A], axis=0),
           jnp_.concatenate([_jd(A), _jd(A)], axis=0))
    _check(np_.stack([_nd(V), _nd(V)], axis=1), onp.stack([V, V], axis=1),
           jnp_.stack([_jd(V), _jd(V)], axis=1))
    _check(np_.broadcast_to(_nd(V), (3, 4)), onp.broadcast_to(V, (3, 4)),
           jnp_.broadcast_to(_jd(V), (3, 4)))
    _check(np_.tile(_nd(V), (2, 3)), onp.tile(V, (2, 3)),
           jnp_.tile(_jd(V), (2, 3)))
    _check(np_.vstack([_nd(V), _nd(V)]), onp.vstack([V, V]),
           jnp_.vstack([_jd(V), _jd(V)]))


def test_nan_handling():
    x = onp.asarray([1.0, onp.nan, 3.0], onp.float32)
    _check(np_.nansum(_nd(x)), onp.nansum(x), jnp_.nansum(_jd(x)))
    _check(np_.nanmean(_nd(x)), onp.nanmean(x), jnp_.nanmean(_jd(x)))
    _check(np_.isnan(_nd(x)), onp.isnan(x), jnp_.isnan(_jd(x)))
    _check(np_.nan_to_num(_nd(x)), onp.nan_to_num(x),
           jnp_.nan_to_num(_jd(x)))


LIFTED = [("amax", {"axis": 1}), ("amin", {}), ("all", {"axis": 0}),
          ("any", {"axis": 1, "keepdims": True}), ("median", {}),
          ("median", {"axis": 1}), ("ptp", {"axis": 0}),
          ("percentile", {"q": 30.0}), ("quantile", {"q": 0.25, "axis": 1}),
          ("count_nonzero", {"axis": 1}), ("round", {"decimals": 1}),
          ("fabs", {}), ("exp2", {}), ("signbit", {}), ("ravel", {}),
          ("moveaxis", {"source": 0, "destination": 1}), ("flipud", {}),
          ("diff", {"axis": 1}), ("cov", {}), ("nanvar", {"axis": 1}),
          ("nanstd", {}), ("argwhere", {}), ("nancumsum", {"axis": 1})]


@pytest.mark.parametrize("name,kw", LIFTED,
                         ids=[f"{n}-{k}" for n, k in LIFTED])
def test_lifted_names(name, kw):
    x = (A > 0) if name in ("all", "any") else A
    got = getattr(np_, name)(_nd(x), **kw)
    want = getattr(onp, name)(x, **kw)
    ref = getattr(jnp_, name)(_jd(x), **kw)
    g = onp.asarray(got.asnumpy())
    onp.testing.assert_allclose(g, want, rtol=1e-5, atol=1e-6)
    onp.testing.assert_allclose(g, ref.asnumpy(), rtol=1e-5, atol=1e-6)
    assert g.dtype == onp.asarray(ref.asnumpy()).dtype


def test_lifted_ops_record_gradients():
    x = _nd(A)
    x.attach_grad()
    with mx.autograd.record():
        y = np_.amax(x, axis=1).sum() + np_.fmax(x, 0.0).sum()
    y.backward()
    want = (A == A.max(axis=1, keepdims=True)).astype(onp.float32) + \
        (A > 0)
    onp.testing.assert_allclose(x.grad.asnumpy(), want.astype(onp.float32))


def test_unported_names_and_npx():
    with pytest.raises(MXNetError, match="mx.np.polyfit is not ported"):
        np_.polyfit
    with pytest.raises(AttributeError):
        np_.not_a_numpy_name
    assert not hasattr(np_, "_private")
    assert np_.pi == onp.pi and np_.float32 == "float32"
    npx = mx.npx
    assert npx.set_np() and npx.reset_np()
    assert npx.is_np_array() and npx.is_np_shape()
    assert npx.is_np_default_dtype()
    assert npx.set_np(shape=False) == jmx.npx.set_np(shape=False)
    _check(npx.relu(_nd(A)), onp.maximum(A, 0), jmx.npx.relu(_jd(A)))
    _check(npx.softmax(_nd(A)), jmx.npx.softmax(_jd(A)).asnumpy())
