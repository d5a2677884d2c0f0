"""The port's mx.operator, mx.functional and sparse shim against the JAX
package's.

* register_op: a torch function becomes an op of the registry (mx.nd.<name>)
  that records under autograd; with grad=(fwd, bwd) in the reference's
  custom-vjp form its backward is the given one. Both held to the same
  op registered in the reference through jax.numpy;
* the legacy CustomOp / CustomOpProp / register / mx.nd.Custom path
  (forward(is_train=False) only, as in the reference);
* functional grad / value_and_grad / jacfwd / jacrev / hessian / vmap /
  eval_shape / jit against the reference's (jax.grad, jacfwd, vmap);
* the dense-backed CSR and row-sparse shim and its de-scope errors.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu import functional as jF, operator as jop  # noqa: E402
from mxnet_tpu.ndarray import sparse as jsparse  # noqa: E402
from mxnet_tpu.ops.registry import OPS as JOPS  # noqa: E402

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import MXNetError, functional as F  # noqa: E402
from mxnet_tpu_torch import operator as op  # noqa: E402
from mxnet_tpu_torch.ndarray import sparse  # noqa: E402
from mxnet_tpu_torch.ops.registry import OPS  # noqa: E402

CPU = mx.cpu()
X = np.random.default_rng(0).standard_normal((3, 4)).astype(np.float32)


@pytest.fixture
def registered():
    """Names registered by a test, removed from both registries after."""
    names = []
    yield names
    for n in names:
        OPS._map.pop(n.lower(), None)
        JOPS._map.pop(n.lower(), None)


def _grad_of(m, fn, x):
    a = m.nd.array(x, ctx=CPU) if m is mx else m.nd.array(x)
    a.attach_grad()
    with m.autograd.record():
        y = fn(a).sum()
    y.backward()
    return y.asnumpy(), a.grad.asnumpy()


def test_register_op_without_custom_gradient(registered):
    registered.append("torch_softsq")
    sq = op.register_op("torch_softsq",
                        lambda x, k=1.0: torch.log1p(torch.exp(x)) * x * k)
    registered.append("torch_softsq_ref")
    jsq = jop.register_op("torch_softsq_ref",
                          lambda x, k=1.0: jnp.log1p(jnp.exp(x)) * x * k)
    assert mx.nd.torch_softsq is sq
    y, g = _grad_of(mx, lambda a: mx.nd.torch_softsq(a, k=2.0), X)
    jy, jg = _grad_of(jmx, lambda a: jsq(a, k=2.0), X)
    np.testing.assert_allclose(y, jy, rtol=1e-5)
    np.testing.assert_allclose(g, jg, rtol=1e-5, atol=1e-6)
    # on tensors it is the function itself
    t = torch.from_numpy(X)
    assert torch.equal(sq(t), torch.log1p(torch.exp(t)) * t)


def test_register_op_with_custom_gradient(registered):
    """A straight-through clip: forward clips, backward passes 3x the
    gradient (so the custom rule, not autodiff, is what ran)."""
    def fwd(x):
        return torch.clamp(x, -0.5, 0.5), None

    def bwd(res, g):
        return (3.0 * g,)

    def jfwd(x):
        return jnp.clip(x, -0.5, 0.5), None

    def jbwd(res, g):
        return (3.0 * g,)

    registered += ["torch_st_clip", "torch_st_clip_ref"]
    st = op.register_op("torch_st_clip", lambda x: torch.clamp(x, -0.5, 0.5),
                        grad=(fwd, bwd))
    jst = jop.register_op("torch_st_clip_ref",
                          lambda x: jnp.clip(x, -0.5, 0.5),
                          grad=(jfwd, jbwd))
    y, g = _grad_of(mx, st, X)
    jy, jg = _grad_of(jmx, jst, X)
    np.testing.assert_allclose(y, jy, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(g, jg)
    np.testing.assert_array_equal(g, np.full_like(X, 3.0))
    # unregistered: not in mx.nd
    local = op.register_op("torch_local_only", lambda x: x + 1,
                           register_global=False)
    assert "torch_local_only" not in OPS
    np.testing.assert_array_equal(
        local(mx.nd.array(X, ctx=CPU)).asnumpy(), X + 1)


def _define_custom(mod, name):
    class Scale(mod.CustomOp):
        def __init__(self, factor):
            self.factor = factor

        def forward(self, is_train, req, in_data, out_data, aux):
            assert is_train is False
            self.assign(out_data[0], req[0], in_data[0] * self.factor)
            self.assign(out_data[1], "add", in_data[0])

    @mod.register(name)
    class ScaleProp(mod.CustomOpProp):
        def __init__(self, factor=2.0):
            super().__init__()
            self.factor = float(factor)

        def list_outputs(self):
            return ["output", "copy"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0], in_shape[0]], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return Scale(self.factor)

    return ScaleProp


def test_custom_op_legacy_path():
    _define_custom(op, "torch_scale")
    _define_custom(jop, "torch_scale")
    with CPU:
        out, copy = mx.nd.Custom(mx.nd.array(X), op_type="torch_scale",
                                 factor=3)
    jout, jcopy = jmx.nd.Custom(jmx.nd.array(X), op_type="torch_scale",
                                factor=3)
    np.testing.assert_array_equal(out.asnumpy(), jout.asnumpy())
    np.testing.assert_array_equal(copy.asnumpy(), jcopy.asnumpy())
    assert op.get("torch_scale").__name__ == "ScaleProp"
    with pytest.raises(MXNetError, match="no custom op"):
        op.get("never_registered")
    with pytest.raises(MXNetError, match="op_type"):
        mx.nd.Custom(mx.nd.array(X, ctx=CPU))
    with pytest.raises(MXNetError, match="CustomOpProp"):
        op.register("bad")(object)
    with pytest.raises(MXNetError, match="backward not implemented"):
        op.CustomOp().backward(None, None, None, None, None, None)


def _f(m):
    return lambda a: (m.nd.sin(a) * a * a).sum()


def test_functional_grad_and_value_and_grad():
    x, jx = mx.nd.array(X, ctx=CPU), jmx.nd.array(X)
    np.testing.assert_allclose(F.grad(_f(mx))(x).asnumpy(),
                               jF.grad(_f(jmx))(jx).asnumpy(), rtol=1e-5,
                               atol=1e-6)
    v, g = F.value_and_grad(_f(mx))(x)
    jv, jg = jF.value_and_grad(_f(jmx))(jx)
    np.testing.assert_allclose(v.asnumpy(), jv.asnumpy(), rtol=1e-5)
    np.testing.assert_allclose(g.asnumpy(), jg.asnumpy(), rtol=1e-5,
                               atol=1e-6)
    # second order and argnums
    gg = F.grad(lambda a: F.grad(_f(mx))(a).sum())(x).asnumpy()
    jgg = jF.grad(lambda a: jF.grad(_f(jmx))(a).sum())(jx).asnumpy()
    np.testing.assert_allclose(gg, jgg, rtol=1e-4, atol=1e-5)
    two = F.grad(lambda a, b: (a * b).sum(), argnums=(0, 1))(x, x * 2.0)
    np.testing.assert_allclose(two[0].asnumpy(), 2 * X, rtol=1e-6)
    np.testing.assert_allclose(two[1].asnumpy(), X, rtol=1e-6)
    g, aux = F.grad(lambda a: ((a * a).sum(), a.max()), has_aux=True)(x)
    np.testing.assert_allclose(g.asnumpy(), 2 * X, rtol=1e-6)
    assert float(aux.asnumpy()) == X.max()


def test_functional_jacobians_hessian_vmap():
    v = X[0]
    x, jx = mx.nd.array(v, ctx=CPU), jmx.nd.array(v)

    def g(m):
        return lambda a: m.nd.tanh(a) * a

    for name in ("jacfwd", "jacrev", "jacobian"):
        np.testing.assert_allclose(
            getattr(F, name)(g(mx))(x).asnumpy(),
            getattr(jF, name)(g(jmx))(jx).asnumpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(F.hessian(_f(mx))(x).asnumpy(),
                               jF.hessian(_f(jmx))(jx).asnumpy(),
                               rtol=1e-4, atol=1e-5)
    W = np.random.default_rng(1).standard_normal((4, 2)).astype(np.float32)
    got = F.vmap(lambda r: mx.nd.dot(r, mx.nd.array(W, ctx=CPU)))(
        mx.nd.array(X, ctx=CPU))
    want = jF.vmap(lambda r: jmx.nd.dot(r, jmx.nd.array(W)))(jmx.nd.array(X))
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=1e-5,
                               atol=1e-6)
    cols = F.vmap(lambda c: c * 2.0, in_axes=1, out_axes=1)(
        mx.nd.array(X, ctx=CPU))
    np.testing.assert_allclose(cols.asnumpy(), 2 * X)


def test_functional_jit_and_eval_shape():
    fn = _f(mx)
    assert F.jit(fn) is fn
    with pytest.raises(MXNetError, match="callable"):
        F.grad(3)
    s = F.eval_shape(lambda a, b: (mx.nd.dot(a, b), a.astype("int32")),
                     mx.nd.array(X, ctx=CPU), mx.nd.array(X.T, ctx=CPU))
    js = jF.eval_shape(lambda a, b: (jmx.nd.dot(a, b), a.astype("int32")),
                       jmx.nd.array(X), jmx.nd.array(X.T))
    assert [(t.shape, str(t.dtype)) for t in s] == \
        [(tuple(t.shape), str(t.dtype)) for t in js]


def test_sparse_shim():
    data, indices, indptr = [1.0, 2.0, 3.0], [0, 2, 1], [0, 2, 3]
    c = sparse.csr_matrix((data, indices, indptr), shape=(2, 3), ctx=CPU)
    jc = jsparse.csr_matrix((data, indices, indptr), shape=(2, 3))
    assert c.stype == jc.stype == "csr"
    for attr in ("indptr", "indices", "data"):
        a, b = getattr(c, attr).asnumpy(), getattr(jc, attr).asnumpy()
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(c.asnumpy(), jc.asnumpy())
    np.testing.assert_array_equal((c * 2).asnumpy(), (jc * 2).asnumpy())
    r = sparse.row_sparse_array(([[1.0, 2.0]], [2]), shape=(4, 2), ctx=CPU)
    jr = jsparse.row_sparse_array(([[1.0, 2.0]], [2]), shape=(4, 2))
    assert r.stype == jr.stype == "row_sparse"
    for attr in ("indices", "data"):
        np.testing.assert_array_equal(getattr(r, attr).asnumpy(),
                                      getattr(jr, attr).asnumpy())
    d = r.tostype("default")
    assert d.stype == "default" and type(d) is mx.nd.NDArray
    assert r.tostype("row_sparse") is r
    with pytest.raises(MXNetError, match="de-scoped"):
        r.tostype("csr")
    with pytest.raises(MXNetError, match="de-scoped"):
        c.retain(None)
    with pytest.raises(MXNetError, match="shape"):
        sparse.csr_matrix((data, indices, indptr))
    dense = sparse.csr_matrix(np.eye(3, dtype=np.float32), ctx=CPU)
    np.testing.assert_array_equal(dense.indices.asnumpy(), [0, 1, 2])
    assert mx.nd.sparse is sparse
