"""The port's autograd (mxnet_tpu_torch.autograd) against the JAX
package's mx.autograd.

Each case runs the same small graph, on the same seeded numpy inputs,
through both packages (the port on the CPU) and compares the gradients
within 1e-6 relative to their largest magnitude: grad_req 'write',
'add' and 'null' over two backward calls, head_grads, retain_graph,
pause, predict_mode, second order with create_graph, autograd.grad, a
custom Function and mark_variables. Also: outside record() no graph is
built, and a head that is not on the graph raises.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as jmx  # noqa: E402

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import MXNetError  # noqa: E402

CPU = mx.cpu()
REL = 1e-6
R = np.random.default_rng(0)
XA = R.standard_normal((3, 4)).astype(np.float32)
WA = R.standard_normal((4, 2)).astype(np.float32)
HG = R.standard_normal((3, 2)).astype(np.float32)


def _arr(pkg, a):
    return mx.nd.array(a, ctx=CPU) if pkg is mx else pkg.nd.array(a)


def _close(got, want, name=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= REL * scale, (name, got, want)


def _both(fn):
    """fn(pkg) on both packages: (port result, reference result)."""
    return fn(mx), fn(jmx)


def _graph(m, x, w):
    return (m.nd.sin(x) * x).sum() + m.nd.dot(x, w).sum() * 0.5


@pytest.mark.parametrize("req", ["write", "add", "null"])
def test_grad_req_over_two_backwards(req):
    def run(m):
        x, w = _arr(m, XA), _arr(m, WA)
        x.attach_grad(req)
        w.attach_grad()
        out = []
        for scale in (1.0, 3.0):
            with m.autograd.record():
                y = _graph(m, x, w) * scale
            y.backward()
            out.append(None if x.grad is None or req == "null"
                       else x.grad.asnumpy())
            out.append(w.grad.asnumpy())
        return out
    got, want = _both(run)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            _close(g, w, req)


def test_null_leaf_has_no_gradient():
    x = mx.nd.array(XA, ctx=CPU)
    x.attach_grad("null")
    with mx.autograd.record():
        y = (x * 2).sum()
    assert x.grad is None
    with pytest.raises(MXNetError):
        y.backward()


def test_head_grads_and_retain_graph():
    def run(m):
        x, w = _arr(m, XA), _arr(m, WA)
        x.attach_grad()
        with m.autograd.record():
            y = m.nd.dot(m.nd.tanh(x), w)
        m.autograd.backward([y], [_arr(m, HG)], retain_graph=True)
        g1 = x.grad.asnumpy()
        y.backward(_arr(m, HG * 2))
        return g1, x.grad.asnumpy()
    got, want = _both(run)
    for g, w in zip(got, want):
        _close(g, w, "head_grads")


def test_graph_released_without_retain():
    x = mx.nd.array(XA, ctx=CPU)
    x.attach_grad()
    with mx.autograd.record():
        y = (mx.nd.exp(x) * x).sum()
    y.backward()
    with pytest.raises(MXNetError, match="consumed"):
        y.backward()


def test_pause_and_no_graph_outside_record():
    def run(m):
        x = _arr(m, XA)
        x.attach_grad()
        with m.autograd.record():
            a = x * x
            with m.autograd.pause():
                b = x * 3          # a constant: no gradient through it
            y = (a * b).sum()
        y.backward()
        return x.grad.asnumpy()
    got, want = _both(run)
    _close(got, want, "pause")
    x = mx.nd.array(XA, ctx=CPU)
    x.attach_grad()
    y = (x * x).sum()
    assert not y._data.requires_grad
    with pytest.raises(MXNetError, match="not on the graph"):
        y.backward()


def test_train_and_predict_mode_flags():
    for m in (mx, jmx):
        assert not m.autograd.is_recording()
        with m.autograd.record():
            assert m.autograd.is_recording() and m.autograd.is_training()
            with m.autograd.predict_mode():
                assert not m.autograd.is_training()
            with m.autograd.pause():
                assert not m.autograd.is_recording()
        with m.autograd.record(train_mode=False):
            assert not m.autograd.is_training()
        with m.autograd.train_mode():
            assert m.autograd.is_training()
    x = mx.nd.ones((100,), ctx=CPU)
    with mx.autograd.record():
        with mx.autograd.predict_mode():
            same = mx.nd.Dropout(x, p=0.5)
        dropped = mx.nd.Dropout(x, p=0.5)
    np.testing.assert_array_equal(same.asnumpy(), x.asnumpy())
    assert set(np.unique(dropped.asnumpy())) <= {0.0, 2.0}
    assert (dropped.asnumpy() == 0).any()


def test_second_order_create_graph():
    def run(m):
        x = _arr(m, XA)
        x.attach_grad()
        with m.autograd.record():
            y = (x * x * x + m.nd.sin(x)).sum()
            dy = m.autograd.grad(y, x, create_graph=True)
            z = (dy * dy).sum()
        z.backward()
        return dy.asnumpy(), x.grad.asnumpy()
    got, want = _both(run)
    for g, w in zip(got, want):
        _close(g, w, "second order")


def test_grad_returns_without_writing():
    def run(m):
        x, w = _arr(m, XA), _arr(m, WA)
        x.attach_grad()
        w.attach_grad()
        with m.autograd.record():
            y = _graph(m, x, w)
        gx, gw = m.autograd.grad(y, [x, w])
        return gx.asnumpy(), gw.asnumpy(), x.grad.asnumpy()
    got, want = _both(run)
    for g, w in zip(got, want):
        _close(g, w, "grad")
    np.testing.assert_array_equal(got[2], 0)


def _function(m):
    class ScaledSigmoid(m.autograd.Function):
        """y = sigmoid(x) * s, with a hand-written backward."""

        def forward(self, x, s):
            y = 1 / (1 + m.nd.exp(-x))
            self.save_for_backward(y, s)
            return y * s

        def backward(self, dy):
            y, s = self.saved_tensors
            return dy * s * y * (1 - y), (dy * y).sum(axis=0)
    return ScaledSigmoid


def test_custom_function():
    def run(m):
        x, s = _arr(m, XA), _arr(m, XA[0])
        x.attach_grad()
        s.attach_grad()
        with m.autograd.record():
            y = _function(m)()(x, s)
            z = (y * y).sum()
        z.backward()
        return y.asnumpy(), x.grad.asnumpy(), s.grad.asnumpy()
    got, want = _both(run)
    for g, w in zip(got, want):
        _close(g, w, "Function")


def test_mark_variables():
    def run(m):
        x = _arr(m, XA)
        g = _arr(m, np.zeros_like(XA))
        m.autograd.mark_variables([x], [g])
        with m.autograd.record():
            y = (m.nd.exp(x)).sum()
        y.backward()
        return x.grad.asnumpy()
    got, want = _both(run)
    _close(got, want, "mark_variables")
