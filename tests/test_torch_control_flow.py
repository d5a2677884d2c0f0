"""The port's control-flow ops (mx.nd.contrib foreach / while_loop /
cond) against the JAX package's: the cases of tests/test_control_flow.py,
outputs, shapes and dtypes exactly, and gradients through a loop under
autograd.record() (the port runs the loops eagerly, so the body's ops
record) against the reference's hybridized trace.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu.gluon import HybridBlock as JHybridBlock  # noqa: E402
from mxnet_tpu.gluon import nn as jnn  # noqa: E402

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import MXNetError, functional, models  # noqa: E402
from mxnet_tpu_torch.gluon import HybridBlock, nn  # noqa: E402

CPU = mx.cpu()


def _eq(port, ref):
    p, r = port.asnumpy(), ref.asnumpy()
    assert p.shape == r.shape and p.dtype == r.dtype
    np.testing.assert_array_equal(p, r)


def _both(fn):
    """fn(mx) run in each package (the port on the CPU)."""
    with CPU:
        return fn(mx), fn(jmx)


def test_foreach_cumsum():
    data = np.arange(12, dtype=np.float32).reshape(4, 3)

    def run(m):
        def body(x, state):
            new = state + x
            return new, new
        return m.nd.contrib.foreach(body, m.nd.array(data), m.nd.zeros((3,)))

    (po, pf), (jo, jf) = _both(run)
    _eq(po, jo)
    _eq(pf, jf)
    np.testing.assert_array_equal(po.asnumpy(), np.cumsum(data, axis=0))


def test_foreach_multiple_states_and_outputs():
    def run(m):
        def body(x, states):
            s, c = states
            return [s + x, c * 2.0], [s + x, c * 2.0]
        return m.nd.contrib.foreach(
            body, m.nd.array(np.ones((5, 2), np.float32)),
            [m.nd.zeros((2,)), m.nd.ones((1,))])

    (po, pf), (jo, jf) = _both(run)
    assert po[0].shape == (5, 2) and po[1].shape == (5, 1)
    for a, b in zip(po + pf, jo + jf):
        _eq(a, b)
    np.testing.assert_array_equal(pf[1].asnumpy(), [32.0])


def test_foreach_over_a_list_of_data_and_no_outputs():
    a = np.arange(6, dtype=np.float32).reshape(3, 2)

    def run(m):
        def body(xs, s):
            return [], s + xs[0] * xs[1]
        return m.nd.contrib.foreach(body, [m.nd.array(a), m.nd.array(a)],
                                    m.nd.zeros((2,)))

    (po, pf), (jo, jf) = _both(run)
    assert po == [] and list(jo) == []
    _eq(pf, jf)


def test_foreach_rnn_style_gradient():
    """Gradients reach the data and the parameters the body captures."""
    r = np.random.default_rng(0)
    xv = r.random((4, 2, 3)).astype(np.float32)

    def make(m, nn_, base):
        class Cum(base):
            def __init__(self):
                super().__init__()
                self.proj = nn_.Dense(3, in_units=3, use_bias=False)

            def forward(self, x):
                def body(xt, s):
                    s = s + self.proj(xt)
                    return s, s
                outs, final = m.nd.contrib.foreach(
                    body, x, m.nd.zeros((x.shape[1], 3)))
                return final.sum()
        return Cum()

    jnet = make(jmx, jnn, JHybridBlock)
    jnet.initialize()
    jx = jmx.nd.array(xv)
    jx.attach_grad()
    with jmx.autograd.record():
        jy = jnet(jx)
    jy.backward()
    with CPU:
        net = make(mx, nn, HybridBlock)
        net.initialize()
        models.load_gluon_params(
            net, {n: p.data().asnumpy()
                  for n, p in jnet.collect_params().items()})
        x = mx.nd.array(xv)
        x.attach_grad()
        with mx.autograd.record():
            y = net(x)
        y.backward()
    np.testing.assert_allclose(y.asnumpy(), jy.asnumpy(), rtol=1e-6)
    np.testing.assert_allclose(x.grad.asnumpy(), jx.grad.asnumpy(),
                               rtol=1e-6)
    w = net.collect_params()["proj.weight"]
    # d final / d W = sum over steps and rows of x_t (one row per output)
    np.testing.assert_allclose(
        w.grad().asnumpy(), np.broadcast_to(xv.sum(axis=(0, 1)), (3, 3)),
        rtol=1e-5)


def test_while_loop_eager_trims():
    def run(m):
        def cond(i, s):
            return i < 5

        def func(i, s):
            return s + i, [i + 1, s + i]
        return m.nd.contrib.while_loop(
            cond, func, [m.nd.zeros(()), m.nd.zeros(())], max_iterations=10)

    (po, pf), (jo, jf) = _both(run)
    assert po.shape == (5,)
    _eq(po, jo)
    for a, b in zip(pf, jf):
        _eq(a, b)
    np.testing.assert_array_equal(po.asnumpy(), [0, 1, 3, 6, 10])


def test_while_loop_max_iterations_required():
    with CPU:
        with pytest.raises(MXNetError, match="max_iterations"):
            mx.nd.contrib.while_loop(lambda i: i < 3, lambda i: (i, [i]),
                                     [mx.nd.zeros(())])


def test_while_loop_hits_max():
    def run(m):
        return m.nd.contrib.while_loop(
            lambda i: i < 100, lambda i: (i * 2, [i + 1]),
            [m.nd.zeros(())], max_iterations=4)

    (po, pf), (jo, jf) = _both(run)
    assert po.shape == (4,)
    _eq(po, jo)
    _eq(pf[0], jf[0])


def test_while_loop_no_step_and_list_outputs():
    def run(m):
        return m.nd.contrib.while_loop(
            lambda i: i < 0,
            lambda i: ([m.nd.ones((2,)) * i, i.astype("int32")], [i + 1]),
            [m.nd.zeros(())], max_iterations=3)

    (po, pf), (jo, jf) = _both(run)
    assert [o.shape for o in po] == [(0, 2), (0,)]
    for a, b in zip(list(po) + pf, list(jo) + jf):
        _eq(a, b)


def test_while_loop_records_gradients():
    with CPU:
        x = mx.nd.array([1.5])
        x.attach_grad()
        with mx.autograd.record():
            outs, (i, s) = mx.nd.contrib.while_loop(
                lambda i, s: i < 3, lambda i, s: (s, [i + 1, s * x]),
                [mx.nd.zeros(()), mx.nd.ones((1,))], max_iterations=5)
            s.backward()
    np.testing.assert_allclose(s.asnumpy(), [1.5 ** 3])
    np.testing.assert_allclose(x.grad.asnumpy(), [3 * 1.5 ** 2], rtol=1e-6)


def test_cond_eager_and_jit():
    def run(m, v):
        x = m.nd.array([v])
        return m.nd.contrib.cond(x.sum() > 1.0, lambda: x * 10.0,
                                 lambda: x - 1.0)

    for v in (2.0, 0.2):
        with CPU:
            p = run(mx, v)
        _eq(p, run(jmx, v))
    with CPU:
        f = functional.jit(lambda a: mx.nd.contrib.cond(
            a.sum() > 1.0, lambda: a * 10.0, lambda: a - 1.0))
        np.testing.assert_allclose(f(mx.nd.array([0.2])).asnumpy(), [-0.8],
                                   rtol=1e-6)
        # only the taken branch runs, and it records
        x = mx.nd.array([2.0])
        x.attach_grad()
        ran = []
        with mx.autograd.record():
            y = mx.nd.contrib.cond(
                x.sum() > 1.0, lambda: ran.append("then") or x * x,
                lambda: ran.append("else") or x)
        y.backward()
    assert ran == ["then"]
    np.testing.assert_allclose(x.grad.asnumpy(), [4.0])


def test_contrib_reexports_detection_ops():
    from mxnet_tpu_torch.ops import detection
    for name in ("box_iou", "box_nms", "multibox_detection",
                 "multibox_prior", "multibox_target", "roi_align"):
        assert getattr(mx.nd.contrib, name) is getattr(detection, name)
        assert hasattr(jmx.nd.contrib, name)
