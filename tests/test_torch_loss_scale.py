"""The port's TrainStep loss scaling against the JAX package's TrainStep.

Every case of tests/test_fused_amp.py, each run through both packages
from the same weights (carried by models.load_gluon_params) and the same
seeded numpy batches: losses within 1e-5 relative, parameters within
1e-6, the scale after every step exactly, and an overflow step skipped
bitwise (parameters, optimizer states, BatchNorm's running statistics).
Also the 2^24 cap and the 1.0 floor of the dynamic scale, and a static
scale (a float32 no-op).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu import optimizer as jopt, parallel as jpar  # noqa: E402
from mxnet_tpu.gluon import loss as jloss, nn as jnn  # noqa: E402

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import models  # noqa: E402
from mxnet_tpu_torch.checkpoint import TrainCheckpoint  # noqa: E402
from mxnet_tpu_torch.gluon import loss as ploss, nn as pnn  # noqa: E402
from mxnet_tpu_torch.optimizer import SGD, Adam  # noqa: E402
from mxnet_tpu_torch.parallel import EvalStep, TrainStep  # noqa: E402

CPU = mx.cpu()


def _arrays(jnet):
    return {n: np.array(p.data().asnumpy())
            for n, p in jnet.collect_params().items()}


def _dense_pair(loss_scale=None, scale_window=2000, bn=False, lr=0.05):
    if bn:
        jnet = jnn.HybridSequential()
        jnet.add(jnn.Dense(4, in_units=4))
        jnet.add(jnn.BatchNorm(in_channels=4))
        jnet.add(jnn.Dense(3, in_units=4))
        pnet = pnn.HybridSequential()
        pnet.add(pnn.Dense(4, in_units=4))
        pnet.add(pnn.BatchNorm(in_channels=4))
        pnet.add(pnn.Dense(3, in_units=4))
    else:
        jnet = jnn.Dense(3, in_units=4)
        pnet = pnn.Dense(3, in_units=4)
    jmx.rng.seed(0)
    jnet.initialize(jmx.init.Normal(0.1))
    pnet.initialize(ctx=CPU)
    models.load_gluon_params(pnet, _arrays(jnet), ctx=CPU)
    jstep = jpar.TrainStep(jnet, jloss.L2Loss(), jopt.SGD(learning_rate=lr),
                           mesh=None, loss_scale=loss_scale,
                           scale_window=scale_window)
    pstep = TrainStep(pnet, ploss.L2Loss(), SGD(learning_rate=lr),
                      loss_scale=loss_scale, scale_window=scale_window)
    return (jnet, jstep), (pnet, pstep)


def _batch(seed=0, scale=1.0):
    r = np.random.default_rng(seed)
    x = (r.standard_normal((8, 4)) * scale).astype(np.float32)
    y = r.standard_normal((8, 3)).astype(np.float32)
    return x, y


INF = np.full((8, 4), np.inf, np.float32)


def _run(pair, xs, y):
    (jnet, jstep), (pnet, pstep) = pair
    jl, pl = [], []
    for x in xs:
        jl.append(float(jstep(jmx.nd.array(x), jmx.nd.array(y)).asscalar()))
        pl.append(float(pstep(torch.from_numpy(x), torch.from_numpy(y))))
        assert pstep.loss_scale == jstep.loss_scale
        assert pstep.step_count == jstep.step_count
        jstep.sync_params()
        want = _arrays(jnet)
        for n, p in pnet.collect_params().items():
            np.testing.assert_allclose(p.data().asnumpy(), want[n],
                                       rtol=1e-6, atol=1e-6, err_msg=n)
    return jl, pl


def _close_losses(pl, jl):
    fin = np.isfinite(jl)
    np.testing.assert_array_equal(np.isfinite(pl), fin)
    np.testing.assert_allclose(np.asarray(pl)[fin], np.asarray(jl)[fin],
                               rtol=1e-5)


def test_static_scale_matches_unscaled():
    """In float32, scaling the loss up and the gradients back down is a
    no-op, in both packages."""
    x, y = _batch()
    _, (_, plain) = _dense_pair()
    ref = [float(plain(torch.from_numpy(x), torch.from_numpy(y)))
           for _ in range(5)]
    pair = _dense_pair(loss_scale=1024.0)
    jl, pl = _run(pair, [x] * 5, y)
    _close_losses(pl, jl)
    np.testing.assert_allclose(pl, ref, rtol=1e-5)
    assert pair[1][1].loss_scale == 1024.0
    assert _dense_pair()[1][1].loss_scale is None


SEQUENCES = {
    # no overflow: the scale stays at 2^16 and the loss falls
    "trains_and_reports": (2000, "cccccc"),
    # an overflow halves the scale and skips the update
    "skips_overflow_and_halves": (2000, "cicc"),
    # three clean steps double it; overflows in a row keep halving
    "grows_after_window": (3, "cccciicccc"),
}


@pytest.mark.parametrize("case", sorted(SEQUENCES))
def test_dynamic_scale_sequence_matches_reference(case):
    window, seq = SEQUENCES[case]
    x, y = _batch()
    pair = _dense_pair(loss_scale="dynamic", scale_window=window)
    _, pstep = pair[1]
    pnet = pair[1][0]
    xs = [INF if c == "i" else x for c in seq]
    snapshots = []
    for i in range(len(xs)):
        snapshots.append(([p.detach().clone() for p in pnet.parameters()],
                          [[s.clone() for s in st] for st in pstep._states]))
        jl, pl = _run(pair, [xs[i]], y)
        _close_losses(pl, jl)
        if seq[i] == "i":   # the skipped step left every tensor bitwise
            before, states = snapshots[-1]
            for a, b in zip(pnet.parameters(), before):
                assert torch.equal(a.detach(), b)
            for st, old in zip(pstep._states, states):
                for a, b in zip(st, old):
                    assert torch.equal(a, b)
    if case == "trains_and_reports":
        assert pstep.loss_scale == 2.0 ** 16
    elif case == "skips_overflow_and_halves":
        assert pstep.loss_scale == 2.0 ** 15
    else:
        assert pstep.step_count == len(seq)


@pytest.mark.parametrize("start,batch,want", [
    ((2.0 ** 24, 2), "clean", 2.0 ** 24),   # growth capped at 2^24
    ((1.0, 0), "inf", 1.0),                  # backoff floored at 1.0
    ((2.0 ** 127, 0), "big", 2.0 ** 126),    # the scaled loss is inf
])
def test_scale_cap_and_floor(start, batch, want):
    x, y = _batch()
    pair = _dense_pair(loss_scale="dynamic", scale_window=3)
    (_, jstep), (_, pstep) = pair
    jstep._scale_state = (jnp.asarray(start[0], jnp.float32),
                          jnp.asarray(start[1], jnp.int32))
    pstep._scale_state = (torch.tensor(start[0]),
                          torch.tensor(start[1], dtype=torch.int32))
    if batch == "big":   # a loss above 2, so loss * 2^127 overflows
        jl, pl = _run(pair, [x], y * 10)
    else:
        jl, pl = _run(pair, [INF if batch == "inf" else x], y)
    _close_losses(pl, jl)
    assert pstep.loss_scale == want == jstep.loss_scale
    jl, pl = _run(pair, [x], y)   # training goes on from there
    _close_losses(pl, jl)
    assert np.isfinite(pl[0])


def test_overflow_does_not_poison_bn_stats():
    """An overflowing step also keeps BatchNorm's running statistics,
    which the train()-mode forward writes in place."""
    x, y = _batch()
    pair = _dense_pair(loss_scale="dynamic", bn=True, lr=0.01)
    pnet = pair[1][0]
    jl, pl = _run(pair, [x], y)
    mean_p = pnet[1].running_mean
    before = mean_p.detach().clone()
    jl, pl = _run(pair, [INF], y)
    assert torch.equal(mean_p.detach(), before)
    jl, pl = _run(pair, [x], y)
    _close_losses(pl, jl)
    assert torch.isfinite(mean_p).all()
    assert not torch.equal(mean_p.detach(), before)


def test_no_amp_checkpoint_into_dynamic_step(tmp_path):
    """A checkpoint without loss scaling restored into a dynamic step
    keeps its initial 2^16 (not a placeholder)."""
    x, y = [torch.from_numpy(a) for a in _batch()]
    _, (_, plain) = _dense_pair()
    plain(x, y)
    ck = TrainCheckpoint(str(tmp_path))
    ck.save(1, plain, wait=True)
    _, (_, dyn) = _dense_pair(loss_scale="dynamic")
    ck.restore(dyn)
    assert dyn.loss_scale == 2.0 ** 16
    assert dyn.step_count == 1
    assert np.isfinite(float(dyn(x, y)))
    ck.close()


def test_dynamic_scale_checkpoint_roundtrip(tmp_path):
    x, y = [torch.from_numpy(a) for a in _batch()]
    _, (_, step) = _dense_pair(loss_scale="dynamic")
    step(x, y)
    step(torch.from_numpy(INF), y)
    assert step.loss_scale == 2.0 ** 15
    ck = TrainCheckpoint(str(tmp_path))
    ck.save(2, step, wait=True)
    step(x, y)
    ck.restore(step)
    assert step.loss_scale == 2.0 ** 15
    assert step.step_count == 2
    ck.close()


def test_bf16_params_get_f32_master_updates():
    """bfloat16 weights under the step's Adam keep learning when single
    updates are below bfloat16's resolution: the float32 masters
    accumulate them (the reference's mp_* state layout)."""
    jnet = jnn.Dense(8, in_units=8, dtype="bfloat16")
    jmx.rng.seed(0)
    jnet.initialize(jmx.init.Normal(0.5))
    jnet.cast("bfloat16")
    pnet = pnn.Dense(8, in_units=8)
    pnet.initialize(ctx=CPU)
    pnet.cast("bfloat16")
    models.load_gluon_params(
        pnet, {n: p.data()._data.astype(jnp.float32)
               for n, p in jnet.collect_params().items()}, ctx=CPU)
    r = np.random.default_rng(0)
    x = r.standard_normal((16, 8)).astype(np.float32)
    y = r.standard_normal((16, 8)).astype(np.float32)
    jstep = jpar.TrainStep(jnet, jloss.L2Loss(),
                           jopt.Adam(learning_rate=3e-4), mesh=None)
    step = TrainStep(pnet, ploss.L2Loss(), Adam(learning_rate=3e-4))
    jst = next(s for s, tr in zip(jstep._opt_states, jstep._trainable) if tr)
    assert len(step._states[0]) == len(jst) == 3
    assert step._states[0][0].dtype == torch.float32
    xb, yb = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, y))
    first = float(step(xb, yb))
    jfirst = float(jstep(jmx.nd.array(x, dtype="bfloat16"),
                         jmx.nd.array(y, dtype="bfloat16")).asscalar())
    np.testing.assert_allclose(first, jfirst, rtol=1e-2)
    for _ in range(300):
        last = float(step(xb, yb))
    assert last < first * 0.85, (first, last)


def test_eval_step_is_the_eval_forward():
    (jnet, _), (pnet, _) = _dense_pair(bn=True)
    x, _ = _batch(3)
    got = EvalStep(pnet)(torch.from_numpy(x))
    want = jpar.EvalStep(jnet)(jmx.nd.array(x)).asnumpy()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    nd = EvalStep(pnet)(mx.nd.array(x, ctx=CPU))
    np.testing.assert_array_equal(nd.asnumpy(), got.numpy())
