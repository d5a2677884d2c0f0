"""The port's TrainCheckpoint: asynchronous, atomic, resume-exact.

* the cases of tests/test_checkpoint.py but the sharded one: N steps,
  a save, a diverging step, a restore and M more steps equal the
  uninterrupted N + M steps bit for bit (parameters, optimizer states,
  the step count and the dropout seed, dropout 0.1); async saves with
  retention; restoring from an empty directory raises;
* the port's resumed losses against the JAX package's resumed run from
  the same weights (dropout 0), within 1e-5;
* a save that does not finish leaves latest_step at the step before;
* SIGTERM in a training process: the handler saves, then re-raises (the
  process dies of the signal); a second process resumes exactly;
* a signal that lands inside a step's in-place update saves once the
  step has returned: the checkpoint is the state at a step boundary.
"""
import os
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu import optimizer as jopt, parallel as jpar  # noqa: E402
from mxnet_tpu.checkpoint import TrainCheckpoint as JaxCheckpoint  # noqa: E402
from mxnet_tpu.gluon import loss as jloss, nn as jnn  # noqa: E402

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import MXNetError, checkpoint, models, rng  # noqa: E402
from mxnet_tpu_torch.checkpoint import TrainCheckpoint  # noqa: E402
from mxnet_tpu_torch.gluon import loss as ploss, nn as pnn  # noqa: E402
from mxnet_tpu_torch.optimizer import Adam  # noqa: E402
from mxnet_tpu_torch.parallel import TrainStep  # noqa: E402

CPU = mx.cpu()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mk_step(dropout=0.1, seed=7, arrays=None):
    net = pnn.HybridSequential()
    net.add(pnn.Dense(16, in_units=8))
    net.add(pnn.Dropout(dropout))
    net.add(pnn.Dense(4, in_units=16))
    mx.random.seed(42)
    net.initialize(mx.init.Normal(0.1), ctx=CPU)
    if arrays is not None:
        models.load_gluon_params(net, arrays, ctx=CPU)
    rng.seed(seed)
    return net, TrainStep(net, ploss.SoftmaxCrossEntropyLoss(),
                          Adam(learning_rate=1e-2))


def _batch(seed=0):
    r = np.random.default_rng(seed)
    return (torch.from_numpy(r.standard_normal((8, 8)).astype(np.float32)),
            torch.from_numpy(r.integers(0, 4, (8,)).astype(np.int32)))


def _state(net, step):
    return ([p.detach().clone() for p in net.parameters()],
            [[s.clone() for s in st] for st in step._states])


def _assert_same_state(a, b):
    for x, y in zip(a[0], b[0]):
        assert torch.equal(x, y)
    for xs, ys in zip(a[1], b[1]):
        for x, y in zip(xs, ys):
            assert torch.equal(x, y)


def test_resume_exact(tmp_path):
    x, y = _batch()
    net_ref, step_ref = _mk_step()
    ref = [float(step_ref(x, y)) for _ in range(8)]

    net, step = _mk_step()
    for _ in range(4):
        step(x, y)
    ck = TrainCheckpoint(str(tmp_path / "ckpt"))
    ck.save(4, step, data_cursor={"epoch": 2, "batch": 17}, wait=True)
    step(x, y)   # diverge after the snapshot
    assert ck.restore(step) == {"epoch": 2, "batch": 17}
    assert step.step_count == 4
    resumed = [float(step(x, y)) for _ in range(4)]
    assert resumed == ref[4:]
    _assert_same_state(_state(net, step), _state(net_ref, step_ref))
    # a fresh net and step from other weights and another seed
    net2, step2 = _mk_step(seed=99)
    with torch.no_grad():
        for p in net2.parameters():
            p.mul_(3.0)
    assert ck.restore(step2, step=4) == {"epoch": 2, "batch": 17}
    assert [float(step2(x, y)) for _ in range(4)] == ref[4:]
    ck.close()


def test_async_save_multiple_and_retention(tmp_path):
    x, y = _batch(1)
    _, step = _mk_step(dropout=0.0)
    ck = TrainCheckpoint(str(tmp_path / "c"), max_to_keep=2)
    for s in range(1, 5):
        step(x, y)
        ck.save(s, step)   # returns once the host copy is taken
        assert ck.last_save["bytes"] > 0
    ck.wait_until_finished()
    assert ck.latest_step() == 4
    assert ck.all_steps() == [3, 4]
    assert ck.last_save["durable_s"] >= ck.last_save["blocking_s"]
    ck.close()


def test_restore_missing_raises(tmp_path):
    _, step = _mk_step(dropout=0.0)
    ck = TrainCheckpoint(str(tmp_path / "empty"))
    with pytest.raises(MXNetError, match="no checkpoint"):
        ck.restore(step)
    ck.close()


def test_unfinished_save_leaves_the_step_before(tmp_path, monkeypatch):
    x, y = _batch(2)
    _, step = _mk_step(dropout=0.0)
    d = str(tmp_path / "u")
    ck = TrainCheckpoint(d)
    step(x, y)
    ck.save(1, step, wait=True)
    step(x, y)
    real = checkpoint.save_ndarray_dict

    def dies_midway(f, arrays):
        f.write(b"PK\x03\x04 half a zip")
        raise OSError("disk went away")

    monkeypatch.setattr(checkpoint, "save_ndarray_dict", dies_midway)
    ck.save(2, step)
    with pytest.raises(OSError, match="went away"):
        ck.wait_until_finished()
    assert ck.latest_step() == 1 and ck.all_steps() == [1]
    monkeypatch.setattr(checkpoint, "save_ndarray_dict", real)
    again = TrainCheckpoint(d)   # clears the half-written step
    assert sorted(os.listdir(d)) == ["1"]
    _, fresh = _mk_step(dropout=0.0, seed=3)
    again.restore(fresh)
    assert fresh.step_count == 1
    again.close()


def _jax_step():
    jnet = jnn.HybridSequential()
    jnet.add(jnn.Dense(16, in_units=8))
    jnet.add(jnn.Dropout(0.0))
    jnet.add(jnn.Dense(4, in_units=16))
    jmx.rng.seed(42)
    jnet.initialize(jmx.init.Normal(0.1))
    return jnet, jpar.TrainStep(jnet, jloss.SoftmaxCrossEntropyLoss(),
                                jopt.Adam(learning_rate=1e-2), mesh=None)


def test_resumed_losses_match_the_reference(tmp_path):
    x, y = _batch(3)
    jnet, jstep = _jax_step()
    arrays = {n: np.array(p.data().asnumpy())
              for n, p in jnet.collect_params().items()}
    jx, jy = jmx.nd.array(x.numpy()), jmx.nd.array(y.numpy(), dtype="int32")
    for _ in range(3):
        jstep(jx, jy)
    jck = JaxCheckpoint(str(tmp_path / "jax"))
    jck.save(3, jstep, wait=True)
    jstep(jx, jy)
    jck.restore(jstep)
    want = [float(jstep(jx, jy).asscalar()) for _ in range(3)]
    jck.close()

    _, step = _mk_step(dropout=0.0, arrays=arrays)
    for _ in range(3):
        step(x, y)
    ck = TrainCheckpoint(str(tmp_path / "port"))
    ck.save(3, step, wait=True)
    step(x, y)
    ck.restore(step)
    got = [float(step(x, y)) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    ck.close()


_TRAIN = textwrap.dedent("""
    import os, signal, sys, json
    import numpy as np, torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import rng
    from mxnet_tpu_torch.checkpoint import (TrainCheckpoint,
                                            install_preemption_handler)
    from mxnet_tpu_torch.gluon import loss, nn
    from mxnet_tpu_torch.optimizer import Adam
    from mxnet_tpu_torch.parallel import TrainStep
    mode, d = sys.argv[1], sys.argv[2]
    net = nn.HybridSequential()
    net.add(nn.Dense(16, in_units=8))
    net.add(nn.Dropout(0.1))
    net.add(nn.Dense(4, in_units=16))
    mx.random.seed(42)
    net.initialize(mx.init.Normal(0.1), ctx=mx.cpu())
    rng.seed(7 if mode != "resume" else 11)
    step = TrainStep(net, loss.SoftmaxCrossEntropyLoss(),
                     Adam(learning_rate=1e-2))
    r = np.random.default_rng(0)
    xs = torch.from_numpy(r.standard_normal((6, 8, 8)).astype(np.float32))
    ys = torch.from_numpy(r.integers(0, 4, (6, 8)).astype(np.int32))
    ck = TrainCheckpoint(d)
    if mode == "train":
        install_preemption_handler(ck, step, lambda: step.step_count,
                                   lambda: {"batch": step.step_count})
        for i in range(6):
            print(float(step(xs[i], ys[i])), flush=True)
            if i == 2:
                os.kill(os.getpid(), signal.SIGTERM)
        print("not preempted", flush=True)
    else:
        start = 0
        if mode == "resume":
            start = ck.restore(step)["batch"]
            assert step.step_count == start == 3
        for i in range(start, 6):
            print(float(step(xs[i], ys[i])), flush=True)
    ck.close()
""")


def test_sigterm_saves_then_reraises_and_a_new_process_resumes(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")

    def run(mode, d):
        return subprocess.run([sys.executable, "-c", _TRAIN, mode, str(d)],
                              capture_output=True, text=True, env=env,
                              cwd=ROOT, timeout=120)

    first = run("train", tmp_path / "p")
    assert first.returncode == -signal.SIGTERM, first.stderr
    assert "not preempted" not in first.stdout
    assert os.listdir(tmp_path / "p") == ["3"]
    second = run("resume", tmp_path / "p")
    assert second.returncode == 0, second.stderr
    whole = run("whole", tmp_path / "w")
    assert whole.returncode == 0, whole.stderr
    ref = whole.stdout.split()
    assert first.stdout.split() == ref[:3]
    assert second.stdout.split() == ref[3:]


def test_signal_inside_the_update_saves_at_the_step_boundary(tmp_path,
                                                             monkeypatch):
    x, y = _batch(4)
    net_ref, step_ref = _mk_step()
    for _ in range(3):
        step_ref(x, y)
    net, step = _mk_step()
    for _ in range(2):
        step(x, y)
    ck = TrainCheckpoint(str(tmp_path / "mid"))
    sig = signal.SIGUSR1
    delivered, saved_mid_step = [], []
    prev = signal.signal(sig, lambda s, f: delivered.append(s))
    try:
        checkpoint.install_preemption_handler(
            ck, step, lambda: step.step_count,
            lambda: {"batch": step.step_count}, signals=[sig])
        real, calls = step.optimizer.apply_arrays_mp, []

        def signalled(*args):
            # the signal lands on the second of the four parameters
            calls.append(1)
            if len(calls) == 2:
                signal.raise_signal(sig)
                saved_mid_step.append(ck.all_steps())
            return real(*args)

        monkeypatch.setattr(step.optimizer, "apply_arrays_mp", signalled)
        step(x, y)
    finally:
        signal.signal(sig, prev)
    assert len(calls) == 4 and saved_mid_step == [[]]
    assert delivered == [sig]            # re-raised to the previous handler
    assert ck.all_steps() == [3]
    _, fresh = _mk_step(seed=99)
    assert ck.restore(fresh) == {"batch": 3}
    assert fresh.step_count == 3 and fresh._seed == step_ref._seed
    _assert_same_state(_state(fresh.net, fresh), _state(net_ref, step_ref))
    ck.close()
