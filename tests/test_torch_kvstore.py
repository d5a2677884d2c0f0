"""mx.kv / mx.kvstore over torch.distributed against the JAX package.

Single-process stores ("local", "device", "nccl") hold the reference's
push / pull / pushpull / updater semantics on the same values; the
worker-group store ("dist_sync") runs as two gloo processes through the
unchanged tools/launch.py (the reference's DMLC_* env contract): the
aggregate of known constants, the 2-bit and int8 compressed allreduce,
and a gluon Trainer(kvstore="dist_sync") step on each worker's half of
a batch equal to one process's step on the whole batch.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as jmx  # noqa: E402

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import MXNetError  # noqa: E402
from mxnet_tpu_torch import kvstore as kvs  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _nd(a):
    return mx.nd.array(a, ctx=mx.cpu())


@pytest.mark.parametrize("kind", ["local", "device", "nccl"])
def test_single_process_store_matches_jax(kind):
    kv, jkv = mx.kv.create(kind), jmx.kv.create(kind)
    assert kv.type == kind and kv.rank == 0 and kv.num_workers == 1
    r = np.random.default_rng(0)
    a = r.standard_normal((2, 3)).astype(np.float32)
    b = r.standard_normal((3,)).astype(np.float32)
    kv.init(["a", "b"], [_nd(a), _nd(b)])
    jkv.init(["a", "b"], [jmx.nd.array(a), jmx.nd.array(b)])
    pushes = [r.standard_normal((2, 3)).astype(np.float32) for _ in range(3)]
    kv.push("a", [_nd(p) for p in pushes])
    jkv.push("a", [jmx.nd.array(p) for p in pushes])
    out, jout = _nd(np.zeros((2, 3))), jmx.nd.zeros((2, 3))
    kv.pull("a", out=out)
    jkv.pull("a", out=jout)
    np.testing.assert_allclose(out.asnumpy(), jout.asnumpy(), rtol=1e-6)
    g = _nd(b * 3)
    kv.pushpull("b", g)                      # out defaults to the value
    jg = jmx.nd.array(b * 3)
    jkv.pushpull("b", jg)
    np.testing.assert_array_equal(g.asnumpy(), jg.asnumpy())
    ob, job = _nd(np.zeros(3)), jmx.nd.zeros((3,))
    kv.pull("b", out=ob)
    jkv.pull("b", out=job)
    np.testing.assert_array_equal(ob.asnumpy(), job.asnumpy())

    def upd(key, inp, stored):
        stored._rebind(stored._data + 2 * inp._data)

    def jupd(key, inp, stored):
        stored._rebind(stored._data + 2 * inp._data)

    kv.set_updater(upd)
    jkv.set_updater(jupd)
    kv.push("b", _nd(np.ones(3, np.float32)))
    jkv.push("b", jmx.nd.ones((3,)))
    kv.pull("b", out=ob)
    jkv.pull("b", out=job)
    np.testing.assert_allclose(ob.asnumpy(), job.asnumpy(), rtol=1e-6)
    with pytest.raises(MXNetError, match="not initialized"):
        kv.push("zz", _nd(np.ones(3)))


def test_refusals_and_the_namespace(monkeypatch):
    assert mx.kv is mx.kvstore is kvs
    with pytest.raises(MXNetError, match="dist_async"):
        mx.kv.create("dist_async")
    with pytest.raises(MXNetError, match="unknown kvstore"):
        mx.kv.create("bogus")
    with pytest.raises(MXNetError, match="sparse"):
        mx.kv.create("local").row_sparse_pull("x")
    # no coordinator in the env: no group, one worker
    for k in ("DMLC_PS_ROOT_URI", "DMLC_PS_ROOT_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert kvs.init_distributed() == (0, 1)
    store = mx.kv.create("dist_sync")
    assert store.num_workers == 1 and not store._group
    # a group that cannot form raises, naming its backend; nothing falls
    # back to another backend
    import torch.distributed as dist

    def refuse(**kw):
        raise RuntimeError("NCCL unavailable")

    monkeypatch.setattr(dist, "init_process_group", refuse)
    with pytest.raises(MXNetError, match="nccl worker group"):
        kvs.init_distributed("127.0.0.1:1", 1, 0, backend="nccl")


def test_trainer_accepts_every_store():
    from mxnet_tpu_torch import gluon
    net = gluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=mx.cpu())
    for kind in (None, "device", "local", "nccl", "dist_sync"):
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1}, kvstore=kind,
                           compression_params={"type": "2bit",
                                               "threshold": 0.5}
                           if kind == "dist_sync" else None)
        tr.allreduce_grads()          # one process: nothing to reduce
        assert tr._kvstore is None
    tr = gluon.Trainer(net.collect_params(), "sgd", kvstore="dist_async")
    with pytest.raises(MXNetError, match="dist_async"):
        tr.allreduce_grads()


_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    sys.path.insert(0, {repo!r})
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon

    cpu = mx.cpu()
    kv = mx.kv.create("dist_sync")
    rank, size = kv.rank, kv.num_workers
    assert size == 2 and kv._group, (size, kv._group)
    kv.init("w", mx.nd.ones((4,), ctx=cpu) * (10 + rank))
    out = mx.nd.zeros((4,), ctx=cpu)
    kv.pull("w", out=out)
    np.testing.assert_array_equal(out.asnumpy(), 10)   # rank 0's value
    kv.push("w", mx.nd.ones((4,), ctx=cpu) * (rank + 1))
    kv.pull("w", out=out)
    np.testing.assert_array_equal(out.asnumpy(), 3)
    res = mx.nd.zeros((4,), ctx=cpu)
    kv.pushpull("w", mx.nd.ones((4,), ctx=cpu) * (rank + 1), out=res)
    np.testing.assert_array_equal(res.asnumpy(), 3)

    # compressed allreduce: the sum of each worker's decompressed payload
    r = np.random.default_rng(rank)
    for ctype, kw in (("2bit", {{"threshold": 0.5}}), ("int8", {{"block": 8}})):
        ckv = mx.kv.create("dist_sync")
        ckv.set_gradient_compression(dict(type=ctype, **kw))
        g = r.standard_normal(40).astype(np.float32)
        ckv.init("g", mx.nd.zeros((40,), ctx=cpu))
        got = mx.nd.zeros((40,), ctx=cpu)
        ckv.pushpull("g", mx.nd.array(g, ctx=cpu), out=got)
        mine = ckv._compressor.decompress(
            type(ckv._compressor)(**kw).compress("g", torch.from_numpy(g)),
            (40,)).numpy()
        both = np.zeros((2, 40), np.float32)
        both[rank] = mine
        t = torch.from_numpy(both)
        torch.distributed.all_reduce(t)
        np.testing.assert_array_equal(got.asnumpy(), t.sum(0).numpy())

    # Trainer(kvstore="dist_sync"): each worker steps on its half of the
    # batch; the allreduced step equals one process's step on all of it
    data = np.random.default_rng(7)
    X = data.standard_normal((8, 3)).astype(np.float32)
    Y = data.standard_normal((8, 2)).astype(np.float32)
    w0 = data.standard_normal((2, 3)).astype(np.float32)

    def step(rows, kvstore):
        net = gluon.nn.Dense(2, in_units=3, use_bias=False)
        net.initialize(ctx=cpu)
        weight = net.collect_params()["weight"]
        weight.set_data(mx.nd.array(w0, ctx=cpu))
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {{"learning_rate": 0.1}}, kvstore=kvstore)
        with autograd.record():
            loss = gluon.loss.L2Loss()(net(mx.nd.array(X[rows], ctx=cpu)),
                                       mx.nd.array(Y[rows], ctx=cpu))
        loss.backward()
        tr.step(8)
        return weight.data().asnumpy()

    half = slice(rank * 4, rank * 4 + 4)
    np.testing.assert_allclose(step(half, "dist_sync"),
                               step(slice(0, 8), "device"), rtol=1e-6,
                               atol=1e-7)
    print("WORKER_OK", rank, flush=True)
""")


def test_dist_sync_two_gloo_processes_through_the_launcher(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER.format(repo=REPO))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("DMLC_", "XLA_", "JAX_"))}
    env["CUDA_VISIBLE_DEVICES"] = ""
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "launch.py"), "-n",
         "2", sys.executable, str(worker)],
        capture_output=True, text=True, env=env, timeout=60)
    assert r.returncode == 0, (r.stdout, r.stderr[-3000:])
    assert r.stdout.count("WORKER_OK") == 2, (r.stdout, r.stderr[-3000:])
