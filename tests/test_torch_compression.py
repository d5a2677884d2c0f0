"""Gradient compression against the JAX package: the 2-bit and blockwise
int8 codecs (payload bytes equal, error feedback), the in-step
`compressed_psum_mean` over the dp shards, and TrainStep(compression=
"2bit") on a dp mesh (conftest's virtual CPU devices for the JAX side,
`["cpu"] * 4` for the port), its residuals carried by TrainCheckpoint.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu import gradient_compression as jgc  # noqa: E402
from mxnet_tpu import optimizer as jopt  # noqa: E402
from mxnet_tpu import parallel as jpar  # noqa: E402
from mxnet_tpu.gluon import loss as jloss  # noqa: E402
from mxnet_tpu.gluon import nn as jnn  # noqa: E402
from mxnet_tpu.parallel import compression as jcomp  # noqa: E402

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import MXNetError  # noqa: E402
from mxnet_tpu_torch import gradient_compression as gc  # noqa: E402
from mxnet_tpu_torch import optimizer as opt  # noqa: E402
from mxnet_tpu_torch import parallel as par  # noqa: E402
from mxnet_tpu_torch.checkpoint import TrainCheckpoint  # noqa: E402
from mxnet_tpu_torch.gluon import loss as gloss  # noqa: E402
from mxnet_tpu_torch.gluon import nn  # noqa: E402
from mxnet_tpu_torch.models import load_gluon_params  # noqa: E402
from mxnet_tpu_torch.parallel import compression as comp  # noqa: E402

DP = 4


def _bytes(a):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    return a.tobytes()


@pytest.mark.parametrize("codec,kw", [("2bit", {"threshold": 0.4}),
                                      ("2bit", {"threshold": 1.5}),
                                      ("int8", {"block": 256}),
                                      ("int8", {"block": 7})])
@pytest.mark.parametrize("n", [1, 37, 1000])
def test_payloads_byte_equal_to_jax(codec, kw, n):
    """Three calls on one key (the residual fed back each time): every
    payload the reference's bytes, its size wire_bytes(shape), and the
    decompressed value and residual equal."""
    make, jmake = (gc.TwoBitCompressor, jgc.TwoBitCompressor) \
        if codec == "2bit" else (gc.Int8BlockCompressor,
                                 jgc.Int8BlockCompressor)
    c, jc = make(**kw), jmake(**kw)
    r = np.random.default_rng(n)
    shape = (n,) if n < 100 else (25, 40)
    for i in range(3):
        g = (r.standard_normal(shape) * (1.0 + i)).astype(np.float32)
        got = c.compress("k", torch.from_numpy(g))
        want = jc.compress("k", jnp.asarray(g))
        assert _bytes(got) == _bytes(want)
        assert got.numel() * got.element_size() == c.wire_bytes(shape) \
            == jc.wire_bytes(shape)
        np.testing.assert_array_equal(
            c.decompress(got, shape).numpy(),
            np.asarray(jc.decompress(want, shape)))
        np.testing.assert_array_equal(c._residual["k"].numpy(),
                                      np.asarray(jc._residual["k"]))


def test_codec_validation_and_kvstore_setting():
    with pytest.raises(MXNetError):
        gc.TwoBitCompressor(threshold=0.0)
    with pytest.raises(MXNetError):
        gc.Int8BlockCompressor(block=0)
    store = mx.kv.create("local")
    with pytest.raises(MXNetError, match="2bit"):
        store.set_gradient_compression({"type": "1bit"})
    with pytest.raises(MXNetError, match="type"):
        store.set_gradient_compression({"threshold": 0.5})
    with pytest.warns(UserWarning, match="single-process"):
        store.set_gradient_compression({"type": "int8", "block": 64})


def test_compressed_psum_mean_matches_jax():
    """Per-shard quantize, gather of the packed words, mean: the reduced
    gradient and each shard's new residual equal the reference's
    shard_map, and the gather moves 1/16 of float32's bytes."""
    from mxnet_tpu.parallel.mesh import PartitionSpec as JP
    from mxnet_tpu.parallel.mesh import shard_map_compat
    from mxnet_tpu_torch.parallel import collectives
    r = np.random.default_rng(1)
    g = r.standard_normal((DP, 40)).astype(np.float32)
    res = (r.standard_normal((DP, 40)) * 0.1).astype(np.float32)

    def local(g, r):
        red, nr = jcomp.compressed_psum_mean(g[0], r[0], "dp", 0.5)
        return red[None], nr[None]

    fn = shard_map_compat(
        local, mesh=jpar.make_mesh({"dp": DP}, devices=jax.devices()[:DP]),
        in_specs=(JP("dp"), JP("dp")), out_specs=(JP("dp"), JP("dp")),
        check_rep=False)
    want_red, want_res = (np.asarray(x) for x in fn(jnp.asarray(g),
                                                     jnp.asarray(res)))
    with collectives.recording() as rec:
        red, new = comp.compressed_psum_mean(
            [torch.from_numpy(x) for x in g],
            [torch.from_numpy(x) for x in res], 0.5)
    for i in range(DP):
        np.testing.assert_array_equal(red[i].numpy(), want_red[i])
        np.testing.assert_array_equal(new[i].numpy(), want_res[i])
    assert rec == [{"kind": "all_gather", "bytes": DP * 3 * 4,
                    "group": DP}]
    w = comp.quantize_2bit(torch.from_numpy(g[0]), 0.5)
    assert _bytes(w) == _bytes(jcomp.quantize_2bit(jnp.asarray(g[0]), 0.5))


def _pair(seed, threshold, compression="2bit"):
    jnet = jnn.Dense(4, in_units=8)
    jmx.rng.seed(seed)
    jnet.initialize(jmx.init.Normal(0.2))
    arrays = {n: p.data().asnumpy()
              for n, p in jnet.collect_params().items()}
    net = load_gluon_params(nn.Dense(4, in_units=8), arrays, ctx=mx.cpu())
    jstep = jpar.TrainStep(
        jnet, jloss.L2Loss(), jopt.SGD(learning_rate=0.05),
        mesh=jpar.make_mesh({"dp": DP}, devices=jax.devices()[:DP]),
        compression=compression, compression_threshold=threshold)
    step = par.TrainStep(
        net, gloss.L2Loss(), opt.SGD(learning_rate=0.05),
        mesh=par.make_mesh(dp=DP, devices=["cpu"] * DP),
        compression=compression, compression_threshold=threshold)
    return jnet, jstep, net, step


def _regression(seed=2):
    r = np.random.default_rng(seed)
    x = r.standard_normal((16, 8)).astype(np.float32)
    return x, (x @ r.standard_normal((8, 4))).astype(np.float32)


def test_trainstep_2bit_matches_jax_step_for_step():
    """The compressed step's losses, weights and per-shard residuals
    equal the reference's shard_map step for 6 steps; the wire is the
    all_gather of packed words."""
    x, y = _regression()
    jnet, jstep, net, step = _pair(5, 0.1)
    for _ in range(6):
        want = float(jstep(jmx.nd.array(x), jmx.nd.array(y)).asscalar())
        got = float(step(torch.from_numpy(x), torch.from_numpy(y)))
        np.testing.assert_allclose(got, want, rtol=1e-5)
    jstep.sync_params()
    for n, p in jnet.collect_params().items():
        np.testing.assert_allclose(net.collect_params()[n].data().asnumpy(),
                                   p.data().asnumpy(), rtol=1e-4, atol=1e-5)
    for a, b in zip(step._residuals, jstep._residuals):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)
    gathers = [r for r in step.last_collectives if r["kind"] == "all_gather"]
    assert sorted(r["bytes"] for r in gathers) == [DP * 4, DP * 4 * 2]
    assert not [r for r in step.last_collectives
                if r["kind"] == "all_reduce" and r["bytes"] >= 16 * 4]


def test_trainstep_2bit_converges_near_uncompressed():
    """The reference test's band (test_inprogram_compression.py:77):
    error feedback takes the compressed loss below a fifth of its start,
    and the uncompressed run ends at least as low (within 1e-3)."""
    x, y = _regression()
    _, _, net_c, step_c = _pair(5, 0.1)
    _, _, net_u, step_u = _pair(5, 0.1, compression=None)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    losses_c = step_c.run_steps(xt, yt, steps=400).tolist()
    losses_u = step_u.run_steps(xt, yt, steps=400).tolist()
    assert losses_c[-1] < losses_c[0] * 0.2, losses_c[::80]
    assert losses_u[-1] < losses_c[-1] + 1e-3


def test_compressed_checkpoint_roundtrips_residuals(tmp_path):
    x, y = _regression(4)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    _, _, net, step = _pair(2, 0.1)
    for _ in range(4):
        step(xt, yt)
    ck = TrainCheckpoint(str(tmp_path / "ck"), async_save=False)
    ck.save(4, step, wait=True)
    before = [r.clone() for r in step._residuals]
    assert any(float(b.abs().sum()) > 0 for b in before)
    assert before[0].shape == (DP, 4, 8)      # one residual a dp shard
    after_4 = [float(step(xt, yt)) for _ in range(2)]
    ck.restore(step)
    for b, a in zip(before, step._residuals):
        assert torch.equal(a, b)
    assert [float(step(xt, yt)) for _ in range(2)] == after_4
    ck.close()


def test_compression_validation():
    net = nn.Dense(2, in_units=2)
    net.initialize(ctx=mx.cpu())
    with pytest.raises(MXNetError, match="dp axis"):
        par.TrainStep(net, gloss.L2Loss(), opt.SGD(), mesh=None,
                      compression="2bit")
    with pytest.raises(MXNetError, match="unknown compression"):
        par.TrainStep(net, gloss.L2Loss(), opt.SGD(),
                      mesh=par.make_mesh(dp=2, devices=["cpu"] * 2),
                      compression="1bit")
    with pytest.raises(MXNetError, match="pure data parallelism"):
        par.TrainStep(net, gloss.L2Loss(), opt.SGD(),
                      mesh=par.make_mesh(dp=2, tp=2, devices=["cpu"] * 4),
                      compression="2bit")
