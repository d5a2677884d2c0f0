"""The port's mesh, sharding rules and mesh TrainStep / EvalStep against
the JAX package.

The JAX side runs on conftest's 8-device virtual CPU mesh; the port's on
`make_mesh(..., devices=["cpu"] * 8)`, which runs each batch shard in a
thread of its own and places the collectives itself (no GSPMD). The
same seeded weights cross over by name (models.load_gluon_params /
load_jax_params); losses are held at the JAX tests' rtol 1e-5 and
weights at 1e-4 / 1e-5. The last test is the slice as a whole:
`dryrun_multichip`'s BERT MLM step on a dp 2 x sp 2 x tp 2 mesh (tp
rules, Ulysses attention under sp) against the JAX step, two steps.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu import optimizer as jopt  # noqa: E402
from mxnet_tpu import parallel as jpar  # noqa: E402
from mxnet_tpu.gluon import loss as jloss  # noqa: E402
from mxnet_tpu.gluon import nn as jnn  # noqa: E402
from mxnet_tpu.parallel import PartitionSpec as JP  # noqa: E402

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import MXNetError  # noqa: E402
from mxnet_tpu_torch import optimizer as opt  # noqa: E402
from mxnet_tpu_torch import parallel as par  # noqa: E402
from mxnet_tpu_torch.gluon import loss as gloss  # noqa: E402
from mxnet_tpu_torch.gluon import nn  # noqa: E402
from mxnet_tpu_torch.models import load_gluon_params  # noqa: E402
from mxnet_tpu_torch.parallel import PartitionSpec as P  # noqa: E402

CPU8 = ["cpu"] * 8


def _jax_mlp(seed, bn=False):
    np.random.seed(seed)
    net = jnn.HybridSequential()
    net.add(jnn.Dense(32, activation="relu", in_units=16))
    if bn:
        net.add(jnn.BatchNorm(in_channels=32))
    net.add(jnn.Dense(4, in_units=32))
    jmx.rng.seed(seed)
    net.initialize(jmx.init.Xavier())
    return net


def _arrays(jnet):
    return {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}


def _port_mlp(arrays, bn=False):
    net = nn.HybridSequential()
    net.add(nn.Dense(32, activation="relu", in_units=16))
    if bn:
        net.add(nn.BatchNorm(in_channels=32))
    net.add(nn.Dense(4, in_units=32))
    return load_gluon_params(net, arrays, ctx=mx.cpu())


def _port_arrays(net):
    return {n: p.data().asnumpy() for n, p in net.collect_params().items()}


def _xy(seed, n):
    r = np.random.default_rng(seed)
    return (r.standard_normal((n, 16)).astype(np.float32),
            r.integers(0, 4, n).astype(np.int32))


def test_make_mesh_shapes_and_devices():
    m = par.make_mesh(dp=8, devices=CPU8)
    assert m.shape == {"dp": 8} and m.size == 8
    m2 = par.make_mesh(dp=-1, tp=2, devices=CPU8)
    assert m2.shape == jpar.make_mesh(dp=-1, tp=2).shape == {"dp": 4,
                                                              "tp": 2}
    m3 = par.make_mesh({"dp": 2, "sp": 2, "tp": 2}, devices=CPU8)
    assert m3.axis_names == ("dp", "sp", "tp")
    assert m3.device_list == [torch.device("cpu")] * 8
    assert par.axis_enabled(m3, "sp") and not par.axis_enabled(m3, "pp")
    with pytest.raises(MXNetError):
        par.make_mesh(dp=3, devices=CPU8)
    if not torch.cuda.is_available():
        # no card: the default device list raises, naming the repeated form
        with pytest.raises(MXNetError, match=r"\['cuda:0'\] \* N"):
            par.make_mesh(dp=2)
    assert par.current_mesh() is None
    with par.mesh_scope(m3):
        assert par.current_mesh() is m3
        assert par.named_sharding(P("tp")).spec == P("tp")
    assert par.current_mesh() is None
    with pytest.raises(MXNetError, match="no active mesh"):
        par.named_sharding(P())


def test_rule_specs_match_jax():
    """Every rule set gives each BERT / MoE parameter name the JAX
    package's spec."""
    from mxnet_tpu.models import BertConfig, BertForMaskedLM
    jnet = BertForMaskedLM(BertConfig(vocab_size=64, units=32,
                                      hidden_size=64, num_layers=2,
                                      num_heads=2, max_length=32))
    jnet.initialize()
    shapes = {n: tuple(p.shape) for n, p in jnet.collect_params().items()}
    shapes.update({"moe.expert_w1": (4, 8, 16), "moe.expert_b2": (4, 8),
                   "moe.gate.weight": (4, 8)})
    for mk in (lambda m: m.megatron_dense_rules(tp_axis="tp"),
               lambda m: m.megatron_dense_rules(fsdp_axis="fsdp"),
               lambda m: m.fsdp_rules(min_size=64),
               lambda m: m.ep_rules()):
        port, ref = mk(par), mk(jpar)
        for name, shape in shapes.items():
            a, b = port.spec_for(name, shape), ref.spec_for(name, shape)
            assert (a is None) == (b is None), name
            if a is not None:
                assert tuple(a) == tuple(b), name


@pytest.mark.parametrize("case", ["dp8_sgd", "dp4_tp2_adam",
                                  "dp4_tp2_lamb"])
def test_mesh_train_step_matches_jax(case):
    X, Y = _xy(2, 32)
    jnet = _jax_mlp(7)
    net = _port_mlp(_arrays(jnet))
    if case == "dp8_sgd":
        jo, o = (jopt.SGD(learning_rate=0.1, momentum=0.9),
                 opt.SGD(learning_rate=0.1, momentum=0.9))
        jmesh, mesh = jpar.make_mesh(dp=8), par.make_mesh(dp=8,
                                                           devices=CPU8)
    else:
        # LAMB's trust ratio is over the whole of a sharded parameter
        name = "Adam" if case == "dp4_tp2_adam" else "LAMB"
        jo = getattr(jopt, name)(learning_rate=0.01)
        o = getattr(opt, name)(learning_rate=0.01)
        jmesh = jpar.make_mesh(dp=4, tp=2)
        mesh = par.make_mesh(dp=4, tp=2, devices=CPU8)
        for params, spec in ((jnet.collect_params(), JP),
                             (net.collect_params(), P)):
            params["0.weight"].sharding = spec("tp", None)
            params["0.bias"].sharding = spec("tp")
            params["1.weight"].sharding = spec(None, "tp")
    jstep = jpar.TrainStep(jnet, jloss.SoftmaxCrossEntropyLoss(), jo,
                           mesh=jmesh, batch_specs=(JP("dp"), JP("dp")))
    step = par.TrainStep(net, gloss.SoftmaxCrossEntropyLoss(), o,
                         mesh=mesh, batch_specs=(P("dp"), P("dp")))
    for _ in range(3):
        want = float(jstep(jmx.nd.array(X),
                           jmx.nd.array(Y, dtype="int32")).asscalar())
        got = float(step(torch.from_numpy(X), torch.from_numpy(Y)))
        np.testing.assert_allclose(got, want, rtol=1e-5)
    jstep.sync_params()
    step.sync_params()
    want_w, got_w = _arrays(jnet), _port_arrays(net)
    for n in want_w:
        np.testing.assert_allclose(got_w[n], want_w[n], rtol=1e-4,
                                   atol=1e-5, err_msg=n)
    assert [tuple(s) for s in step.param_sharding_specs()] == \
        [tuple(s) for s in jstep.param_sharding_specs()]
    if case != "dp8_sgd":
        # a sharded parameter is stored over every mesh position
        mp = step.mesh_params[0]
        assert mp.sharded and len(mp.devices) == mesh.size == 8
        assert not step.mesh_params[3].sharded  # 1.bias: replicated
        kinds = {r["kind"] for r in step.last_collectives}
        assert {"all_gather", "reduce_scatter", "all_reduce"} <= kinds


def test_mesh_batch_norm_uses_global_batch_statistics():
    """A GSPMD step's BatchNorm sees the whole dp-sharded batch: the
    port's shards psum E[x] and E[x^2] inside the forward."""
    X, Y = _xy(3, 32)
    jnet = _jax_mlp(5, bn=True)
    net = _port_mlp(_arrays(jnet), bn=True)
    jstep = jpar.TrainStep(jnet, jloss.SoftmaxCrossEntropyLoss(),
                           jopt.SGD(learning_rate=0.1),
                           mesh=jpar.make_mesh(dp=4,
                                               devices=jax.devices()[:4]),
                           batch_specs=(JP("dp"), JP("dp")))
    step = par.TrainStep(net, gloss.SoftmaxCrossEntropyLoss(),
                         opt.SGD(learning_rate=0.1),
                         mesh=par.make_mesh(dp=4, devices=["cpu"] * 4),
                         batch_specs=(P("dp"), P("dp")))
    for _ in range(2):
        want = float(jstep(jmx.nd.array(X),
                           jmx.nd.array(Y, dtype="int32")).asscalar())
        got = float(step(torch.from_numpy(X), torch.from_numpy(Y)))
        np.testing.assert_allclose(got, want, rtol=1e-5)
    jstep.sync_params()
    want_w, got_w = _arrays(jnet), _port_arrays(net)
    for n in want_w:   # running statistics among them
        np.testing.assert_allclose(got_w[n], want_w[n], rtol=1e-4,
                                   atol=1e-5, err_msg=n)


class _FailOnce(nn.HybridBlock):
    """Raises in batch shard 1 while `armed` (a class attribute, shared
    with the step's replicas), before BatchNorm's collective, as a
    shard's out-of-memory error would."""
    armed = False

    def forward(self, x):
        ctx = par.mesh.shard_context()
        if _FailOnce.armed and ctx is not None and ctx.rank == 1:
            _FailOnce.armed = False
            raise RuntimeError("shard 1 failed")
        return x


def test_mesh_step_recovers_after_a_shard_fails():
    """A shard that raises releases its peers waiting at BatchNorm's
    collective; the error is raised, and the same step object then
    trains as one that never failed (to rounding: the shards' backward
    graphs, built on threads, may sum a gradient in another order)."""
    X, Y = _xy(3, 32)

    def make(arrays=None):
        net = nn.HybridSequential()
        net.add(nn.Dense(32, activation="relu", in_units=16), _FailOnce(),
                nn.BatchNorm(in_channels=32), nn.Dense(4, in_units=32))
        if arrays is not None:
            return load_gluon_params(net, arrays, ctx=mx.cpu())
        mx.random.seed(0)
        net.initialize(mx.init.Xavier(), ctx=mx.cpu())
        return net

    failing = make()
    clean = make(_port_arrays(failing))
    mesh = par.make_mesh(dp=4, devices=["cpu"] * 4)
    steps = [par.TrainStep(n, gloss.SoftmaxCrossEntropyLoss(),
                           opt.SGD(learning_rate=0.1), mesh=mesh,
                           batch_specs=(P("dp"), P("dp")))
             for n in (failing, clean)]
    x, y = torch.from_numpy(X), torch.from_numpy(Y)
    _FailOnce.armed = True
    with pytest.raises(RuntimeError, match="shard 1 failed"):
        steps[0](x, y)
    assert not _FailOnce.armed
    for _ in range(2):
        np.testing.assert_allclose(float(steps[0](x, y)),
                                   float(steps[1](x, y)), rtol=1e-6)
    want = _port_arrays(clean)
    for n, w in _port_arrays(failing).items():   # running statistics too
        np.testing.assert_allclose(w, want[n], rtol=1e-6, atol=1e-7,
                                   err_msg=n)


def test_fsdp_and_wd_mult_over_a_mesh():
    """fsdp_rules shard storage only: the dp 2 x fsdp 2 step equals the
    JAX one, with wd_mult 0 on the biases honoured in both."""
    X, Y = _xy(4, 16)
    jnet = _jax_mlp(9)
    net = _port_mlp(_arrays(jnet))
    for params in (jnet.collect_params(), net.collect_params()):
        params["0.bias"].wd_mult = 0.0
        params["1.bias"].wd_mult = 0.0
    jpar.apply_sharding_rules(jnet, jpar.fsdp_rules(min_size=8))
    par.apply_sharding_rules(net, par.fsdp_rules(min_size=8))
    assert tuple(net.collect_params()["0.weight"].sharding) == ("fsdp", None)
    jstep = jpar.TrainStep(jnet, jloss.SoftmaxCrossEntropyLoss(),
                           jopt.SGD(learning_rate=0.1, wd=0.5),
                           mesh=jpar.make_mesh(dp=2, fsdp=2,
                                               devices=jax.devices()[:4]),
                           batch_specs=(JP("dp"), JP("dp")))
    step = par.TrainStep(net, gloss.SoftmaxCrossEntropyLoss(),
                         opt.SGD(learning_rate=0.1, wd=0.5),
                         mesh=par.make_mesh(dp=2, fsdp=2,
                                            devices=["cpu"] * 4),
                         batch_specs=(P("dp"), P("dp")))
    for _ in range(2):
        want = float(jstep(jmx.nd.array(X),
                           jmx.nd.array(Y, dtype="int32")).asscalar())
        got = float(step(torch.from_numpy(X), torch.from_numpy(Y)))
        np.testing.assert_allclose(got, want, rtol=1e-5)
    jstep.sync_params()
    want_w, got_w = _arrays(jnet), _port_arrays(net)
    for n in want_w:
        np.testing.assert_allclose(got_w[n], want_w[n], rtol=1e-4,
                                   atol=1e-5, err_msg=n)


def test_eval_step_over_a_mesh():
    X, _ = _xy(6, 16)
    jnet = _jax_mlp(11)
    net = _port_mlp(_arrays(jnet))
    net.collect_params()["0.weight"].sharding = P("tp", None)
    want = jpar.EvalStep(jnet, mesh=jpar.make_mesh(dp=8))(
        jmx.nd.array(X)).asnumpy()
    ev = par.EvalStep(net, mesh=par.make_mesh(dp=4, tp=2, devices=CPU8))
    got = ev(mx.nd.array(X, ctx=mx.cpu()))
    assert isinstance(got, mx.nd.NDArray)
    np.testing.assert_allclose(got.asnumpy(), want, rtol=1e-5, atol=1e-6)
    assert torch.is_tensor(ev(torch.from_numpy(X)))


def test_comm_report_prices_the_step_collectives():
    net = nn.Dense(16, in_units=32)
    net.initialize(mx.init.Xavier(), ctx=mx.cpu())
    step = par.TrainStep(net, gloss.L2Loss(), opt.SGD(learning_rate=0.1),
                         mesh=par.make_mesh(dp=4, devices=["cpu"] * 4))
    r = np.random.default_rng(0)
    x = torch.from_numpy(r.standard_normal((8, 32)).astype(np.float32))
    y = torch.from_numpy(r.standard_normal((8, 16)).astype(np.float32))
    step(x, y)
    report = par.comm_report(step)
    assert "all_reduce" in report and "total wire time" in report
    rows = par.collective_summary(step.last_collectives)
    grads = {row["bytes"] for row in rows if row["kind"] == "all_reduce"}
    assert {16 * 32 * 4, 16 * 4} <= grads   # weight and bias psums
    for kind, n, want in (("all_reduce", 4, 1500), ("all_gather", 4, 750),
                          ("collective_permute", 4, 1000),
                          ("all_reduce", 1, 0)):
        assert par.ring_cost_bytes(kind, 1000, n) == want == \
            jpar.ring_cost_bytes(kind, 1000, n)
    assert par.comm_report([]).startswith("no collectives")


def test_bert_mlm_dryrun_mesh_matches_jax():
    """`dryrun_multichip`'s step: BERT MLM with megatron tp rules on a dp
    2 x sp 2 x tp 2 mesh, attention routed by impl='auto' to Ulysses,
    AdamW(1e-4, wd=0.01); two steps from the same weights (dropout 0),
    held to the JAX mesh step at rtol 1e-4. Rows hold different counts
    of valid tokens, so the loss is the global batch's mean."""
    from mxnet_tpu.models import BertConfig as JConfig
    from mxnet_tpu.models import BertForMaskedLM as JBert
    from mxnet_tpu_torch.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models import (BertConfig, BertForMaskedLM,
                                        load_jax_params)
    kw = dict(vocab_size=256, units=64, hidden_size=128, num_layers=2,
              num_heads=4, max_length=64, dropout=0.0,
              attention_dropout=0.0)
    jnet = JBert(JConfig(**kw))
    jmx.rng.seed(0)
    jnet.initialize(jmx.init.Normal(0.02))
    net = load_jax_params(BertForMaskedLM(BertConfig(**kw), device="cpu"),
                          _arrays(jnet))
    jpar.apply_sharding_rules(jnet, jpar.megatron_dense_rules(tp_axis="tp"))
    par.apply_sharding_rules(net, par.megatron_dense_rules(tp_axis="tp"))
    r = np.random.default_rng(0)
    B, T, M = 8, 32, 8
    vl = np.asarray([32, 20, 32, 9, 32, 32, 17, 25], np.int32)
    batch = (r.integers(0, 256, (B, T)).astype(np.int32),
             np.zeros((B, T), np.int32), vl,
             np.stack([np.sort(r.choice(n, M, replace=n < M))
                       for n in vl]).astype(np.int32),
             r.integers(0, 256, (B, M)).astype(np.int32))
    specs = (("dp", "sp"), ("dp", "sp"), ("dp",), ("dp",), ("dp",))
    jstep = jpar.TrainStep(
        jnet, jloss.SoftmaxCrossEntropyLoss(),
        jopt.AdamW(learning_rate=1e-4, wd=0.01),
        mesh=jpar.make_mesh({"dp": 2, "sp": 2, "tp": 2}), n_net_inputs=4,
        batch_specs=tuple(JP(*s) for s in specs))
    mesh = par.make_mesh({"dp": 2, "sp": 2, "tp": 2}, devices=CPU8)
    step = par.TrainStep(net, SoftmaxCrossEntropyLoss(),
                         opt.AdamW(learning_rate=1e-4, wd=0.01), mesh=mesh,
                         n_net_inputs=4,
                         batch_specs=tuple(P(*s) for s in specs))
    # the reference's mesh step refuses a second call on its own output
    # shardings, so its two steps run as one run_steps program
    want = jstep.run_steps(*[jmx.nd.array(a, dtype="int32")
                             for a in batch], steps=2).asnumpy()
    got = [float(step(*[torch.from_numpy(a) for a in batch]))
           for _ in range(2)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    jstep.sync_params()
    ref = _arrays(jnet)
    for n, p in net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[n], rtol=1e-4,
                                   atol=1e-5, err_msg=n)
    kinds = par.comm.bytes_by_kind(step)
    assert kinds["all_to_all"][0] > 0          # Ulysses under sp
    assert kinds["all_gather"][0] > 0          # tp-sharded storage
    assert kinds["reduce_scatter"][0] > 0
