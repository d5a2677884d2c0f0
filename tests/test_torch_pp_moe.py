"""Pipeline parallelism and MoE against the JAX package.

Pipeline: gpipe, pipeline_loss, the 1F1B pipeline_grads and PPTrainStep
(both schedules, on a dp 2 x pp 2 mesh of `["cpu"] * 4`) against the
sequential stages the JAX tests use as their oracle, computed by JAX;
GPT-2 split by gpt2_pp_functions with the JAX model's stacked stage
parameters carried across (models.load_jax_tree). MoE: top_k_gating
exactly (dispatch, combine, aux; capacity drops), moe_dispatch_combine
and MoEFFN against the JAX layer on the same weights, the ep-sharded
MoEFFN TrainStep (dp 2 x ep 2) against the unsharded one, and the
all_to_all_tokens round trip.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu import parallel as jpar  # noqa: E402

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import MXNetError  # noqa: E402
from mxnet_tpu_torch import optimizer as opt  # noqa: E402
from mxnet_tpu_torch import parallel as par  # noqa: E402
from mxnet_tpu_torch.models import load_gluon_params, load_jax_tree  # noqa: E402,E501


def _t_j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------

def _toy(P_):
    """The JAX pipeline tests' toy model, in both packages."""
    rng = np.random.default_rng(0)
    C, V = 12, 20
    emb = (rng.standard_normal((V, C)) * 0.2).astype(np.float32)
    stages = [{"w": (rng.standard_normal((C, C)) * 0.3).astype(np.float32)}
              for _ in range(P_)]
    head = {"wo": (rng.standard_normal((C, V)) * 0.2).astype(np.float32)}
    x = rng.integers(0, V, (16, 6)).astype(np.int32)
    y = rng.integers(0, V, (16, 6)).astype(np.int32)

    def jhead(hp, h, labels):
        lp = jax.nn.log_softmax(h @ hp["wo"])
        return -jnp.take_along_axis(lp, labels[..., None], -1).mean()

    def jref(e, s, hp, x, y):
        h = e[x]
        for p_ in s:
            h = jnp.tanh(h @ p_["w"]) + h
        return jhead(hp, h, y)

    def head_fn(hp, h, labels):
        lp = torch.log_softmax(h @ hp["wo"], -1)
        return -lp.gather(-1, labels.long()[..., None]).mean()

    port = (lambda ep, ids: ep[ids.long()],
            lambda p, h: torch.tanh(h @ p["w"]) + h, head_fn)
    return emb, stages, head, x, y, jref, port


@pytest.mark.parametrize("n_stages,n_micro", [(4, 4), (2, 8)])
def test_gpipe_matches_jax(n_stages, n_micro):
    r = np.random.default_rng(n_stages)
    stages = [{"w1": (r.standard_normal((6, 10)) * 0.3).astype(np.float32),
               "b1": np.zeros(10, np.float32),
               "w2": (r.standard_normal((10, 6)) * 0.3).astype(np.float32),
               "b2": np.zeros(6, np.float32)} for _ in range(n_stages)]
    x = r.standard_normal((8, 6)).astype(np.float32)

    def jstage(p, h):
        return jnp.tanh(h @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]

    want = np.asarray(jpar.gpipe(
        jstage, jpar.stack_stage_params([_t_j(s) for s in stages]),
        jnp.asarray(x), n_microbatches=n_micro,
        mesh=jpar.make_mesh(pp=n_stages,
                            devices=jax.devices()[:n_stages])))
    mesh = par.make_mesh(pp=n_stages, devices=["cpu"] * n_stages)
    stacked = par.stack_stage_params([load_jax_tree(s) for s in stages])
    xt = torch.from_numpy(x).requires_grad_(True)
    got = par.gpipe(lambda p, h: torch.tanh(h @ p["w1"] + p["b1"])
                    @ p["w2"] + p["b2"], stacked, xt, n_micro, mesh=mesh)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=2e-5,
                               atol=2e-6)
    got.sum().backward()                      # differentiable end to end

    def jseq(x_):
        for p_ in stages:
            x_ = jstage(_t_j(p_), x_)
        return x_.sum()

    np.testing.assert_allclose(xt.grad.numpy(),
                               np.asarray(jax.grad(jseq)(jnp.asarray(x))),
                               rtol=1e-4, atol=1e-6)
    with pytest.raises(MXNetError, match="microbatch"):
        par.gpipe(lambda p, h: h, stacked, xt, 3, mesh=mesh)
    with pytest.raises(MXNetError, match="pp"):
        par.gpipe(lambda p, h: h, stacked, xt, 2,
                  mesh=par.make_mesh(dp=2, devices=["cpu"] * 2))


def test_pipeline_loss_and_1f1b_grads_match_jax():
    emb, stages, head, x, y, jref, (embed_fn, stage_fn, head_fn) = _toy(4)
    want = float(jref(jnp.asarray(emb), _t_j(stages), _t_j(head),
                      jnp.asarray(x), jnp.asarray(y)))
    jg = jax.grad(jref, argnums=(0, 1, 2))(
        jnp.asarray(emb), _t_j(stages), _t_j(head), jnp.asarray(x),
        jnp.asarray(y))
    mesh = par.make_mesh(pp=4, devices=["cpu"] * 4)
    e, s, h = (load_jax_tree(emb), par.stack_stage_params(
        [load_jax_tree(st) for st in stages]), load_jax_tree(head))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    got = float(par.pipeline_loss(embed_fn, stage_fn, head_fn, e, s, h,
                                  xt, yt, 8, mesh=mesh))
    assert abs(got - want) < 1e-5
    for fn in (par.pipeline_grads, par.pipeline_loss_and_grads):
        loss, ge, gb, gh = fn(embed_fn, stage_fn, head_fn, e, s, h, xt, yt,
                              8, mesh=mesh)
        assert abs(float(loss) - want) < 1e-5
        np.testing.assert_allclose(ge.numpy(), np.asarray(jg[0]),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(gh["wo"].numpy(),
                                   np.asarray(jg[2]["wo"]), rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(
            gb["w"].numpy(), np.stack([np.asarray(g["w"]) for g in jg[1]]),
            rtol=1e-4, atol=1e-6)


def test_1f1b_keeps_o_of_p_microbatches_in_flight(monkeypatch):
    """The 1F1B schedule saves a stage's input at its forward and frees
    it at its backward, 2(P-1-p) steps later on stage p: stage 0 holds
    2P - 1 inputs at most, whatever the microbatch count (the
    reference's ring of 2P slots, pp.py `DEPTH`), not all M as GPipe's
    autodiff does."""
    from mxnet_tpu_torch.parallel import pp
    emb, stages, head, x, y, _, (embed_fn, stage_fn, head_fn) = _toy(4)
    peak = [0]
    real = pp._pipeline_grads_shard

    class Saved(dict):
        def __setitem__(self, k, v):
            super().__setitem__(k, v)
            peak[0] = max(peak[0], len(self))

    def spy(*a):
        orig = dict
        pp.dict = Saved      # the schedule's per-stage `saved` dicts
        try:
            return real(*a)
        finally:
            pp.dict = orig

    monkeypatch.setattr(pp, "_pipeline_grads_shard", spy)
    par.pipeline_grads(embed_fn, stage_fn, head_fn, load_jax_tree(emb),
                       par.stack_stage_params([load_jax_tree(s)
                                               for s in stages]),
                       load_jax_tree(head), torch.from_numpy(x),
                       torch.from_numpy(y), 16,
                       mesh=par.make_mesh(pp=4, devices=["cpu"] * 4))
    assert peak[0] == 2 * 4 - 1 < 16


@pytest.mark.parametrize("schedule", ["1f1b", "gpipe"])
def test_pp_train_step_matches_jax_sequential(schedule):
    emb, stages, head, x, y, jref, (embed_fn, stage_fn, head_fn) = _toy(2)
    lr = 0.2
    e_r, s_r, h_r = jnp.asarray(emb), _t_j(stages), _t_j(head)
    want = []
    for _ in range(4):
        val, (ge, gs, gh) = jax.value_and_grad(jref, argnums=(0, 1, 2))(
            e_r, s_r, h_r, jnp.asarray(x), jnp.asarray(y))
        want.append(float(val))
        e_r = e_r - lr * ge
        s_r = [jax.tree_util.tree_map(lambda a, g: a - lr * g, s_, g_)
               for s_, g_ in zip(s_r, gs)]
        h_r = jax.tree_util.tree_map(lambda a, g: a - lr * g, h_r, gh)
    step = par.PPTrainStep(
        embed_fn, stage_fn, head_fn, load_jax_tree(emb),
        par.stack_stage_params([load_jax_tree(s) for s in stages]),
        load_jax_tree(head), opt.SGD(learning_rate=lr), 4,
        mesh=par.make_mesh({"dp": 2, "pp": 2}, devices=["cpu"] * 4),
        schedule=schedule)
    got = [float(step(torch.from_numpy(x), torch.from_numpy(y)))
           for _ in range(4)]
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)
    kinds = {r["kind"] for r in step.last_collectives}
    assert {"collective_permute", "all_reduce"} <= kinds
    with pytest.raises(MXNetError, match="schedule"):
        par.PPTrainStep(embed_fn, stage_fn, head_fn, load_jax_tree(emb),
                        step.params[1], load_jax_tree(head), opt.SGD(), 4,
                        mesh=step.mesh, schedule="zigzag")


def test_gpt2_pp_step_matches_jax_with_carried_stage_params():
    """GPT-2 (4 layers) split by gpt2_pp_functions in both packages; the
    JAX model's embed, stacked body and head trees cross by
    load_jax_tree; 2 PPTrainStep (1F1B, tied wte) steps against the
    JAX sequential SGD steps of the same functions."""
    from mxnet_tpu.models import GPT2Config as JCfg
    from mxnet_tpu.models import GPT2ForCausalLM as JGPT2
    from mxnet_tpu.models.gpt2 import gpt2_pp_functions as jpp
    from mxnet_tpu_torch.models import GPT2Config, GPT2ForCausalLM
    from mxnet_tpu_torch.models.gpt2 import gpt2_pp_functions
    kw = dict(vocab_size=96, units=32, num_layers=4, num_heads=4,
              max_length=32, dropout=0.0, attention_dropout=0.0)
    jnet = JGPT2(JCfg(attention_impl="xla", **kw))
    jmx.rng.seed(3)
    jnet.initialize(jmx.init.Normal(0.05))
    je, jfn, jh, jep, jst, jhp, _ = jpp(jnet, n_stages=2)
    (embed_fn, stage_fn, head_fn, ep, st, hp,
     tied) = gpt2_pp_functions(GPT2ForCausalLM(GPT2Config(**kw),
                                               device="cpu"), 2)
    ep, st, hp = (load_jax_tree(jax.tree_util.tree_map(np.asarray, a),
                                like=b) for a, b in ((jep, ep), (jst, st),
                                                     (jhp, hp)))
    rng = np.random.default_rng(0)
    x = rng.integers(0, 96, (8, 16)).astype(np.int32)
    y = rng.integers(0, 96, (8, 16)).astype(np.int32)

    def ref_loss(e, b, h):
        hh = je(e, jnp.asarray(x))
        for s in range(2):
            hh = jfn(jax.tree_util.tree_map(lambda a: a[s], b), hh)
        return jh(h, hh, jnp.asarray(y))

    lr, want = 0.1, []
    e_r, b_r, h_r = jep, jst, jhp
    vg = jax.jit(jax.value_and_grad(ref_loss, argnums=(0, 1, 2)))
    for _ in range(2):
        val, (ge, gb, gh) = vg(e_r, b_r, h_r)
        want.append(float(val))
        ge = dict(ge, wte=ge["wte"] + gh["wte"])
        e_r = jax.tree_util.tree_map(lambda a, g: a - lr * g, e_r, ge)
        b_r = jax.tree_util.tree_map(lambda a, g: a - lr * g, b_r, gb)
        h_r = {k: e_r["wte"] if k == "wte" else h_r[k] - lr * gh[k]
               for k in h_r}
    step = par.PPTrainStep(embed_fn, stage_fn, head_fn, ep, st, hp,
                           opt.SGD(learning_rate=lr), 4,
                           mesh=par.make_mesh({"dp": 2, "pp": 2},
                                              devices=["cpu"] * 4),
                           schedule="1f1b", tied=tied)
    got = [float(step(torch.from_numpy(x), torch.from_numpy(y)))
           for _ in range(2)]
    np.testing.assert_allclose(got, want, rtol=5e-5, atol=1e-6)
    with pytest.raises(MXNetError, match="shape"):
        load_jax_tree({"wte": np.zeros((3, 3), np.float32),
                       "wpe": np.zeros((3, 3), np.float32)}, like=ep)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("top_k,cf,skew", [(2, 1.25, False), (1, 0.5, True),
                                           (2, 0.5, False)])
def test_top_k_gating_equals_jax(top_k, cf, skew):
    S, E = 24, 4
    r = np.random.default_rng(top_k)
    logits = r.standard_normal((S, E)).astype(np.float32)
    if skew:       # every token prefers expert 0: most are dropped
        logits[:, 0] += 5.0
    cap = max(1, int(S * top_k * cf / E))
    want = jax.jit(jpar.top_k_gating, static_argnums=(1, 2))(
        jnp.asarray(logits), top_k, cap)
    got = par.top_k_gating(torch.from_numpy(logits), top_k, cap)
    # routing, slots and capacity drops exactly; the gate weights to the
    # last bit of XLA's exp, which is not torch's
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy() > 0,
                                  np.asarray(want[1]) > 0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=2.5e-7, atol=0)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-6)
    if skew:
        assert int(got[0][:, 0].sum()) == cap < S


def test_moe_dispatch_combine_matches_jax_and_dense():
    S, C, H, E = 16, 8, 12, 4
    r = np.random.default_rng(1)
    x = r.standard_normal((S, C)).astype(np.float32)
    logits = r.standard_normal((S, E)).astype(np.float32)
    w1 = (r.standard_normal((E, C, H)) * 0.3).astype(np.float32)
    w2 = (r.standard_normal((E, H, C)) * 0.3).astype(np.float32)
    b1, b2 = np.zeros((E, H), np.float32), np.zeros((E, C), np.float32)
    for cf in (2.0, 0.5):
        want = jax.jit(functools.partial(
            jpar.moe_dispatch_combine, top_k=2, capacity_factor=cf))(
            *map(jnp.asarray, (x, logits, w1, b1, w2, b2)))
        got = par.moe_dispatch_combine(*map(torch.from_numpy, (
            x, logits, w1, b1, w2, b2)), top_k=2, capacity_factor=cf)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=2e-5, atol=2e-6)
        np.testing.assert_allclose(float(got[1]), float(want[1]),
                                   rtol=1e-6)
    # identical experts and ample capacity: the dense FFN
    same = [torch.from_numpy(np.broadcast_to(w[:1], w.shape).copy())
            for w in (w1, w2)]
    y, _ = par.moe_dispatch_combine(
        torch.from_numpy(x), torch.from_numpy(logits), same[0],
        torch.from_numpy(b1), same[1], torch.from_numpy(b2), top_k=2,
        capacity_factor=4.0)
    xt = torch.from_numpy(x)
    dense = torch.nn.functional.gelu(xt @ same[0][0], approximate="tanh") \
        @ same[1][0]
    np.testing.assert_allclose(y.numpy(), dense.numpy(), rtol=2e-4,
                               atol=2e-5)


def _moe_nets():
    """A MoEFFN + Dense head in both packages, the JAX weights carried
    across."""
    from mxnet_tpu.gluon import nn as jnn
    from mxnet_tpu_torch.gluon import nn

    def build(nn_):
        class Net(nn_.HybridBlock):
            def __init__(self):
                super().__init__()
                self.moe = nn_.MoEFFN(8, 16, num_experts=4, top_k=2)
                self.head = nn_.Dense(2, flatten=False, in_units=8)

            def forward(self, x):
                return self.head(self.moe(x))
        return Net()

    jnet = build(jnn)
    jmx.rng.seed(5)
    jnet.initialize(jmx.init.Normal(0.1))
    arrays = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    mk = lambda: load_gluon_params(build(nn), arrays, ctx=mx.cpu())  # noqa
    return jnet, mk


def test_moe_ffn_matches_jax_and_ep_sharded_step_matches_unsharded():
    from mxnet_tpu_torch.gluon import loss as gloss
    jnet, mk = _moe_nets()
    r = np.random.default_rng(6)
    x = r.standard_normal((4, 6, 8)).astype(np.float32)
    y = r.integers(0, 2, (4, 6)).astype(np.int32)
    net = mk()
    assert tuple(net.collect_params()["moe.expert_w1"].shape) == (4, 8, 16)
    np.testing.assert_allclose(
        net(mx.nd.array(x, ctx=mx.cpu())).asnumpy(),
        jnet(jmx.nd.array(x)).asnumpy(), rtol=2e-5, atol=2e-6)
    single = par.TrainStep(net, gloss.SoftmaxCrossEntropyLoss(),
                           opt.Adam(learning_rate=3e-3))
    net_ep = mk()
    par.apply_sharding_rules(net_ep, par.ep_rules())
    assert tuple(net_ep.collect_params()["moe.expert_w1"].sharding) == \
        ("ep",)
    mesh = par.make_mesh(dp=2, ep=2, devices=["cpu"] * 4)
    step = par.TrainStep(net_ep, gloss.SoftmaxCrossEntropyLoss(),
                         opt.Adam(learning_rate=3e-3), mesh=mesh,
                         batch_specs=(par.PartitionSpec("dp"),
                                      par.PartitionSpec("dp")))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    for _ in range(3):
        np.testing.assert_allclose(float(step(xt, yt)),
                                   float(single(xt, yt)), rtol=1e-5)
    for (n, a), b in zip(net.named_parameters(), net_ep.parameters()):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=n)
    assert len(step.mesh_params[1].devices) == 4     # moe.expert_w1
    assert step.mesh_params[1].sharded


def test_all_to_all_tokens_round_trip_matches_jax():
    x = np.arange(4 * 8 * 3, dtype=np.float32).reshape(8, 4, 3)
    jmesh = jpar.make_mesh(ep=4, devices=jax.devices()[:4])
    want = np.asarray(jpar.all_to_all_tokens(jnp.asarray(x), mesh=jmesh,
                                             axis="ep", split_dim=1,
                                             concat_dim=0))
    mesh = par.make_mesh(ep=4, devices=["cpu"] * 4)
    y = par.all_to_all_tokens(torch.from_numpy(x), mesh=mesh, axis="ep",
                              split_dim=1, concat_dim=0)
    np.testing.assert_array_equal(y.numpy(), want)
    z = par.all_to_all_tokens(y, mesh=mesh, axis="ep", split_dim=0,
                              concat_dim=1)
    np.testing.assert_array_equal(z.numpy(), x)
