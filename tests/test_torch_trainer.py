"""The port's gluon Trainer against the JAX package's, on the eager loop
users write:

    with autograd.record(): loss = lfn(net(*inputs), labels).mean()
    loss.backward(); gluon.utils.clip_global_norm(grads, 1.0)
    trainer.step(1)

* a tiny BERT MLM (1 layer, dropout 0) with LAMB and a PolyScheduler
  with warmup, 3 steps, and examples/translate_nmt.py's loop (a tiny
  NMT with Adam, 3 steps) with only the import changed (and ctx=cpu):
  each step's loss within 1e-5 relative and every parameter after the
  last step within 1e-5 (absolute). The weights cross over with
  models.load_gluon_params; each JAX loop runs once per module.
* within the port: save_states / load_states resumes bit for bit;
  TrainStep with LAMB follows the eager Trainer from the same weights
  (losses 1e-5, parameters 1e-5), the rate schedule taken at the step
  each applies it; the Trainer's order, rescale_grad, 'write' zeroing,
  kvstore and learning-rate rules; clip_global_norm and split_and_load.
"""
import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu import models as jmodels  # noqa: E402
from mxnet_tpu.gluon import Trainer as JTrainer  # noqa: E402
from mxnet_tpu.gluon import loss as jloss  # noqa: E402
from mxnet_tpu.gluon import utils as jutils  # noqa: E402

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import MXNetError, gluon, models  # noqa: E402
from mxnet_tpu_torch import lr_scheduler as psched  # noqa: E402
from mxnet_tpu_torch.gluon import loss as ploss  # noqa: E402
from mxnet_tpu_torch.gluon import utils as putils  # noqa: E402
from mxnet_tpu_torch.optimizer import LAMB  # noqa: E402
from mxnet_tpu_torch.parallel import TrainStep  # noqa: E402

CPU = mx.cpu()
STEPS = 3
BERT_KW = dict(vocab_size=100, units=32, hidden_size=64, num_layers=1,
               num_heads=2, max_length=16, dropout=0.0,
               attention_dropout=0.0)
B, T, M = 4, 16, 3


def _arrays(jnet):
    return {n: np.array(p.data().asnumpy())
            for n, p in jnet.collect_params().items()}


def _bert_batches():
    r = np.random.default_rng(0)
    out = []
    for _ in range(STEPS):
        ids = r.integers(0, BERT_KW["vocab_size"], (B, T))
        tt = r.integers(0, 2, (B, T))
        vl = r.integers(T // 2, T + 1, B)
        pos = np.stack([np.sort(r.choice(int(n), M, replace=False))
                        for n in vl])
        lab = r.integers(0, BERT_KW["vocab_size"], (B, M))
        out.append([a.astype(np.int32) for a in (ids, tt, vl, pos, lab)])
    return out


def _sched(mod):
    return mod.PolyScheduler(max_update=10, base_lr=1e-3, pwr=1,
                             warmup_steps=2, warmup_begin_lr=1e-4)


def _bert_loop(m, net, trainer, lfn, batches, nd):
    losses = []
    params = list(net.collect_params().values())
    utils = putils if m is mx else jutils
    for batch in batches:
        a = [nd(x) for x in batch]
        with m.autograd.record():
            loss = lfn(net(*a[:4]), a[4]).mean()
        loss.backward()
        utils.clip_global_norm([p.grad() for p in params], 1.0)
        trainer.step(1)
        losses.append(float(loss.asscalar()))
    return losses


@pytest.fixture(scope="module")
def bert_ref():
    gc.collect()
    jnet = jmodels.BertForMaskedLM(jmodels.BertConfig(**BERT_KW))
    jmx.rng.seed(0)
    jnet.initialize(jmx.init.Normal(0.02))
    arrays0 = _arrays(jnet)
    from mxnet_tpu import lr_scheduler as jsched
    tr = JTrainer(jnet.collect_params(), "lamb",
                  {"learning_rate": 1e-3, "wd": 0.01,
                   "lr_scheduler": _sched(jsched)})
    losses = _bert_loop(jmx, jnet, tr, jloss.SoftmaxCrossEntropyLoss(),
                        _bert_batches(), lambda x: jmx.nd.array(x,
                                                                dtype="int32"))
    res = {"arrays0": arrays0, "losses": losses, "arrays": _arrays(jnet)}
    del jnet, tr
    gc.collect()
    return res


def _port_bert(arrays):
    net = models.BertForMaskedLM(models.BertConfig(**BERT_KW), device="cpu")
    net.initialize(mx.init.Normal(0.02), ctx=CPU)
    return models.load_gluon_params(net, arrays)


def _nd(x):
    return mx.nd.array(x, ctx=CPU, dtype="int32")


def _close_params(got, want):
    """Every parameter within 1e-5 (absolute; the weights are O(0.1), and
    Adam's and LAMB's normalised steps carry the float32 noise of
    near-zero gradients into the weights at about that size)."""
    for n, w in want.items():
        err = float(np.abs(got[n] - w).max())
        assert err <= 1e-5, (n, err)


def test_bert_lamb_poly_loop_matches_reference(bert_ref):
    net = _port_bert(bert_ref["arrays0"])
    tr = gluon.Trainer(net.collect_params(), "lamb",
                       {"learning_rate": 1e-3, "wd": 0.01,
                        "lr_scheduler": _sched(psched)})
    losses = _bert_loop(mx, net, tr, ploss.SoftmaxCrossEntropyLoss(),
                        _bert_batches(), _nd)
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, bert_ref["losses"])]
    assert max(rel) <= 1e-5, (losses, bert_ref["losses"])
    _close_params(_arrays(net), bert_ref["arrays"])
    assert tr.learning_rate == _sched(psched)(STEPS)


# -- examples/translate_nmt.py's loop ---------------------------------------

BOS, EOS = 2, 3
NMT_KW = dict(src_vocab_size=32, tgt_vocab_size=32, units=32, hidden_size=64,
              enc_layers=2, dec_layers=2, num_heads=2, max_length=32,
              dropout=0.0, bos_id=BOS, eos_id=EOS)


def _nmt_data():
    rng = np.random.default_rng(0)
    Bn, Tn = 8, 6
    src = rng.integers(4, 32, (Bn, Tn)).astype(np.int32)
    body = src[:, ::-1]
    tgt_in = np.concatenate([np.full((Bn, 1), BOS, np.int32), body], axis=1)
    tgt_out = np.concatenate([body, np.full((Bn, 1), EOS, np.int32)],
                             axis=1)
    return src, tgt_in, tgt_out


def _nmt_loop(mxm, net, **ctx):
    """examples/translate_nmt.py's training loop, for `mxm` either
    package (ctx aside)."""
    Trainer = mxm.gluon.Trainer
    gloss = mxm.gluon.loss
    src, tgt_in, tgt_out = _nmt_data()
    tr = Trainer(net.collect_params(), "adam", {"learning_rate": 3e-3},
                 kvstore=None)
    lfn = gloss.SoftmaxCrossEntropyLoss()
    s_nd = mxm.nd.array(src, dtype="int32", **ctx)
    losses = []
    for i in range(STEPS):
        with mxm.autograd.record():
            logits = net(s_nd, mxm.nd.array(tgt_in, dtype="int32", **ctx))
            loss = lfn(logits.reshape((-1, 32)),
                       mxm.nd.array(tgt_out.reshape(-1), dtype="int32",
                                    **ctx)).mean()
        loss.backward()
        tr.step(1)
        losses.append(float(loss.asscalar()))
    return losses


@pytest.fixture(scope="module")
def nmt_ref():
    gc.collect()
    net = jmodels.TransformerNMT(jmodels.NMTConfig(**NMT_KW))
    jmx.rng.seed(0)
    net.initialize(jmx.init.Normal(0.05))
    arrays0 = _arrays(net)
    losses = _nmt_loop(jmx, net)
    res = {"arrays0": arrays0, "losses": losses, "arrays": _arrays(net)}
    del net
    gc.collect()
    return res


def test_translate_nmt_example_loop_matches_reference(nmt_ref):
    net = models.TransformerNMT(models.NMTConfig(**NMT_KW), device="cpu")
    mx.rng.seed(0)
    net.initialize(mx.init.Normal(0.05))
    models.load_gluon_params(net, nmt_ref["arrays0"])
    losses = _nmt_loop(mx, net, ctx=CPU)
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, nmt_ref["losses"])]
    assert max(rel) <= 1e-5, (losses, nmt_ref["losses"])
    _close_params(_arrays(net), nmt_ref["arrays"])


# -- within the port -----------------------------------------------------------

def test_save_and_load_states_resume_exactly(tmp_path, bert_ref):
    batches = _bert_batches()
    lfn = ploss.SoftmaxCrossEntropyLoss()

    def make():
        net = _port_bert(bert_ref["arrays0"])
        tr = gluon.Trainer(net.collect_params(), "lamb",
                           {"learning_rate": 1e-3, "wd": 0.01,
                            "lr_scheduler": _sched(psched)})
        return net, tr
    net, tr = make()
    _bert_loop(mx, net, tr, lfn, batches[:2], _nd)
    tr.save_states(str(tmp_path / "states"))
    mid = _arrays(net)
    want = _bert_loop(mx, net, tr, lfn, batches[2:], _nd)
    net2, tr2 = make()
    models.load_gluon_params(net2, mid)
    tr2.load_states(str(tmp_path / "states"))
    assert tr2.optimizer.num_update == 2
    got = _bert_loop(mx, net2, tr2, lfn, batches[2:], _nd)
    assert got == want
    for n, a in _arrays(net).items():
        np.testing.assert_array_equal(_arrays(net2)[n], a)


def test_train_step_with_lamb_follows_the_eager_trainer(bert_ref):
    """parallel.TrainStep takes LAMB (its functional update) and, from
    the same weights and batches, follows the eager loop (without the
    global-norm clip, which TrainStep does not have). TrainStep reads the
    rate before it counts the step, the Trainer after: the step's
    scheduler is the Trainer's shifted by one, so both apply the same
    rate to each step."""
    batches = _bert_batches()
    lfn = ploss.SoftmaxCrossEntropyLoss()
    net = _port_bert(bert_ref["arrays0"])
    tr = gluon.Trainer(net.collect_params(), "lamb",
                       {"learning_rate": 1e-3, "wd": 0.01,
                        "lr_scheduler": _sched(psched)})
    eager = []
    for batch in batches:
        a = [_nd(x) for x in batch]
        with mx.autograd.record():
            loss = lfn(net(*a[:4]), a[4]).mean()
        loss.backward()
        tr.step(1)
        eager.append(float(loss.asscalar()))
    sched = _sched(psched)
    net2 = _port_bert(bert_ref["arrays0"])
    step = TrainStep(net2, lfn, LAMB(learning_rate=1e-3, wd=0.01,
                                     lr_scheduler=lambda n: sched(n + 1)),
                     n_net_inputs=4)
    fused = [float(step(*(torch.from_numpy(x) for x in batch)))
             for batch in batches]
    rel = [abs(a - b) / abs(b) for a, b in zip(fused, eager)]
    assert max(rel) <= 1e-5, (fused, eager)
    _close_params(_arrays(net2), _arrays(net))


def test_trainer_rules():
    net = gluon.nn.Dense(2, in_units=3)
    net.initialize(mx.init.One(), ctx=CPU)
    params = net.collect_params()
    tr = gluon.Trainer(params, "sgd", {"learning_rate": 0.1})
    assert [p.name for p in tr._params] == sorted(params)
    x = mx.nd.ones((4, 3), ctx=CPU)
    with mx.autograd.record():
        y = net(x).sum()
    y.backward()
    g = params["weight"].grad().asnumpy().copy()
    tr.step(4)
    assert tr.optimizer.rescale_grad == 0.25
    np.testing.assert_allclose(params["weight"].data().asnumpy(),
                               1 - 0.1 * g / 4, rtol=1e-6)
    np.testing.assert_array_equal(params["weight"].grad().asnumpy(), 0)
    tr.set_learning_rate(0.05)
    assert tr.learning_rate == 0.05
    tr_async = gluon.Trainer(params, "sgd", kvstore="dist_async")
    with pytest.raises(MXNetError, match="dist_async"):
        tr_async.allreduce_grads()
    with pytest.raises(MXNetError):
        gluon.Trainer(params, mx.optimizer.SGD(), {"learning_rate": 1.0})


def test_clip_global_norm_and_split_and_load():
    r = np.random.default_rng(3)
    arrs = [r.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,))]
    got = [mx.nd.array(a, ctx=CPU) for a in arrs]
    want = [jmx.nd.array(a) for a in arrs]
    n1 = putils.clip_global_norm(got, 1.0)
    n2 = jutils.clip_global_norm(want, 1.0)
    assert abs(n1 - n2) <= 1e-6 * n2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.asnumpy(), w.asnumpy(), rtol=1e-6)
    parts = putils.split_and_load(np.arange(12).reshape(6, 2), [CPU, CPU])
    assert [p.shape for p in parts] == [(3, 2), (3, 2)]
    with pytest.raises(MXNetError):
        putils.split_data(mx.nd.ones((5, 2), ctx=CPU), 2)
