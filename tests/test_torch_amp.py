"""The port's mx.amp against the JAX package's.

* convert_model: the dtype of every parameter, name by name, equals the
  reference's (a Dense-BatchNorm-Dense net and a 2-layer BERT MLM; the
  norm layers stay float32), and so does the dtype of q at the first
  attention of the converted BERT (float32 in both: the kept-float32
  LayerNorm promotes the activations after it);
* LossScaler: the scale sequence over a pattern of overflows;
* scale_loss / unscale on the gluon Trainer, and its amp step: the
  float16 case of tests/test_amp_profiler_image.py (the update is the
  unscaled one; an overflow skips it and halves the scale), against the
  reference step for step; a float16-converted net trained through the
  Trainer in both packages; the init_trainer refusal;
* float16 never reaches the fused attention kernel: impl="fused" raises.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu.amp import LossScaler as JaxScaler  # noqa: E402
from mxnet_tpu.gluon import Trainer as JTrainer, nn as jnn  # noqa: E402
from mxnet_tpu.models import BertConfig as JaxConfig  # noqa: E402
from mxnet_tpu.models import BertForMaskedLM as JaxBert  # noqa: E402
from mxnet_tpu.ops import nn as jax_nn_ops  # noqa: E402

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import MXNetError, amp, models  # noqa: E402
from mxnet_tpu_torch.amp import LossScaler  # noqa: E402
from mxnet_tpu_torch.gluon import Trainer, nn  # noqa: E402
from mxnet_tpu_torch.models import BertConfig, BertForMaskedLM  # noqa: E402
from mxnet_tpu_torch.ops import nn as port_nn_ops  # noqa: E402

CPU = mx.cpu()


def _arrays(jnet):
    return {n: np.array(p.data().asnumpy())
            for n, p in jnet.collect_params().items()}


def _dtypes(params):
    return {n: np.dtype(str(p.data().dtype).replace("torch.", ""))
            if "bfloat16" not in str(p.data().dtype) else "bfloat16"
            for n, p in params.items()}


def _tiny_pair():
    jnet = jnn.HybridSequential()
    jnet.add(jnn.Dense(8, in_units=4))
    jnet.add(jnn.BatchNorm(in_channels=8))
    jnet.add(jnn.Dense(2, in_units=8))
    jmx.rng.seed(1)
    jnet.initialize()
    pnet = nn.HybridSequential()
    pnet.add(nn.Dense(8, in_units=4))
    pnet.add(nn.BatchNorm(in_channels=8))
    pnet.add(nn.Dense(2, in_units=8))
    pnet.initialize(ctx=CPU)
    models.load_gluon_params(pnet, _arrays(jnet), ctx=CPU)
    return jnet, pnet


KW = dict(vocab_size=100, units=64, hidden_size=64, num_layers=2,
          num_heads=2, max_length=16, dropout=0.0, attention_dropout=0.0)


@pytest.mark.parametrize("target", ["bfloat16", "float16"])
def test_convert_model_dtypes_match_the_reference(target):
    jmx.amp.init(target_dtype=target)
    amp.init(target_dtype=target)
    jnet, pnet = _tiny_pair()
    jmx.amp.convert_model(jnet)
    amp.convert_model(pnet)
    want = _dtypes(jnet.collect_params())
    assert _dtypes(pnet.collect_params()) == want
    assert want["1.gamma"] == np.float32 and want["0.weight"] == target
    jb = JaxBert(JaxConfig(**KW))
    jb.initialize()
    pb = BertForMaskedLM(BertConfig(**KW), device="cpu")
    jmx.amp.convert_hybrid_block(jb)
    amp.convert_hybrid_block(pb)
    want = _dtypes(jb.collect_params())
    assert _dtypes(pb.collect_params()) == want
    assert want["backbone.embed_ln.gamma"] == np.float32
    assert amp.amp_state() == {"initialized": True, "target_dtype": target}


def test_first_attention_dtype_matches_the_reference(monkeypatch):
    """In both packages the converted BERT reaches attention with float32
    q: LayerNorm returns its input's dtype before the float32 gamma and
    beta, and promotion does the rest."""
    jb = JaxBert(JaxConfig(**KW))
    jmx.rng.seed(2)
    jb.initialize(jmx.init.Normal(0.02))
    pb = models.load_jax_params(BertForMaskedLM(BertConfig(**KW),
                                                device="cpu"), _arrays(jb))
    jmx.amp.convert_model(jb, "bfloat16")
    amp.convert_model(pb, "bfloat16")
    seen = {}
    jreal, preal = jax_nn_ops.dot_product_attention, \
        port_nn_ops.dot_product_attention

    @functools.wraps(jreal)
    def jspy(q, *a, **k):
        seen.setdefault("jax", str(q.dtype))
        return jreal(q, *a, **k)

    @functools.wraps(preal)
    def pspy(q, *a, **k):
        seen.setdefault("port", str(q.dtype).replace("torch.", ""))
        return preal(q, *a, **k)

    monkeypatch.setattr(jax_nn_ops, "dot_product_attention", jspy)
    monkeypatch.setattr(port_nn_ops, "dot_product_attention", pspy)
    r = np.random.default_rng(0)
    ids = r.integers(0, 100, (2, 16)).astype(np.int32)
    tt = np.zeros_like(ids)
    vl = np.asarray([16, 9], np.int32)
    pos = np.asarray([[1, 4, 7], [0, 2, 8]], np.int32)
    jout = jb(*[jmx.nd.array(a, dtype="int32") for a in (ids, tt, vl, pos)])
    with torch.no_grad():
        pout = pb(*[torch.from_numpy(a) for a in (ids, tt, vl, pos)])
    assert seen == {"jax": "float32", "port": "float32"}
    assert str(jout.dtype) == str(pout.dtype).replace("torch.", "")


def test_loss_scaler_sequence():
    flags = [False, False, True, False, False, False, True, True, False,
             False, False, False]
    j, p = JaxScaler(init_scale=8.0, scale_window=3), \
        LossScaler(init_scale=8.0, scale_window=3)
    seq = []
    for f in flags:
        j.update_scale(f)
        p.update_scale(f)
        assert p.loss_scale == j.loss_scale
        seq.append(p.loss_scale)
    assert seq[:4] == [8.0, 8.0, 4.0, 4.0] and min(seq) >= 1.0
    tiny = LossScaler(init_scale=1.0)
    tiny.update_scale(True)
    assert tiny.loss_scale == 1.0
    assert LossScaler(init_scale=1.0, scale_window=10 ** 9).is_noop


def _dense_pair(**tkw):
    jnet = jnn.Dense(1, in_units=2)
    jmx.rng.seed(4)
    jnet.initialize()
    pnet = nn.Dense(1, in_units=2)
    pnet.initialize(ctx=CPU)
    models.load_gluon_params(pnet, _arrays(jnet), ctx=CPU)
    jtr = JTrainer(jnet.collect_params(), "sgd", {"learning_rate": 0.1},
                   kvstore=None)
    ptr = Trainer(pnet.collect_params(), "sgd", {"learning_rate": 0.1},
                  kvstore=None)
    return (jnet, jtr), (pnet, ptr)


def _weight(net):
    return net.collect_params()["weight"].data().asnumpy().copy()


def test_fp16_loss_scaling_trains_and_handles_overflow():
    jmx.amp.init(target_dtype="float16")
    amp.init(target_dtype="float16")
    (jnet, jtr), (pnet, ptr) = _dense_pair()
    jmx.amp.init_trainer(jtr)
    amp.init_trainer(ptr)
    scaler = ptr._amp_loss_scaler
    assert scaler.loss_scale == jtr._amp_loss_scaler.loss_scale > 1.0
    jx, px = jmx.nd.array([[1.0, 2.0]]), mx.nd.array([[1.0, 2.0]], ctx=CPU)
    w0 = _weight(pnet)

    def step(mult):
        with jmx.autograd.record():
            loss = (jnet(jx) * mult).sum() ** 2
            with jmx.amp.scale_loss(loss, jtr) as scaled:
                jmx.autograd.backward(scaled)
        jtr.step(1)
        with mx.autograd.record():
            loss = (pnet(px) * mult).sum() ** 2
            with amp.scale_loss(loss, ptr) as scaled:
                mx.autograd.backward(scaled)
        ptr.step(1)

    step(1.0)
    w1 = _weight(pnet)
    assert not np.allclose(w0, w1)
    np.testing.assert_allclose(w1, _weight(jnet), rtol=1e-6)
    # the update is the unscaled one: a Trainer without amp
    (_, _), (plain, ptr2) = _dense_pair()
    with mx.autograd.record():
        loss = (plain(px) ** 2).sum()
    loss.backward()
    ptr2.step(1)
    np.testing.assert_allclose(w1, _weight(plain), rtol=1e-3)
    # overflow: the update is skipped, the scale halves, both packages
    before = scaler.loss_scale
    step(np.inf)
    assert scaler.loss_scale == before / 2 == jtr._amp_loss_scaler.loss_scale
    np.testing.assert_array_equal(_weight(pnet), w1)
    step(1.0)   # and training goes on
    np.testing.assert_allclose(_weight(pnet), _weight(jnet), rtol=1e-6)


def test_unscale_before_step():
    amp.init(target_dtype="float16")
    jmx.amp.init(target_dtype="float16")
    (jnet, jtr), (pnet, ptr) = _dense_pair()
    jmx.amp.init_trainer(jtr)
    amp.init_trainer(ptr)
    jx, px = jmx.nd.array([[3.0, -1.0]]), mx.nd.array([[3.0, -1.0]], ctx=CPU)
    with jmx.autograd.record():
        with jmx.amp.scale_loss(jnet(jx).sum(), jtr) as s:
            s.backward()
    with mx.autograd.record():
        with amp.scale_loss([pnet(px).sum()], ptr) as s:
            assert isinstance(s, list)
            s[0].backward()
    jmx.amp.unscale(jtr)
    amp.unscale(ptr)
    g = pnet.collect_params()["weight"].grad().asnumpy()
    np.testing.assert_allclose(g, [[3.0, -1.0]], rtol=1e-6)
    np.testing.assert_allclose(
        g, jnet.collect_params()["weight"].grad().asnumpy(), rtol=1e-6)
    jtr.step(1)
    ptr.step(1)   # no second division by the scale
    np.testing.assert_allclose(_weight(pnet), _weight(jnet), rtol=1e-6)
    assert ptr._amp_loss_scaler._unscaled is False


def test_fp16_converted_net_trains_like_the_reference():
    """A float16 net (BatchNorm kept float32) through Trainer + the
    dynamic scaler, 3 steps and an overflow, in both packages: the scale
    sequence exactly, losses within float16's 2e-3."""
    jmx.amp.init("float16")
    amp.init("float16")
    jnet, pnet = _tiny_pair()
    jmx.amp.convert_model(jnet)
    amp.convert_model(pnet)
    jtr = JTrainer(jnet.collect_params(), "sgd", {"learning_rate": 0.05},
                   kvstore=None)
    ptr = Trainer(pnet.collect_params(), "sgd", {"learning_rate": 0.05},
                  kvstore=None)
    jmx.amp.init_trainer(jtr, JaxScaler(init_scale=1024.0, scale_window=2))
    amp.init_trainer(ptr, LossScaler(init_scale=1024.0, scale_window=2))
    r = np.random.default_rng(5)
    x = r.standard_normal((6, 4)).astype(np.float16)
    for mult in (1.0, 1.0, np.inf, 1.0):
        with jmx.autograd.record():
            jl = (jnet(jmx.nd.array(x, dtype="float16")) * mult).sum()
            with jmx.amp.scale_loss(jl, jtr) as s:
                s.backward()
        jtr.step(6)
        with mx.autograd.record():
            pl = (pnet(mx.nd.array(x, ctx=CPU, dtype="float16")) *
                  mult).sum()
            with amp.scale_loss(pl, ptr) as s:
                s.backward()
        ptr.step(6)
        assert ptr._amp_loss_scaler.loss_scale == \
            jtr._amp_loss_scaler.loss_scale
        if np.isfinite(mult):
            np.testing.assert_allclose(float(pl.asscalar()),
                                       float(jl.asscalar()), rtol=2e-3,
                                       atol=2e-3)
    assert ptr._amp_loss_scaler.loss_scale == 1024.0   # 2x, then halved


def test_amp_requires_init_and_init_trainer():
    amp._state.update(initialized=False, target_dtype=None)
    with pytest.raises(MXNetError, match="amp.init"):
        amp.convert_model(nn.Dense(1, in_units=1))
    with pytest.raises(MXNetError, match="target_dtype"):
        amp.init("int8")
    amp.init()
    net = nn.Dense(1, in_units=1)
    net.initialize(ctx=CPU)
    tr = Trainer(net.collect_params(), "sgd", kvstore=None)
    with pytest.raises(MXNetError, match="init_trainer"):
        with amp.scale_loss(mx.nd.array([1.0], ctx=CPU), tr):
            pass
    amp.init_trainer(tr)
    assert tr._amp_loss_scaler.is_noop   # bfloat16: scale 1.0, no check


def test_float16_never_reaches_the_fused_kernel():
    q = torch.zeros(1, 4, 2, 8, dtype=torch.float16)
    with pytest.raises(MXNetError):
        port_nn_ops.dot_product_attention(q, q, q, impl="fused",
                                          layout="BTHD")
    out = port_nn_ops.dot_product_attention(q, q, q, layout="BTHD")
    assert out.dtype == torch.float16
