"""The port's gluon surface against the JAX package: Block and Parameter,
gluon.nn layers, losses, initializers and the 'flash' attention route.

* collect_params(): the names and their order equal the JAX package's
  for BERT, GPT-2, NMT, ResNet-18 v1b and SSD at small sizes; `select`.
* layers: each gluon.nn layer (deferred shapes) between two Dense or a
  Conv2D and a Dense, and a user Block with its own Parameters and an
  Embedding, their weights carried across with
  models.load_gluon_params: outputs within 1e-6 relative to the largest
  magnitude, gradients within 1e-5 of the net's largest (of the
  tensor's largest for the user block), running statistics within
  1e-6, in train and predict mode; deferred shapes after the first
  call; hooks; hybridize (flags, same values); summary.
* the training-mode rule, both directions: dropout and batch statistics
  are on in train() mode (parallel.TrainStep) or under autograd training
  (a gluon user), off otherwise (the serving engine).
* losses: every loss of gluon.loss, values and input gradients within
  1e-6 relative.
* initializers: the deterministic ones exactly; the random ones by
  shape, dtype, moments and determinism under mx.random.seed.
* 'flash': dot_product_attention(impl="flash") against the reference's
  flash_attention_data (T 64-300, causal and not, key-padding and
  general masks) within 1e-5.
* no fallback: without a card a model with no device raises, and no
  source of the port or chip_smoke.py imports jax or mxnet_tpu.
"""
import ast
import gc
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu import models as jmodels  # noqa: E402
from mxnet_tpu.gluon import loss as jloss  # noqa: E402
from mxnet_tpu.gluon import nn as jnn  # noqa: E402
from mxnet_tpu.models import vision as jvision  # noqa: E402
from mxnet_tpu.ops import attention as jatt  # noqa: E402

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import MXNetError, autograd, gluon  # noqa: E402
from mxnet_tpu_torch import initializer as pinit  # noqa: E402
from mxnet_tpu_torch import models  # noqa: E402
from mxnet_tpu_torch.gluon import loss as ploss  # noqa: E402
from mxnet_tpu_torch.gluon import nn  # noqa: E402
from mxnet_tpu_torch.models import vision  # noqa: E402
from mxnet_tpu_torch.ops import nn as port_nn  # noqa: E402

CPU = mx.cpu()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _arrays(jnet):
    return {n: np.array(p.data().asnumpy())
            for n, p in jnet.collect_params().items()}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


# ---------------------------------------------------------------------------
# collect_params: names and order
# ---------------------------------------------------------------------------

BERT_KW = dict(vocab_size=50, units=16, hidden_size=32, num_layers=1,
               num_heads=2, max_length=16, dropout=0.0,
               attention_dropout=0.0)
GPT_KW = dict(vocab_size=50, units=16, num_layers=2, num_heads=2,
              max_length=16)
NMT_KW = dict(src_vocab_size=20, tgt_vocab_size=20, units=16,
              hidden_size=32, enc_layers=1, dec_layers=1, num_heads=2,
              max_length=16)
ZOO = {
    "bert": (lambda: jmodels.BertForMaskedLM(jmodels.BertConfig(**BERT_KW)),
             lambda: models.BertForMaskedLM(models.BertConfig(**BERT_KW),
                                            device="cpu")),
    "gpt2": (lambda: jmodels.GPT2ForCausalLM(jmodels.GPT2Config(**GPT_KW)),
             lambda: models.GPT2ForCausalLM(models.GPT2Config(**GPT_KW),
                                            device="cpu")),
    "nmt": (lambda: jmodels.TransformerNMT(jmodels.NMTConfig(**NMT_KW)),
            lambda: models.TransformerNMT(models.NMTConfig(**NMT_KW),
                                          device="cpu")),
    "resnet18_v1b": (lambda: jvision.resnet18_v1b(classes=10),
                     lambda: vision.resnet18_v1b(classes=10, device="cpu")),
    "ssd": (lambda: jvision.ssd_512_resnet50_v1(classes=3, num_extras=2),
            lambda: vision.ssd_512_resnet50_v1(classes=3, num_extras=2,
                                               device="cpu")),
}


@pytest.mark.parametrize("name", sorted(ZOO))
def test_collect_params_names_and_order(name):
    jctor, pctor = ZOO[name]
    jnet, pnet = jctor(), pctor()
    want = list(jnet.collect_params().keys())
    got = list(pnet.collect_params().keys())
    assert got == want
    # one storage: the gluon view, named_parameters and TrainStep's list
    named = dict(pnet.named_parameters())
    assert list(named) == got
    for n, p in pnet.collect_params().items():
        assert p.var is named[n] and p.data()._data is named[n]
    sel = pnet.collect_params(".*weight$")
    assert list(sel) == [n for n in got if n.endswith("weight")]
    del jnet
    gc.collect()


def test_tied_embedding_is_one_parameter():
    net = models.BertForMaskedLM(models.BertConfig(**BERT_KW), device="cpu")
    params = net.collect_params()
    assert "backbone.word_embed.weight" in params
    assert not any(n.startswith("mlm.decoder.") for n in params)


# ---------------------------------------------------------------------------
# layers and blocks against the reference
# ---------------------------------------------------------------------------

# each layer between two Dense (or a Conv2D and a Dense), so that no
# gradient is structurally zero; (factory over the gluon.nn module, 4-D)
LAYERS = {
    "Dense_act": (lambda g: g.Dense(6, activation="sigmoid"), False),
    "Conv2D_act": (lambda g: g.Conv2D(4, 3, padding=1, activation="relu"),
                   True),
    "BatchNorm": (lambda g: g.BatchNorm(), True),
    "GroupNorm": (lambda g: g.GroupNorm(num_groups=2), True),
    "InstanceNorm": (lambda g: g.InstanceNorm(scale=True), True),
    "LayerNorm": (lambda g: g.LayerNorm(), False),
    "RMSNorm": (lambda g: g.RMSNorm(), False),
    "Activation": (lambda g: g.Activation("softrelu"), False),
    "LeakyReLU": (lambda g: g.LeakyReLU(0.2), False),
    "ELU": (lambda g: g.ELU(0.5), False),
    "SELU": (lambda g: g.SELU(), False),
    "Swish": (lambda g: g.Swish(), False),
    "GELU": (lambda g: g.GELU(), False),
    "MaxPool2D": (lambda g: g.MaxPool2D(), True),
    "AvgPool2D": (lambda g: g.AvgPool2D(padding=1, strides=1), True),
    "GlobalAvgPool2D": (lambda g: g.GlobalAvgPool2D(), True),
    "Dropout": (lambda g: g.Dropout(0.0), False),
}


def _layer_net(m, name):
    g = m.gluon.nn
    make, four_d = LAYERS[name]
    net = g.HybridSequential()
    if four_d:
        net.add(g.Conv2D(4, 3, padding=1), make(g), g.Flatten(),
                g.Dense(3))
    else:
        net.add(g.Dense(8), make(g), g.Dense(3))
    return net


class _UserBlock:
    """A user Block with its own Parameters and a gluon child, built in
    either package."""

    @staticmethod
    def make(m):
        gl = m.gluon

        class Net(gl.HybridBlock):
            def __init__(self):
                super().__init__()
                self.scale = gl.Parameter("scale", shape=(4,))
                self.proj = gl.nn.Dense(4, in_units=3)
                self.emb = gl.nn.Embedding(7, 3)

            def forward(self, ids, x):
                h = self.emb(ids).sum(axis=1) + x
                return m.nd.tanh(self.proj(h)) * self.scale.data()
        return Net()


def _cases():
    r = np.random.default_rng(0)
    return (r.standard_normal((2, 3, 8, 8)).astype(np.float32),
            r.integers(0, 7, (2, 5)).astype(np.int32),
            r.standard_normal((2, 3)).astype(np.float32))


def _run(m, net, inputs, train):
    nd = [mx.nd.array(a, ctx=CPU, dtype=a.dtype) if m is mx
          else m.nd.array(a, dtype=a.dtype) for a in inputs]
    params = net.collect_params()
    for p in params.values():
        if p.grad_req != "null":
            p.zero_grad()
    with m.autograd.record(train_mode=train):
        out = net(*nd)
        loss = (out * out).sum()
    loss.backward()
    grads = {n: p.grad().asnumpy() for n, p in params.items()
             if p.grad_req != "null"}
    stats = {n: p.data().asnumpy() for n, p in params.items()
             if n.endswith(("running_mean", "running_var"))}
    return out.asnumpy(), grads, stats


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layers_match_reference(name, train):
    """Output within 1e-6 and every gradient within 1e-5 of the net's
    largest gradient; running statistics within 1e-6."""
    x = _cases()[0]
    x = x if LAYERS[name][1] else x.reshape(2, -1)
    jnet = _layer_net(jmx, name)
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(x))                 # resolve the deferred shapes
    arrays = _arrays(jnet)
    pnet = _layer_net(mx, name)
    models.load_gluon_params(pnet, arrays, ctx=CPU)
    got = _run(mx, pnet, [x], train)
    want = _run(jmx, jnet, [x], train)
    assert _rel(got[0], want[0]) <= 1e-6
    top = max(float(np.abs(g).max()) for g in want[1].values())
    for n in want[1]:
        err = float(np.abs(got[1][n] - want[1][n]).max())
        assert err <= 1e-5 * top, (n, err, top)
    for n in want[2]:
        assert _rel(got[2][n], want[2][n]) <= 1e-6, n


def test_user_block_with_own_parameters():
    x, ids, h = _cases()
    jnet = _UserBlock.make(jmx)
    jnet.initialize(jmx.init.Normal(0.5))
    arrays = _arrays(jnet)
    pnet = _UserBlock.make(mx)
    assert list(pnet.collect_params()) == list(arrays)
    models.load_gluon_params(pnet, arrays, ctx=CPU)
    got = _run(mx, pnet, [ids, h], True)
    want = _run(jmx, jnet, [ids, h], True)
    assert _rel(got[0], want[0]) <= 1e-6
    for n in want[1]:
        assert _rel(got[1][n], want[1][n]) <= 1e-5, n
    with pytest.raises(MXNetError, match="missing"):
        models.load_gluon_params(_UserBlock.make(mx), {}, ctx=CPU)
    bad = dict(arrays, scale=np.zeros(5, np.float32))
    with pytest.raises(MXNetError, match="shape"):
        models.load_gluon_params(_UserBlock.make(mx), bad, ctx=CPU)


def test_deferred_shapes_and_initialize():
    net = nn.HybridSequential()
    net.add(nn.Dense(5, activation="relu"), nn.Dense(2, flatten=False))
    with pytest.raises(MXNetError, match="initialize"):
        net(mx.nd.ones((3, 4, 2), ctx=CPU))
    net = nn.HybridSequential()
    net.add(nn.Dense(5, activation="relu"), nn.Dense(2, flatten=False))
    net.initialize(mx.init.Xavier(), ctx=CPU)
    with pytest.raises(gluon.DeferredInitializationError):
        net.collect_params()["0.weight"].data()
    out = net(mx.nd.ones((3, 4, 2), ctx=CPU))
    assert out.shape == (3, 2)
    shapes = {n: p.shape for n, p in net.collect_params().items()}
    assert shapes == {"0.weight": (5, 8), "0.bias": (5,),
                      "1.weight": (2, 5), "1.bias": (2,)}
    assert all(p.data().context == CPU
               for p in net.collect_params().values())
    jnet = jnn.HybridSequential()
    jnet.add(jnn.Dense(5, activation="relu"), jnn.Dense(2, flatten=False))
    jnet.initialize()
    jnet(jmx.nd.ones((3, 4, 2)))
    assert shapes == {n: p.shape for n, p in jnet.collect_params().items()}
    # a second initialize keeps the weights; force_reinit redraws them
    w = net[0].weight.detach().clone()
    net.initialize(mx.init.Xavier(), ctx=CPU)
    assert torch.equal(net[0].weight, w)
    net.initialize(mx.init.Xavier(), ctx=CPU, force_reinit=True)
    assert not torch.equal(net[0].weight, w)


def test_hooks_hybridize_summary(capsys, tmp_path):
    net = nn.HybridSequential()
    net.add(nn.Dense(4, in_units=3), nn.Dense(2, in_units=4))
    net.initialize(ctx=CPU)
    x = mx.nd.ones((2, 3), ctx=CPU)
    seen = []
    h = net[0].register_forward_hook(
        lambda blk, args, out: seen.append((type(args[0]).__name__,
                                            tuple(out.shape))))
    pre = net.register_forward_pre_hook(lambda blk, args: seen.append("pre"))
    a = net(x).asnumpy()
    h.detach()
    pre.detach()
    net(x)
    assert seen == ["pre", ("Tensor", (2, 4))]
    net.hybridize(static_alloc=True)
    assert net._hybrid_active and net[1]._hybrid_active
    np.testing.assert_array_equal(net(x).asnumpy(), a)
    net.summary(x)
    assert "Total params: 26" in capsys.readouterr().out
    with pytest.raises(MXNetError, match="not ported"):
        net.export("x")
    # parameters save and load (tests/test_torch_serialization.py)
    f = str(tmp_path / "net.params")
    net.save_parameters(f)
    net.load_parameters(f)
    np.testing.assert_array_equal(net(x).asnumpy(), a)


def test_grad_req_lr_mult_on_the_torch_parameter():
    net = nn.Dense(3, in_units=2)
    net.initialize(ctx=CPU)
    p = net.collect_params()["weight"]
    p.lr_mult = 0.5
    assert net.weight.lr_mult == 0.5        # where TrainStep reads it
    p.grad_req = "null"
    assert not net.weight.requires_grad
    p.grad_req = "add"
    x = mx.nd.ones((4, 2), ctx=CPU)
    for _ in range(2):
        with autograd.record():
            y = net(x).sum()
        y.backward()
    np.testing.assert_allclose(p.grad().asnumpy(), 8.0)
    net.cast("bfloat16")
    assert p.data().dtype == torch.bfloat16 and net.weight.dtype == \
        torch.bfloat16


# ---------------------------------------------------------------------------
# the training-mode rule
# ---------------------------------------------------------------------------

def test_training_rule_both_directions():
    cfg = models.BertConfig(**dict(BERT_KW, dropout=0.5,
                                   attention_dropout=0.5))
    net = models.BertForMaskedLM(cfg, device="cpu")
    ids = torch.randint(0, 50, (2, 16), dtype=torch.int32)
    assert not net.training
    with torch.no_grad():
        a, b = net(ids), net(ids)          # the serving engine's view
    assert torch.equal(a, b)
    nd_ids = mx.nd.array(ids.numpy(), ctx=CPU, dtype="int32")
    with autograd.record(train_mode=False):
        c = net(nd_ids)
    assert torch.equal(c._data, a)
    with autograd.record():                # a gluon user: dropout on
        d = net(nd_ids)
    assert not torch.equal(d._data, a)
    net.train()                            # TrainStep's view: dropout on
    with torch.no_grad():
        e = net(ids)
    assert not torch.equal(e, a)
    bn = nn.BatchNorm(in_channels=2)
    bn.initialize(ctx=CPU)
    x = mx.nd.array(np.arange(8, dtype=np.float32).reshape(4, 2), ctx=CPU)
    bn(x)
    np.testing.assert_array_equal(bn.running_mean.detach().numpy(), 0)
    with autograd.record():
        bn(x)
    np.testing.assert_allclose(bn.running_mean.detach().numpy(),
                               [0.3, 0.4], rtol=1e-6)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

R = np.random.default_rng(1)
P = R.standard_normal((4, 5)).astype(np.float32)
L = R.standard_normal((4, 5)).astype(np.float32)
SIGN = np.sign(R.standard_normal((4, 5))).astype(np.float32)
PROB = 1 / (1 + np.exp(-P))
DIST = np.exp(L) / np.exp(L).sum(1, keepdims=True)
CTC_PRED = R.standard_normal((2, 6, 5)).astype(np.float32)
CTC_LABEL = np.array([[1, 2, 2, -1], [3, 1, -1, -1]], np.float32)
LOSSES = {
    "L2Loss": ((), (P, L)),
    "L1Loss": ((), (P, L)),
    "SigmoidBinaryCrossEntropyLoss": ((), (P, (L > 0).astype(np.float32))),
    "SigmoidBCELoss_from_sigmoid": (dict(from_sigmoid=True),
                                    (PROB, (L > 0).astype(np.float32))),
    "SoftmaxCrossEntropyLoss": ((), (P, np.array([0, 4, 2, 1],
                                                 np.float32))),
    "KLDivLoss": (dict(from_logits=False), (P, DIST)),
    "CTCLoss": ((), (CTC_PRED, CTC_LABEL)),
    "HuberLoss": (dict(rho=0.5), (P, L)),
    "HingeLoss": ((), (P, SIGN)),
    "SquaredHingeLoss": ((), (P, SIGN)),
    "LogisticLoss": ((), (P, SIGN)),
    "TripletLoss": ((), (P, L, L[::-1].copy())),
    "PoissonNLLLoss": (dict(compute_full=True), (P, np.abs(L) * 3)),
    "CosineEmbeddingLoss": ((), (P, L, np.array([1, -1, 1, -1],
                                                np.float32))),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_matches_reference(name):
    kw, arrays = LOSSES[name]
    cls = name.replace("_from_sigmoid", "").replace("SigmoidBCELoss",
                                                    "SigmoidBCELoss")
    kw = dict(kw) if kw else {}

    def run(m, mod):
        nds = [mx.nd.array(a, ctx=CPU) if m is mx else m.nd.array(a)
               for a in arrays]
        nds[0].attach_grad()
        with m.autograd.record():
            out = getattr(mod, cls)(**kw)(*nds)
        out.backward()
        return out.asnumpy(), nds[0].grad.asnumpy()
    got, want = run(mx, ploss), run(jmx, jloss)
    assert _rel(got[0], want[0]) <= 1e-6
    assert _rel(got[1], want[1]) <= 1e-6


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

DETERMINISTIC = [("Zero", (), (3, 4)), ("One", (), (3, 4)),
                 ("Constant", (0.25,), (3, 4)), ("Identity", (2,), (3, 4)),
                 ("Bilinear", (), (2, 1, 4, 4)), ("LSTMBias", (1.5,), (8,))]


@pytest.mark.parametrize("name,args,shape", DETERMINISTIC)
def test_deterministic_initializers_exact(name, args, shape):
    want = getattr(jmx.init, name)(*args)("w", shape, "float32",
                                          force_weight=True)
    p = torch.empty(shape)
    getattr(pinit, name)(*args)("w", p, None, force_weight=True)
    np.testing.assert_array_equal(p.numpy(), want)


def test_suffix_dispatch_and_mixed_and_registry():
    for name, fill in (("layer.bias", 0.0), ("ln.gamma", 1.0),
                       ("ln.beta", 0.0), ("bn.running_var", 1.0),
                       ("bn.running_mean", 0.0)):
        p = torch.full((3,), 7.0)
        pinit.Normal(1.0)(name, p, torch.Generator())
        np.testing.assert_array_equal(p.numpy(), fill)
    mixed = pinit.Mixed([".*bias", ".*"], [pinit.One(), pinit.Constant(2)])
    a, b = torch.zeros(2), torch.zeros(2)
    mixed("x.bias", a)
    mixed("x.weight", b)
    assert a.tolist() == [0.0, 0.0] and b.tolist() == [2.0, 2.0]
    assert isinstance(pinit.get("xavier"), pinit.Xavier)
    assert isinstance(pinit.get("zeros"), pinit.Zero)
    assert isinstance(pinit.create("msraprelu"), pinit.MSRAPrelu)


RANDOM_INITS = [("Uniform", (0.3,), 0.0, 0.3 ** 2 / 3),
                ("Normal", (0.2,), 0.0, 0.04),
                ("Xavier", ("gaussian", "avg", 2.0), 0.0, 2.0 / 300),
                ("MSRAPrelu", (), 0.0, (2.0 / (1 + 0.0625)) / 300),
                ("Orthogonal", (), None, None)]


@pytest.mark.parametrize("name,args,mean,var", RANDOM_INITS)
def test_random_initializers(name, args, mean, var):
    def draw(seed):
        net = nn.Dense(200, in_units=400)
        mx.random.seed(seed)
        net.initialize(getattr(mx.init, name)(*args), ctx=CPU)
        return net.weight.detach().numpy().copy()
    w = draw(5)
    assert w.shape == (200, 400) and w.dtype == np.float32
    np.testing.assert_array_equal(w, draw(5))
    assert not np.array_equal(w, draw(6))
    if name == "Orthogonal":
        np.testing.assert_allclose(w @ w.T, 1.414 ** 2 * np.eye(200),
                                   atol=1e-4)
        return
    assert abs(w.mean() - mean) < 5 * np.sqrt(var / w.size)
    assert abs(w.var() / var - 1) < 0.05


# ---------------------------------------------------------------------------
# the 'flash' route
# ---------------------------------------------------------------------------

FLASH = [(64, False, "none"), (128, True, "none"), (300, False, "keys"),
         (200, True, "keys"), (96, False, "general"), (257, True, "general")]


@pytest.mark.parametrize("T,causal,mask", FLASH)
def test_flash_route_matches_reference(T, causal, mask):
    r = np.random.default_rng(T)
    B, H, D = 2, 2, 16
    q, k, v = (r.standard_normal((B, H, T, D)).astype(np.float32)
               for _ in range(3))
    m = None
    if mask == "keys":
        m = np.arange(T)[None, :] < np.array([T, T // 3])[:, None]
    elif mask == "general":
        m = r.random((B, 1, T, T)) > 0.3
    want = jatt.flash_attention_data(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        mask=None if m is None else jnp.asarray(
            m[:, None, None, :] if m.ndim == 2 else m), causal=causal)
    got = port_nn.dot_product_attention(
        *map(torch.from_numpy, (q, k, v)),
        None if m is None else torch.from_numpy(m), causal=causal,
        impl="flash")
    assert _rel(got.numpy(), np.asarray(want)) <= 1e-5
    # the registered op, over NDArrays, takes the same route
    nd = mx.nd.dot_product_attention(
        *(mx.nd.array(a, ctx=CPU) for a in (q, k, v)),
        causal=causal, impl="flash")
    want_nd = port_nn.dot_product_attention(
        *map(torch.from_numpy, (q, k, v)), causal=causal, impl="flash")
    assert torch.equal(nd._data, want_nd)


def test_flash_with_dropout_takes_the_plain_path():
    q = torch.randn(1, 2, 8, 4)
    with pytest.raises(MXNetError, match="does not take"):
        port_nn.dot_product_attention(q, q, q, torch.ones(1, 1, 8, 8,
                                                          dtype=torch.bool),
                                      impl="fused")
    out = port_nn.dot_product_attention(q, q, q, dropout_p=0.0,
                                        impl="flash")
    assert torch.equal(out, port_nn.dot_product_attention(q, q, q))


# ---------------------------------------------------------------------------
# no fallback, no jax
# ---------------------------------------------------------------------------

def test_no_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(MXNetError):
        models.BertForMaskedLM(models.BertConfig(**BERT_KW))
    net = nn.Dense(3, in_units=2)
    with pytest.raises(MXNetError):
        net.initialize()


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_and_chip_smoke_import_no_jax():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "mxnet_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    bad = [(f, m) for f in files for m in _imports(f)
           if m == "jax" or m.startswith(("jax.", "jaxlib"))
           or m == "mxnet_tpu" or m.startswith("mxnet_tpu.")]
    assert len(files) > 50 and bad == []
