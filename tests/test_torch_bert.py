"""The port's BERT MLM training step against the JAX package.

A tiny BertForMaskedLM (2 layers, 128 units, 2 heads, vocab 1000, 64
positions) is built and seeded in the JAX package; its parameters cross
over as numpy arrays (models/convert.load_jax_params). With dropout 0
both packages then compute the same functions: MLM logits over ragged
valid lengths at 1e-5, the softmax cross-entropy, AdamW's functional
update (float32 and the bfloat16-weight / float32-master layout) at
1e-6, and three TrainStep steps (losses and every parameter at 1e-5).
The port runs on the CPU, where attention takes the fused kernel's plain
version.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu import optimizer as jopt  # noqa: E402
from mxnet_tpu import parallel as jpar  # noqa: E402
from mxnet_tpu.gluon import loss as jloss  # noqa: E402
from mxnet_tpu.gluon.nn import transformer as jax_tf  # noqa: E402
from mxnet_tpu.models import BertConfig as JaxConfig  # noqa: E402
from mxnet_tpu.models import BertForMaskedLM as JaxBert  # noqa: E402
from mxnet_tpu.ops import nn as jax_nn  # noqa: E402
from mxnet_tpu_torch import MXNetError, rng  # noqa: E402
from mxnet_tpu_torch.loss import SoftmaxCrossEntropyLoss  # noqa: E402
from mxnet_tpu_torch.models import (BertConfig, BertForMaskedLM,  # noqa: E402
                                    BertModel, bert_base_config, init_params,
                                    load_jax_params)
from mxnet_tpu_torch.nn import TransformerEncoderLayer  # noqa: E402
from mxnet_tpu_torch.ops import fused_attention as fa  # noqa: E402
from mxnet_tpu_torch.ops import nn as port_nn  # noqa: E402
from mxnet_tpu_torch.optimizer import AdamW, create  # noqa: E402
from mxnet_tpu_torch.parallel import TrainStep  # noqa: E402

KW = dict(vocab_size=1000, units=128, hidden_size=512, num_layers=2,
          num_heads=2, max_length=64, dropout=0.0, attention_dropout=0.0)
B, T, M = 4, 64, 8


@pytest.fixture(scope="module")
def jax_pair():
    """(JAX net, its params as numpy)."""
    jnet = JaxBert(JaxConfig(**KW))
    mx.rng.seed(3)
    jnet.initialize(mx.init.Normal(0.02))
    arrays = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    return jnet, arrays


def _port(arrays, **kw):
    return load_jax_params(
        BertForMaskedLM(BertConfig(**dict(KW, **kw)), device="cpu"), arrays)


def _batch(seed=0, lengths=(64, 40, 17, 1)):
    """ids, token types, valid lengths, masked positions (below each
    row's valid length), labels — int32 numpy."""
    r = np.random.default_rng(seed)
    ids = r.integers(0, KW["vocab_size"], (B, T)).astype(np.int32)
    tt = r.integers(0, 2, (B, T)).astype(np.int32)
    vl = np.asarray(lengths, np.int32)
    pos = np.stack([np.sort(r.choice(max(n, M), M, replace=False))
                    for n in vl]).astype(np.int32)
    lab = r.integers(0, KW["vocab_size"], (B, M)).astype(np.int32)
    return ids, tt, vl, pos, lab


def _jax_args(batch):
    return [mx.nd.array(a, dtype="int32") for a in batch]


def _torch_args(batch):
    return [torch.from_numpy(a) for a in batch]


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def test_parameter_names_and_tied_decoder(jax_pair):
    _, arrays = jax_pair
    net = _port(arrays)
    names = [n for n, _ in net.named_parameters()]
    assert len(names) == len(set(names))
    assert {n: tuple(p.shape) for n, p in net.named_parameters()} == \
        {n: a.shape for n, a in arrays.items()}
    # the decoder is the word embedding itself, registered once
    assert net.mlm._word_embed.weight is net.backbone.word_embed.weight
    assert "_word_embed" not in dict(net.mlm.named_children())
    assert sum(p is net.backbone.word_embed.weight
               for p in net.parameters()) == 1


def test_init_params_zeroes_decoder_bias():
    net = BertForMaskedLM(BertConfig(**KW), device="cpu")
    p = dict(net.named_parameters())
    assert bool((p["mlm.decoder_bias"] == 0).all())
    assert bool((p["backbone.embed_ln.gamma"] == 1).all())
    assert bool((p["backbone.encoder.layer1.ffn.fc2.bias"] == 0).all())
    w = p["backbone.encoder.layer0.attn.query.weight"]
    assert abs(float(w.detach().std()) - 0.02) < 0.005
    again = dict(init_params(BertForMaskedLM(BertConfig(**KW), device="cpu"),
                             seed=0).named_parameters())
    assert all(torch.equal(p[n], again[n]) for n in p)
    assert all(q.requires_grad for q in p.values())
    assert not net.training                     # dropout off until train()
    with pytest.raises(MXNetError, match="not ported"):
        BertModel(BertConfig(**KW), use_pooler=True)


def test_serving_stays_out_of_autograd():
    """Parameters are trainable now; a serve with grad mode on must still
    build no graph: the KV pools it writes stay leaves that do not
    require grad."""
    from mxnet_tpu_torch.models import GPT2Config, GPT2ForCausalLM
    from mxnet_tpu_torch.serving import Request, ServingEngine
    net = init_params(GPT2ForCausalLM(GPT2Config(
        vocab_size=97, units=32, num_layers=2, num_heads=2, max_length=64,
        dropout=0.0, attention_dropout=0.0), device="cpu"), seed=0)
    assert all(p.requires_grad for p in net.parameters())
    assert torch.is_grad_enabled()
    eng = ServingEngine(net, num_slots=2, max_length=64, page_size=8,
                        device="cpu")
    reqs = [Request([1, 2, 3], 4, request_id=0),
            Request([5, 6], 3, request_id=1)]
    eng.serve(reqs)
    assert [len(r.output_tokens) for r in reqs] == [4, 3]
    assert not eng._kp.requires_grad and not eng._vp.requires_grad
    assert eng._kp.grad_fn is None and eng._vp.grad_fn is None


def test_base_config_widths():
    c = bert_base_config()
    assert (c.num_layers, c.units, c.num_heads, c.hidden_size, c.vocab_size,
            c.max_length) == (12, 768, 12, 3072, 30522, 512)
    assert c.num_params() == JaxConfig().num_params()


# ---------------------------------------------------------------------------
# forward and loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [True, False], ids=["masked", "all"])
def test_mlm_logits_match_jax(jax_pair, masked):
    jnet, arrays = jax_pair
    net = _port(arrays)
    batch = _batch(1)
    n = 4 if masked else 3
    want = jnet(*_jax_args(batch[:n])).asnumpy()
    with torch.no_grad():
        got = net(*_torch_args(batch[:n])).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pre_norm", [False, True], ids=["post", "pre"])
def test_encoder_layer_matches_jax(pre_norm):
    """One encoder layer alone, post-LN (BERT) and pre-LN, with a
    key-padding mask."""
    ref = jax_tf.TransformerEncoderLayer(32, 64, 2, pre_norm=pre_norm,
                                         activation="gelu_tanh")
    mx.rng.seed(4)
    ref.initialize(mx.init.Normal(0.1))
    r = np.random.default_rng(7)
    x = r.standard_normal((2, 8, 32)).astype(np.float32)
    mask = np.arange(8)[None, :] < np.array([[8], [3]])
    want = ref(mx.nd.array(x), mx.nd.array(mask)).asnumpy()
    layer = load_jax_params(
        TransformerEncoderLayer(32, 64, 2, pre_norm=pre_norm,
                                activation="gelu_tanh"),
        {n: p.data().asnumpy() for n, p in ref.collect_params().items()})
    with torch.no_grad():
        got = layer(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_softmax_ce_matches_jax():
    r = np.random.default_rng(2)
    pred = r.standard_normal((3, 5, 11)).astype(np.float32) * 3
    label = r.integers(0, 11, (3, 5)).astype(np.int32)
    sw = r.random((3, 5)).astype(np.float32)
    for kw, args in (({}, ()), ({"weight": 0.5}, (sw,))):
        want = jloss.SoftmaxCrossEntropyLoss(**kw)(
            mx.nd.array(pred), mx.nd.array(label, dtype="int32"),
            *(mx.nd.array(a) for a in args)).asnumpy()
        got = SoftmaxCrossEntropyLoss(**kw)(
            torch.from_numpy(pred), torch.from_numpy(label),
            *(torch.from_numpy(a) for a in args)).numpy()
        assert got.shape == (3,)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_ops_match_jax():
    r = np.random.default_rng(3)
    x = r.standard_normal((4, 33)).astype(np.float32)
    np.testing.assert_allclose(
        port_nn.gelu(torch.from_numpy(x), approximate=True).numpy(),
        np.asarray(jax_nn.gelu(jnp.asarray(x), approximate=True)),
        rtol=1e-6, atol=1e-6)


def test_dot_product_attention_routes(jax_pair):
    """A key-padding call goes to the fused function (its plain version
    on the CPU); a per-query mask goes to the plain softmax attention,
    which matches the reference's 'xla' path, and raises where 'fused'
    is asked for; unported impls raise."""
    r = np.random.default_rng(4)
    q, k, v = (r.standard_normal((2, 16, 2, 64)).astype(np.float32)
               for _ in range(3))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    kp = torch.arange(16)[None, :] < torch.tensor([16, 5])[:, None]
    got = port_nn.dot_product_attention(tq, tk, tv, kp, layout="BTHD")
    assert torch.equal(got, fa.fused_attention(tq, tk, tv, mask=kp,
                                               layout="BTHD"))
    full = np.tril(np.ones((16, 16), bool))[None, None].repeat(2, 0)
    want = jax_nn.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(full),
        impl="xla", layout="BTHD")
    got = port_nn.dot_product_attention(tq, tk, tv, torch.from_numpy(full),
                                        layout="BTHD")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    for impl in ("flash", "ring", "ulysses"):
        with pytest.raises(MXNetError, match="not ported"):
            port_nn.dot_product_attention(tq, tk, tv, impl=impl,
                                          layout="BTHD")
    with pytest.raises(MXNetError, match="does not take this call"):
        port_nn.dot_product_attention(tq, tk, tv, torch.from_numpy(full),
                                      impl="fused", layout="BTHD")


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def test_adamw_apply_arrays_matches_jax():
    r = np.random.default_rng(5)
    w, g, m = (r.standard_normal((7, 9)).astype(np.float32)
               for _ in range(3))
    v = np.abs(r.standard_normal((7, 9))).astype(np.float32)
    for kw in ({}, {"clip_gradient": 0.5, "rescale_grad": 0.25}):
        ref = jopt.AdamW(learning_rate=1e-3, wd=0.01, **kw)
        port = AdamW(learning_rate=1e-3, wd=0.01, **kw)
        jw, (jm, jv) = ref.apply_arrays(
            jnp.asarray(w), jnp.asarray(g), (jnp.asarray(m), jnp.asarray(v)),
            1e-3, 0.01, jnp.asarray(3, jnp.int32))
        tw, tm, tv = (torch.tensor(x) for x in (w, m, v))
        pw, (pm, pv) = port.apply_arrays(tw, torch.tensor(g), (tm, tv),
                                         1e-3, 0.01, 3)
        # the port updates in place and returns its own buffers
        assert pw is tw and pm is tm and pv is tv
        for a, b in ((pw, jw), (pm, jm), (pv, jv)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6)


def test_adamw_bf16_master_matches_jax():
    """bfloat16 weights keep a float32 master first in their state; the
    update runs on the master and the weight is its rounding."""
    r = np.random.default_rng(6)
    w = r.standard_normal((5, 8)).astype(np.float32)
    g = r.standard_normal((5, 8)).astype(np.float32)
    ref, port = jopt.AdamW(learning_rate=1e-2, wd=0.01), \
        AdamW(learning_rate=1e-2, wd=0.01)
    jw = jnp.asarray(w, jnp.bfloat16)
    pw = torch.from_numpy(w).to(torch.bfloat16)
    js, ps = ref.init_state_arrays_mp(jw), port.init_state_arrays_mp(pw)
    assert len(ps) == len(js) == 3 and ps[0].dtype == torch.float32
    for t in (1, 2):
        jw, js = ref.apply_arrays_mp(jw, jnp.asarray(g, jnp.bfloat16), js,
                                     1e-2, 0.01, jnp.asarray(t, jnp.int32))
        pw, ps = port.apply_arrays_mp(pw, torch.from_numpy(g).to(
            torch.bfloat16), ps, 1e-2, 0.01, t)
    assert pw.dtype == torch.bfloat16
    np.testing.assert_array_equal(pw.float().numpy(),
                                  np.asarray(jw.astype(jnp.float32)))
    for a, b in zip(ps, js):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


def test_unported_optimizers_raise():
    assert isinstance(create("adamw", learning_rate=0.1), AdamW)
    with pytest.raises(MXNetError, match="not ported"):
        create("sgd")
    with pytest.raises(MXNetError, match="not ported"):
        AdamW().update(0, None, None, None)


# ---------------------------------------------------------------------------
# the training step
# ---------------------------------------------------------------------------

def test_train_step_matches_jax(jax_pair):
    jnet, arrays = jax_pair
    net = _port(arrays)
    jstep = jpar.TrainStep(jnet, jloss.SoftmaxCrossEntropyLoss(),
                           jopt.AdamW(learning_rate=1e-4, wd=0.01),
                           mesh=None, n_net_inputs=4)
    step = TrainStep(net, SoftmaxCrossEntropyLoss(),
                     AdamW(learning_rate=1e-4, wd=0.01), n_net_inputs=4)
    for i in range(3):
        batch = _batch(10 + i)
        want = float(jstep(*_jax_args(batch)).asnumpy())
        got = step(*_torch_args(batch))
        assert got.dtype == torch.float32 and got.dim() == 0
        assert abs(float(got) - want) <= 1e-5 * max(1.0, abs(want)), i
    assert step.step_count == 3
    jstep.sync_params()
    port = dict(net.named_parameters())
    for name, p in jnet.collect_params().items():
        np.testing.assert_allclose(port[name].detach().numpy(),
                                   p.data().asnumpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_train_step_options(jax_pair):
    _, arrays = jax_pair
    batch = _torch_args(_batch(20))

    def seeded_step():
        rng.seed(1)
        return TrainStep(_port(arrays), SoftmaxCrossEntropyLoss(),
                         AdamW(learning_rate=1e-3), n_net_inputs=4)
    a, b = seeded_step(), seeded_step()
    # K chained steps are K calls (the second step to float32 rounding:
    # the CPU's embedding backward accumulates in no fixed order)
    losses = a.run_steps(*batch, steps=2)
    assert losses.shape == (2,)
    torch.testing.assert_close(losses, torch.stack([b(*batch), b(*batch)]),
                               rtol=1e-6, atol=1e-6)
    stacked = [torch.stack([x, x]) for x in batch]
    torch.testing.assert_close(seeded_step().run_steps(*stacked), losses,
                               rtol=1e-6, atol=1e-6)
    # loss_reduce="sum" is the mean times the batch
    s = TrainStep(_port(arrays), SoftmaxCrossEntropyLoss(),
                  AdamW(learning_rate=1e-3), n_net_inputs=4,
                  loss_reduce="sum")
    assert abs(float(s(*batch)) - B * float(losses[0])) < 1e-4
    # lr_mult 0 freezes a parameter (the step scales the whole update)
    net = _port(arrays)
    frozen = net.backbone.embed_ln.gamma
    frozen.lr_mult = 0.0
    before = frozen.detach().clone()
    TrainStep(net, SoftmaxCrossEntropyLoss(), AdamW(learning_rate=1e-2),
              n_net_inputs=4)(*batch)
    assert torch.equal(frozen.detach(), before)
    assert not torch.equal(net.backbone.embed_ln.beta.detach(),
                           torch.tensor(arrays["backbone.embed_ln.beta"]))
    for kw in ({"mesh": object()}, {"compression": "2bit"},
               {"loss_scale": "dynamic"}):
        with pytest.raises(MXNetError, match="not ported"):
            TrainStep(net, SoftmaxCrossEntropyLoss(), AdamW(),
                      n_net_inputs=4, **kw)


def test_dropout_is_seeded_per_step_and_off_in_eval(jax_pair):
    """With dropout, a step depends only on (seed, step number): the
    first step's loss is bit-identical across runs with one seed (later
    ones to float32 rounding: the CPU's embedding backward accumulates
    in no fixed order). The model stays in eval mode outside the step,
    where it is deterministic and dropout-free."""
    _, arrays = jax_pair
    batch = _torch_args(_batch(21))
    runs = []
    for seed in (5, 5, 6):
        net = _port(arrays, dropout=0.1, attention_dropout=0.1)
        rng.seed(seed)
        step = TrainStep(net, SoftmaxCrossEntropyLoss(), AdamW(),
                         n_net_inputs=4)
        runs.append(step.run_steps(*batch, steps=2))
        assert not net.training
    assert runs[0][0] == runs[1][0]
    torch.testing.assert_close(runs[0], runs[1], rtol=1e-6, atol=1e-6)
    assert float((runs[0] - runs[2]).abs().max()) > 1e-3
    with torch.no_grad():
        x = net(*batch[:4])
        assert torch.equal(x, net(*batch[:4]))
        rng.seed(0)
        net.train()
        y, z = net(*batch[:4]), net(*batch[:4])
        net.eval()
    assert not torch.equal(y, z) and not torch.equal(x, y)
