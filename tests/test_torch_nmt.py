"""The port's Transformer NMT (teacher forcing, TrainStep + Adam, beam
search) against the JAX package.

A tiny TransformerNMT (2 + 2 layers, 32 units, 2 heads, vocab 20,
dropout 0) is built and seeded once in the JAX package; its parameters
cross over as numpy arrays (models/convert.load_jax_params). Both
packages then compute the same functions on the CPU, where attention
takes the fused kernel's plain version in the port and XLA's einsum in
the reference: logits with and without source valid lengths (1e-5),
the cached decode step against the teacher-forcing pass (1e-5), Adam's
functional update (float32 and the bfloat16-weight / float32-master
layout), three TrainStep steps (losses 1e-5 relative, parameters 1e-4),
and beam search at beam 1 and 4 (tokens equal, scores 1e-5).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu import optimizer as jopt  # noqa: E402
from mxnet_tpu import parallel as jpar  # noqa: E402
from mxnet_tpu.gluon import loss as jloss  # noqa: E402
from mxnet_tpu.models import NMTConfig as JaxConfig  # noqa: E402
from mxnet_tpu.models import TransformerNMT as JaxNMT  # noqa: E402
from mxnet_tpu_torch import MXNetError  # noqa: E402
from mxnet_tpu_torch.loss import SoftmaxCrossEntropyLoss  # noqa: E402
from mxnet_tpu_torch.models import (KVCache, NMTConfig,  # noqa: E402
                                    TransformerNMT, load_jax_params,
                                    nmt_base_config)
from mxnet_tpu_torch.optimizer import Adam, create  # noqa: E402
from mxnet_tpu_torch.parallel import TrainStep  # noqa: E402

BOS, EOS, PAD = 2, 3, 0
KW = dict(src_vocab_size=20, tgt_vocab_size=20, units=32, hidden_size=64,
          enc_layers=2, dec_layers=2, num_heads=2, max_length=32,
          dropout=0.0, bos_id=BOS, eos_id=EOS, pad_id=PAD)
B, TS, TT = 3, 7, 5
VALID = np.int32([7, 4, 2])


@pytest.fixture(scope="module")
def jax_pair():
    """(JAX net, its params as numpy)."""
    jnet = JaxNMT(JaxConfig(**KW))
    mx.rng.seed(9)
    jnet.initialize(mx.init.Normal(0.05))
    arrays = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    return jnet, arrays


def _port(arrays, **kw):
    return load_jax_params(
        TransformerNMT(NMTConfig(**dict(KW, **kw)), device="cpu"), arrays)


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(
        4, KW["tgt_vocab_size"], shape).astype(np.int32)


def _nd(x):
    return None if x is None else mx.nd.array(x, dtype="int32")


def _t(x):
    return None if x is None else torch.from_numpy(x)


def test_parameter_names_and_shapes_match_jax(jax_pair):
    _, arrays = jax_pair
    net = _port(arrays)
    port = {n: tuple(p.shape) for n, p in net.named_parameters()}
    assert port == {n: a.shape for n, a in arrays.items()}
    # the output layer is tied to tgt_embed: no weight of its own
    assert not any("out" in n or "head" in n for n in port)
    assert not net.training


def test_base_config_widths():
    c = nmt_base_config()
    assert (c.src_vocab_size, c.tgt_vocab_size, c.units, c.hidden_size,
            c.enc_layers, c.dec_layers, c.num_heads, c.max_length,
            c.dropout) == (32000, 32000, 512, 2048, 6, 6, 8, 256, 0.1)


@pytest.mark.parametrize("valid", [False, True])
def test_forward_logits_match_jax(jax_pair, valid):
    jnet, arrays = jax_pair
    net = _port(arrays)
    src, tgt = _tokens(0, (B, TS)), _tokens(1, (B, TT))
    vl = VALID if valid else None
    want = jnet(_nd(src), _nd(tgt), _nd(vl)).asnumpy()
    with torch.no_grad():
        got = net(_t(src), _t(tgt), _t(vl)).numpy()
    assert got.shape == (B, TT, KW["tgt_vocab_size"])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("valid", [False, True])
def test_decode_step_matches_teacher_forcing(jax_pair, valid):
    """Feeding the target one token a step through the cache gives the
    teacher-forcing pass's logits at every position."""
    _, arrays = jax_pair
    net = _port(arrays)
    src, tgt = _tokens(2, (B, TS)), _tokens(3, (B, TT))
    vl = _t(VALID) if valid else None
    with torch.no_grad():
        full = net(_t(src), _t(tgt), vl)
        memory, mask = net.encode(_t(src), vl)
        c = net.config
        cache = KVCache.create(c.dec_layers, B, c.num_heads, c.max_length,
                               c.units // c.num_heads, device="cpu")
        for t in range(TT):
            logits, cache = net._decode_step(_t(tgt[:, t:t + 1]), memory,
                                              mask, cache)
            np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(),
                                       rtol=1e-5, atol=1e-5)
    assert int(cache.length) == TT


# ---------------------------------------------------------------------------
# Adam
# ---------------------------------------------------------------------------

def test_adam_apply_arrays_matches_jax():
    r = np.random.default_rng(5)
    w, g, m = (r.standard_normal((7, 9)).astype(np.float32)
               for _ in range(3))
    v = np.abs(r.standard_normal((7, 9))).astype(np.float32)
    for kw in ({}, {"clip_gradient": 0.5, "rescale_grad": 0.25}):
        ref = jopt.Adam(learning_rate=1e-3, wd=0.01, **kw)
        port = Adam(learning_rate=1e-3, wd=0.01, **kw)
        for t in (1, 3):
            jw, (jm, jv) = ref.apply_arrays(
                jnp.asarray(w), jnp.asarray(g),
                (jnp.asarray(m), jnp.asarray(v)), jnp.float32(1e-3),
                jnp.float32(0.01), jnp.asarray(t, jnp.int32))
            tw, tm, tv = (torch.tensor(x) for x in (w, m, v))
            pw, (pm, pv) = port.apply_arrays(tw, torch.tensor(g), (tm, tv),
                                             1e-3, 0.01, t)
            # in place: the port returns its own buffers
            assert pw is tw and pm is tm and pv is tv
            for a, b in ((pw, jw), (pm, jm), (pv, jv)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-6, atol=1e-6)


def test_adam_bf16_master_matches_jax():
    """bfloat16 weights keep a float32 master first in their state; the
    update runs on the master and the weight is its rounding."""
    r = np.random.default_rng(6)
    w = r.standard_normal((5, 8)).astype(np.float32)
    ref = jopt.Adam(learning_rate=1e-2, wd=0.01)
    port = Adam(learning_rate=1e-2, wd=0.01)
    jw = jnp.asarray(w, jnp.bfloat16)
    pw = torch.from_numpy(w).to(torch.bfloat16)
    js, ps = ref.init_state_arrays_mp(jw), port.init_state_arrays_mp(pw)
    assert len(ps) == len(js) == 3 and ps[0].dtype == torch.float32
    for t in (1, 2, 3):
        g = r.standard_normal((5, 8)).astype(np.float32)
        jw, js = ref.apply_arrays_mp(jw, jnp.asarray(g, jnp.bfloat16), js,
                                     jnp.float32(1e-2), jnp.float32(0.01),
                                     jnp.asarray(t, jnp.int32))
        pw, ps = port.apply_arrays_mp(pw, torch.from_numpy(g).to(
            torch.bfloat16), ps, 1e-2, 0.01, t)
    assert pw.dtype == torch.bfloat16
    np.testing.assert_array_equal(pw.float().numpy(),
                                  np.asarray(jw.astype(jnp.float32)))
    for a, b in zip(ps, js):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


def test_create_adam_and_train_step_takes_it(jax_pair):
    opt = create("adam", learning_rate=0.1, beta1=0.8)
    assert isinstance(opt, Adam) and opt.fused_supported
    assert (opt.learning_rate, opt.beta1) == (0.1, 0.8)
    step = TrainStep(_port(jax_pair[1]), SoftmaxCrossEntropyLoss(), opt,
                     n_net_inputs=3)
    assert all(len(s) == 2 for s in step._states)


# ---------------------------------------------------------------------------
# the training step
# ---------------------------------------------------------------------------

def _train_batch(seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(4, KW["src_vocab_size"], (B, TS)).astype(np.int32)
    tgt = rng.integers(4, KW["tgt_vocab_size"], (B, TT + 1)).astype(np.int32)
    vl = rng.integers(2, TS + 1, B).astype(np.int32)
    return src, tgt[:, :-1], vl, tgt[:, 1:]


def test_train_step_adam_matches_jax(jax_pair):
    """lr 1e-3: the attention key biases' true gradient is 0 (a key bias
    shifts every score of a query alike), so each package's gradient
    there is its own float noise, which Adam's normalisation turns into
    a step of up to lr * |g| / eps (1e-4 apart at lr 1e-2 after three
    steps; every other weight moves about 3 * lr)."""
    jnet, arrays = jax_pair
    net = _port(arrays)
    jstep = jpar.TrainStep(jnet, jloss.SoftmaxCrossEntropyLoss(),
                           jopt.Adam(learning_rate=1e-3, wd=1e-3),
                           mesh=None, n_net_inputs=3)
    step = TrainStep(net, SoftmaxCrossEntropyLoss(),
                     Adam(learning_rate=1e-3, wd=1e-3), n_net_inputs=3)
    try:
        for i in range(3):
            batch = _train_batch(10 + i)
            want = float(jstep(*map(_nd, batch)).asnumpy())
            got = step(*map(_t, batch))
            assert got.dtype == torch.float32 and got.dim() == 0
            assert abs(float(got) - want) <= 1e-5 * max(1.0, abs(want)), i
        jstep.sync_params()
        port = dict(net.named_parameters())
        for name, p in jnet.collect_params().items():
            np.testing.assert_allclose(port[name].detach().numpy(),
                                       p.data().asnumpy(), rtol=1e-4,
                                       atol=1e-4, err_msg=name)
        # the step moved the weights
        w = "dec0.ffn.fc1.weight"
        assert np.abs(port[w].detach().numpy() - arrays[w]).max() > 2e-3
    finally:
        for name, p in jnet.collect_params().items():
            p.set_data(mx.nd.array(arrays[name]))


# ---------------------------------------------------------------------------
# beam search
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("beam", [1, 4])
@pytest.mark.parametrize("valid", [False, True])
def test_translate_matches_jax(jax_pair, beam, valid):
    jnet, arrays = jax_pair
    net = _port(arrays)
    src = _tokens(4, (B, TS))
    vl = VALID if valid else None
    jt, js = jnet.translate(_nd(src), _nd(vl), beam_size=beam,
                            max_length=10)
    pt, ps = net.translate(_t(src), _t(vl), beam_size=beam, max_length=10)
    assert pt.shape == (B, beam, 10) and pt.dtype == torch.int32
    assert ps.shape == (B, beam) and ps.dtype == torch.float32
    np.testing.assert_array_equal(pt.numpy(), jt.asnumpy())
    np.testing.assert_allclose(ps.numpy(), js.asnumpy(), rtol=1e-5,
                               atol=1e-5)
    # best first
    assert (np.diff(ps.numpy(), axis=1) <= 0).all()


def test_translate_validates_length(jax_pair):
    net = _port(jax_pair[1])
    with pytest.raises(MXNetError, match="max_length"):
        net.translate(torch.ones((1, 4), dtype=torch.int32), max_length=64)


def test_overfit_copy_task_and_translate(jax_pair):
    """The reference's Sockeye smoke test on the port alone: overfit
    'copy the source' on a toy corpus with TrainStep + Adam, then the
    beam search reproduces the training targets."""
    rng = np.random.default_rng(0)
    b, t = 8, 6
    body = rng.integers(4, KW["src_vocab_size"], (b, t)).astype(np.int32)
    tgt_in = np.concatenate([np.full((b, 1), BOS, np.int32), body], axis=1)
    tgt_out = np.concatenate([body, np.full((b, 1), EOS, np.int32)], axis=1)
    net = _port(jax_pair[1])
    step = TrainStep(net, SoftmaxCrossEntropyLoss(),
                     Adam(learning_rate=3e-3), n_net_inputs=2)
    losses = step.run_steps(torch.from_numpy(body), torch.from_numpy(tgt_in),
                            torch.from_numpy(tgt_out), steps=60).tolist()
    assert losses[-1] < 0.3 * losses[0], losses[::10]
    toks, scores = net.translate(torch.from_numpy(body), beam_size=4,
                                 max_length=t + 1)
    toks, scores = toks.numpy(), scores.numpy()
    assert toks.shape == (b, 4, t + 1)
    match = (toks[:, 0, :] == tgt_out).all(axis=1).mean()
    assert match >= 0.75, (match, toks[:, 0], tgt_out)
    assert (np.diff(scores, axis=1) <= 1e-5).all()
