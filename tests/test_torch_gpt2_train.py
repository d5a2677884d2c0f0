"""The port's GPT-2 training forward (`cache=None`) against the JAX
package.

A tiny GPT-2 (2 layers, 64 units, 4 heads of 16, vocab 97) is built and
seeded in the JAX package; its parameters cross over as numpy arrays
(models/convert.load_jax_params). T = 70 is off the fused kernel's
64-row tile grid. Both packages run the causal training forward with
dropout 0: the JAX model as its own tests run it on the CPU (its XLA
attention), the port through ops.nn.dot_product_attention, which takes
the fused attention's plain version for CPU tensors. Logits agree at
1e-5 (float32, sums in another order). The ragged-cache forward is
tests/test_torch_gpt2.py's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu.models import GPT2Config as JaxConfig  # noqa: E402
from mxnet_tpu.models import GPT2ForCausalLM as JaxGPT2  # noqa: E402
from mxnet_tpu_torch import rng  # noqa: E402
from mxnet_tpu_torch.models import (GPT2Config, GPT2ForCausalLM,  # noqa: E402
                                    load_jax_params)
from mxnet_tpu_torch.ops import fused_attention as fa  # noqa: E402

KW = dict(vocab_size=97, units=64, num_layers=2, num_heads=4,
          max_length=128, dropout=0.0, attention_dropout=0.0)
B, T = 2, 70


def _port(arrays, **kw):
    return load_jax_params(
        GPT2ForCausalLM(GPT2Config(**dict(KW, **kw)), device="cpu"), arrays)


@pytest.fixture(scope="module")
def pair():
    """(JAX net, its params as numpy, token ids (B, T))."""
    jnet = JaxGPT2(JaxConfig(**KW))
    mx.rng.seed(5)
    jnet.initialize(mx.init.Normal(0.05))
    arrays = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    ids = np.random.default_rng(0).integers(0, KW["vocab_size"], (B, T))
    return jnet, arrays, ids


def _port_logits(net, ids):
    with torch.no_grad():
        return net(torch.tensor(ids, dtype=torch.int64)).numpy()


def test_training_forward_matches_jax(pair):
    jnet, arrays, ids = pair
    want = jnet(mx.nd.array(ids, dtype="int32")).asnumpy()
    fa.reset_launches()
    got = _port_logits(_port(arrays), ids)
    assert not any(fa.LAUNCHES.values())
    assert got.shape == (B, T, KW["vocab_size"])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_attention_impls_agree(pair):
    """'auto' (the fused attention; its plain version on the CPU) and
    'torch' (that plain version named outright) are one computation;
    'xla' (the einsum softmax) agrees within float32 rounding."""
    _, arrays, ids = pair
    auto = _port_logits(_port(arrays, attention_impl="auto"), ids)
    plain = _port_logits(_port(arrays, attention_impl="torch"), ids)
    xla = _port_logits(_port(arrays, attention_impl="xla"), ids)
    np.testing.assert_array_equal(auto, plain)
    np.testing.assert_allclose(xla, auto, rtol=1e-5, atol=1e-5)


def test_prefix_logits_do_not_see_later_tokens(pair):
    """Causal: the logits of the first 64 positions are those of the
    first 64 tokens alone."""
    _, arrays, ids = pair
    net = _port(arrays)
    full = _port_logits(net, ids)
    head = _port_logits(net, ids[:, :64])
    np.testing.assert_allclose(full[:, :64], head, rtol=1e-5, atol=1e-5)


def test_dropout_only_in_train_mode_and_seeded(pair):
    """The model starts in eval(): dropout off, logits as without it. In
    train() the embedding, block and attention dropouts draw from the
    current generator: the same generator state gives the same logits,
    another state other ones; gradients reach every parameter."""
    _, arrays, ids = pair
    plain = _port_logits(_port(arrays), ids)
    net = _port(arrays, dropout=0.1, attention_dropout=0.1)
    assert not net.training
    np.testing.assert_array_equal(_port_logits(net, ids), plain)
    net.train()
    x = torch.tensor(ids, dtype=torch.int64)
    runs = []
    for seed in (1, 1, 2):
        with rng.generator_scope(rng.step_generator(seed, 0, "cpu")):
            runs.append(net(x))
    assert torch.equal(runs[0], runs[1])
    assert not torch.allclose(runs[0], runs[2])
    assert not np.allclose(runs[0].detach().numpy(), plain)
    runs[0].float().square().mean().backward()
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in net.parameters())
