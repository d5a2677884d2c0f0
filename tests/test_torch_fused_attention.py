"""The port's fused training attention against the JAX package's Pallas
kernels.

`mxnet_tpu_torch.ops.fused_attention` on a CPU tensor runs its plain
PyTorch version; the reference is `pallas_attention.fused_attention(...,
interpret=True)` (the packed kernel pair for layout "BTHD", the (B, H)
grid pair for "BHTD"). Both get the same numpy-seeded inputs and, with
dropout, the same two seed words: the JAX function derives them from
its key (the last two int32 words of the key data), the port is handed
them. Forward at 1e-5 absolute, dq/dk/dv (torch autograd against
jax.grad) at 1e-4 relative to the largest gradient, float32: the sums
run in another order. The dropout hash is compared bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mxnet_tpu.ops import pallas_attention as pa  # noqa: E402
from mxnet_tpu_torch import MXNetError  # noqa: E402
from mxnet_tpu_torch.ops import fused_attention as fa  # noqa: E402


@pytest.mark.parametrize("s0,s1", [(0, 0), (123456789, 2 ** 32 - 5),
                                   (2 ** 31 + 7, 99)])
def test_software_bits_bit_identical(s0, s1):
    want = np.asarray(pa._software_bits(jnp.uint32(s0), jnp.uint32(s1),
                                        (64, 96))).astype(np.int64)
    got = fa.software_bits(s0, s1, (64, 96)).numpy()
    np.testing.assert_array_equal(got, want)


def _seed_words(key):
    """The two int32 words the JAX fused_attention takes from its key
    (pallas_attention.py, the `kd32[-2:]` branch)."""
    kd = np.asarray(jax.random.key_data(key)).reshape(-1)
    return kd.astype(np.uint32).view(np.int32)[-2:]


# (name, B, H, Tq, Tk, mask valid lengths, causal, dropout)
CASES = [
    ("plain", 2, 2, 48, 48, None, False, 0.0),
    ("key_padding", 2, 2, 40, 40, [0, 23], False, 0.0),
    ("causal", 1, 2, 48, 48, None, True, 0.0),
    ("causal_tq_lt_tk", 1, 2, 24, 56, None, True, 0.0),
    ("dropout", 2, 2, 40, 40, [40, 17], False, 0.3),
]


@pytest.mark.parametrize("layout", ["BTHD", "BHTD"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_matches_pallas_interpret(case, layout):
    _, B, H, Tq, Tk, lens, causal, p = case
    D = 64
    rng = np.random.default_rng([Tq, Tk, B, int(layout == "BTHD")])

    def shape(t):
        return (B, t, H, D) if layout == "BTHD" else (B, H, t, D)

    q = rng.standard_normal(shape(Tq)).astype(np.float32)
    k = rng.standard_normal(shape(Tk)).astype(np.float32)
    v = rng.standard_normal(shape(Tk)).astype(np.float32)
    do = rng.standard_normal(shape(Tq)).astype(np.float32)
    mask = None if lens is None else \
        np.arange(Tk)[None, :] < np.asarray(lens)[:, None]
    key = jax.random.PRNGKey(7) if p > 0 else None

    def jfn(q, k, v):
        return pa.fused_attention(
            q, k, v, mask=None if mask is None else jnp.asarray(mask),
            causal=causal, dropout_p=p, key=key, interpret=True,
            layout=layout)

    jo, vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(do))

    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    seed = torch.from_numpy(_seed_words(key)) if p > 0 else None
    fa.reset_launches()
    to = fa.fused_attention(tq, tk, tv,
                            mask=None if mask is None else
                            torch.from_numpy(mask),
                            causal=causal, dropout_p=p, seed=seed,
                            layout=layout)
    tgrads = torch.autograd.grad(to, (tq, tk, tv), torch.from_numpy(do))
    assert fa.LAUNCHES == {"fused_attention_fwd": 0, "fused_attention_bwd": 0}

    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo),
                               rtol=0, atol=1e-5)
    for name, got, want in zip("qkv", tgrads, jgrads):
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err <= 1e-4, f"d{name}: relative error {err}"
    if lens is not None and 0 in lens:
        # the fully padded batch row comes out as exact zeros
        assert not to.detach().numpy()[lens.index(0)].any()


def test_dropout_mask_follows_the_seed_words():
    """Same words, same output; other words, another mask."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 32, 2, 64))
                                .astype(np.float32)) for _ in range(3))
    a = torch.tensor([3, -4], dtype=torch.int32)
    o1 = fa.fused_attention(q, k, v, dropout_p=0.5, seed=a, layout="BTHD")
    o2 = fa.fused_attention(q, k, v, dropout_p=0.5, seed=a.clone(),
                            layout="BTHD")
    o3 = fa.fused_attention(q, k, v, dropout_p=0.5,
                            seed=torch.tensor([3, -5], dtype=torch.int32),
                            layout="BTHD")
    assert torch.equal(o1, o2) and not torch.equal(o1, o3)
    with pytest.raises(ValueError, match="seed"):
        fa.fused_attention(q, k, v, dropout_p=0.5, layout="BTHD")


def test_auto_on_cpu_takes_the_plain_version():
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 2, 16, 64))
                                .astype(np.float32)) for _ in range(3))
    fa.reset_launches()
    auto = fa.fused_attention(q, k, v, causal=True, impl="auto")
    plain = fa.fused_attention(q, k, v, causal=True, impl="torch")
    assert torch.equal(auto, plain)
    assert fa.LAUNCHES == {"fused_attention_fwd": 0, "fused_attention_bwd": 0}
    with pytest.raises(ValueError):
        fa.fused_attention(q, k, v, impl="cuda")
    with pytest.raises(MXNetError, match="key-padding"):
        fa.fused_attention(q, k, v, mask=torch.ones(2, 1, 16, 16,
                                                    dtype=torch.bool))


def test_supported_gate():
    x = torch.zeros(2, 16, 4, 64)
    kp = torch.ones(2, 16, dtype=torch.bool)
    assert fa.supported(x, x, kp, layout="BTHD")
    assert fa.supported(x, x, kp[:, None, None, :], layout="BTHD")
    # a head dim off the 64 grid is fine for the CUDA kernel
    assert fa.supported(torch.zeros(2, 16, 4, 40), torch.zeros(2, 16, 4, 40),
                        None, layout="BTHD")
    assert not fa.supported(torch.zeros(2, 16, 4, 160),
                            torch.zeros(2, 16, 4, 160), None, layout="BTHD")
    assert not fa.supported(x.half(), x.half(), None, layout="BTHD")
    assert not fa.supported(x, x, torch.ones(2, 1, 16, 16, dtype=torch.bool),
                            layout="BTHD")
    # the reference's whole-row limit does not apply to the tiled kernel
    long = torch.zeros(1, 1, 1100, 64)
    assert 1100 > fa.MAX_FUSED_T
    assert fa.supported(long, long, None, layout="BHTD")
    assert fa.supported(long.transpose(1, 2), long.transpose(1, 2),
                        torch.arange(1100)[None, :] < 700, layout="BTHD")


@pytest.mark.parametrize("tq,tk", [(0, 16), (16, 0)])
def test_empty_extent_gives_zero_gradients(tq, tk):
    """With no query or no key the kernel's autograd function launches
    nothing and returns zeros, gradients included (no uninitialised
    memory), as the plain version does."""
    rng = np.random.default_rng(8)

    def leaf(t):
        return torch.tensor(rng.standard_normal((2, t, 3, 64)),
                            dtype=torch.float32, requires_grad=True)
    q, k, v = leaf(tq), leaf(tk), leaf(tk)
    bias = torch.zeros(2, tk)
    seed = torch.tensor([1, 2], dtype=torch.int32)
    fa.reset_launches()
    outs = [fa._FusedAttention.apply(q, k, v, bias, seed, 0.125, 0.1, False,
                                     "BTHD"),
            fa.fused_attention(q, k, v, dropout_p=0.1, seed=seed,
                               layout="BTHD")]
    for o in outs:
        assert o.shape == (2, tq, 3, 64) and not o.any()
        grads = torch.autograd.grad(o, (q, k, v), torch.ones_like(o),
                                    allow_unused=True)
        for x, g in zip((q, k, v), grads):
            assert g is not None and g.shape == x.shape and not g.any()
    assert fa.LAUNCHES == {"fused_attention_fwd": 0, "fused_attention_bwd": 0}


def test_cuda_tensor_the_kernel_cannot_take_raises():
    """The checks run before any launch, so they hold on a CPU tensor
    handed to the kernel path's checker."""
    q = torch.zeros(2, 16, 4, 64)
    bias = torch.zeros(2, 16)
    seed = torch.zeros(2, dtype=torch.int32)
    fa._check_kernel_args(q, q, q, bias, seed, "BTHD")
    with pytest.raises(MXNetError, match="float32 or bfloat16"):
        fa._check_kernel_args(q.half(), q.half(), q.half(), bias, seed,
                              "BTHD")
    with pytest.raises(MXNetError, match="head dim"):
        w = torch.zeros(2, 16, 4, 160)
        fa._check_kernel_args(w, w, w, bias, seed, "BTHD")
    with pytest.raises(MXNetError, match="contiguous"):
        t = torch.zeros(2, 16, 64, 4).transpose(2, 3)
        fa._check_kernel_args(t, t, t, bias, seed, "BTHD")
    with pytest.raises(MXNetError, match="do not match"):
        fa._check_kernel_args(q, q[:1], q[:1], bias, seed, "BTHD")
