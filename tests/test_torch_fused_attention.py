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
run in another order. The dropout hash is compared bit for bit. The
plain version in bfloat16 is held to the interpret-mode kernels in
bfloat16 too: those are the rounding points (P before P·V and dV, dS
before dQ and dK) the tensor-core kernels follow on the card. The
kernels themselves run only on a card (chip_smoke.py); here the route a
CUDA call would take is checked without launching.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mxnet_tpu.ops import pallas_attention as pa  # noqa: E402
from mxnet_tpu_torch import MXNetError  # noqa: E402
from mxnet_tpu_torch.ops import fused_attention as fa  # noqa: E402

NO_LAUNCHES = {"fused_attention_fwd": 0, "fused_attention_bwd": 0,
               "fused_attention_fwd_tc": 0, "fused_attention_bwd_tc": 0}


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


def _against_pallas(case, layout, jdtype, tdtype):
    """The same numpy-seeded inputs, rounded to the working dtype, through
    the Pallas kernels (interpret mode) and the port's plain version:
    (port output, port grads, JAX output, JAX grads) as float32 numpy,
    and the valid lengths."""
    _, B, H, Tq, Tk, lens, causal, p = case
    D = 64
    rng = np.random.default_rng([Tq, Tk, B, int(layout == "BTHD")])

    def shape(t):
        return (B, t, H, D) if layout == "BTHD" else (B, H, t, D)

    arrays = [rng.standard_normal(shape(t)).astype(np.float32)
              for t in (Tq, Tk, Tk, Tq)]
    mask = None if lens is None else \
        np.arange(Tk)[None, :] < np.asarray(lens)[:, None]
    key = jax.random.PRNGKey(7) if p > 0 else None

    def jfn(q, k, v):
        return pa.fused_attention(
            q, k, v, mask=None if mask is None else jnp.asarray(mask),
            causal=causal, dropout_p=p, key=key, interpret=True,
            layout=layout)

    jq, jk, jv, jdo = (jnp.asarray(x).astype(jdtype) for x in arrays)
    jo, vjp = jax.vjp(jfn, jq, jk, jv)
    jgrads = vjp(jdo)

    tq, tk, tv = (torch.tensor(x).to(tdtype).requires_grad_(True)
                  for x in arrays[:3])
    seed = torch.from_numpy(_seed_words(key)) if p > 0 else None
    fa.reset_launches()
    to = fa.fused_attention(tq, tk, tv,
                            mask=None if mask is None else
                            torch.from_numpy(mask),
                            causal=causal, dropout_p=p, seed=seed,
                            layout=layout)
    tgrads = torch.autograd.grad(to, (tq, tk, tv),
                                 torch.tensor(arrays[3]).to(tdtype))
    assert fa.LAUNCHES == NO_LAUNCHES
    assert to.dtype == tdtype and all(g.dtype == tdtype for g in tgrads)

    def t32(x):
        return x.detach().float().numpy()

    def j32(x):
        return np.asarray(x, dtype=np.float32)
    return (t32(to), [t32(g) for g in tgrads], j32(jo),
            [j32(g) for g in jgrads], lens)


@pytest.mark.parametrize("layout", ["BTHD", "BHTD"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_matches_pallas_interpret(case, layout):
    to, tgrads, jo, jgrads, lens = _against_pallas(case, layout, jnp.float32,
                                                   torch.float32)
    np.testing.assert_allclose(to, jo, rtol=0, atol=1e-5)
    for name, got, want in zip("qkv", tgrads, jgrads):
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= 1e-4, f"d{name}: relative error {err}"
    if lens is not None and 0 in lens:
        # the fully padded batch row comes out as exact zeros
        assert not to[lens.index(0)].any()


# bfloat16: both sides take bf16 inputs, form every product in float32
# and round at the same points (P before P·V and dV, the outputs; the
# reference also rounds dS before dQ and dK, which the plain version,
# differentiated by autograd, does not). The results differ by at most
# about one bf16 unit of the largest value (2**-7 = 7.8e-3 relative)
# from those roundings and the float32 sum order: held to 1.2e-2 of the
# largest reference value, the tolerance chip_smoke.py holds the
# tensor-core kernels to against the plain version.
BF16_REL_TOL = 1.2e-2


@pytest.mark.parametrize("layout", ["BTHD", "BHTD"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_bf16_matches_pallas_interpret(case, layout):
    to, tgrads, jo, jgrads, lens = _against_pallas(case, layout, jnp.bfloat16,
                                                   torch.bfloat16)
    for name, got, want in zip(["o", "dq", "dk", "dv"], [to, *tgrads],
                               [jo, *jgrads]):
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= BF16_REL_TOL, f"{name}: relative error {err}"
    if lens is not None and 0 in lens:
        assert not to[lens.index(0)].any()


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
    assert fa.LAUNCHES == NO_LAUNCHES
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
    assert fa.LAUNCHES == NO_LAUNCHES


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


def _bthd(D, dtype=torch.bfloat16, pad=0):
    """A (2, 16, 4, D) BTHD view; with `pad` its rows sit pad elements
    apart beyond D (a slice of a wider buffer)."""
    return torch.zeros(2, 16, 4, D + pad, dtype=dtype)[..., :D]


@pytest.mark.parametrize("x,route", [
    (_bthd(64), "tensor_core"),
    (_bthd(40), "tensor_core"),
    (_bthd(128), "tensor_core"),
    # 12 bf16 are 24 bytes: rows off the 16-byte grid
    (_bthd(12), "cuda_core"),
    # head stride 68: the row of head 1 starts 136 bytes in
    (_bthd(64, pad=4), "cuda_core"),
    # head stride 72: every row 16-byte aligned
    (_bthd(64, pad=8), "tensor_core"),
    # a base 2 bytes off alignment
    (torch.zeros(2 * 16 * 4 * 64 + 1, dtype=torch.bfloat16)[1:]
     .view(2, 16, 4, 64), "cuda_core"),
    # float32 stays on the CUDA-core kernels whatever its layout
    (_bthd(64, torch.float32), "cuda_core"),
], ids=["d64", "d40", "d128", "d12", "stride68", "stride72", "base+2",
        "float32"])
def test_kernel_route(x, route):
    """Which kernel family a CUDA call of this shape would take, decided
    from dtype, shape, strides and addresses without a launch; q, k and v
    all must pass for the tensor cores."""
    assert fa.kernel_route(x, x, x, "BTHD") == route
    bhtd = x.transpose(1, 2)
    assert fa.kernel_route(bhtd, bhtd, bhtd, "BHTD") == route
    aligned = _bthd(x.shape[-1], x.dtype)
    assert fa.kernel_route(aligned, x, aligned, "BTHD") == route
    assert fa.supported(x, x, None, layout="BTHD")


def _tf32(x, rule="rna"):
    """float32 as a TF32 operand (10 fraction bits): "rna" to nearest,
    ties away from zero, as cvt.rna.tf32.f32 rounds; "truncate" the top
    19 bits, as the tensor cores read a float32's raw bits (the kernels
    pass them so)."""
    b = x.contiguous().view(torch.int32)
    if rule == "rna":
        b = b + 0x1000
    return (b & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("rule", ["rna", "truncate"])
@pytest.mark.parametrize("product", ["scores", "ds_k", "pv"])
def test_split_tf32_products_keep_float32_accuracy(product, rule):
    """The float32 kernels' products on the tensor cores: each operand
    as hi = tf32(x) and lo = tf32(x - hi), the product as hi·hi + hi·lo +
    lo·hi, under either term rule. On seeded BERT-shaped tiles (64 x 64,
    D = 64) one TF32 term of the operands misses the exact product by
    more than 1e-4 of its largest value, the gradients' tolerance; the
    split stays within 1e-6, below float32's own rounding of the sum.
    Products: S = Q·Kᵀ, the backward's dS·K, and the forward's P·V (the
    unnormalised probabilities, at most 1, against V)."""
    rng = np.random.default_rng(3)
    a = torch.tensor(rng.standard_normal((64, 64)), dtype=torch.float32)
    b = torch.tensor(rng.standard_normal((64, 64)), dtype=torch.float32)
    if product in ("ds_k", "pv"):
        # softmax weights over a wide range
        x = torch.tensor(rng.standard_normal((64, 64)) * 3,
                         dtype=torch.float32)
        if product == "ds_k":
            # dS = p·(dP - d_row)·scale
            a = torch.softmax(x, -1) * a / 8.0
        else:
            a = torch.exp(x - x.amax(-1, keepdim=True))
    exact = a.double() @ b.double().T
    top = exact.abs().max()
    ah, bh = _tf32(a, rule), _tf32(b, rule)
    al, bl = _tf32(a - ah, rule), _tf32(b - bh, rule)
    single = ah.double() @ bh.double().T
    split = ah.double() @ bh.double().T + ah.double() @ bl.double().T \
        + al.double() @ bh.double().T
    assert (single - exact).abs().max() > 1e-4 * top
    assert (split - exact).abs().max() <= 1e-6 * top


def _rz(x):
    """float64 sums as float32 rounded toward zero: the tensor cores
    truncate each sum they accumulate."""
    f = x.float()
    over = f.double().abs() > x.abs()
    f[over] = torch.nextafter(f[over], torch.zeros_like(f[over]))
    return f


def _mma_product(x, y, split):
    """x (M, K) · y (K, N) as the kernels form it with mma.sync m16n8k8
    TF32 in k-steps of 8: operands read truncated to TF32, every
    accumulation truncated to float32; with `split` (float32 operands)
    the lo·hi and hi·lo products summed apart and added at the end
    (mma_step_apart)."""
    def terms(z):
        hi = _tf32(z, "truncate")
        lo = _tf32(z - hi, "truncate") if split else torch.zeros_like(z)
        return hi.double(), lo.double()
    (xh, xl), (yh, yl) = terms(x), terms(y)
    d = torch.zeros((x.shape[0], y.shape[1]), dtype=torch.float32)
    c = torch.zeros_like(d)
    for k0 in range(0, x.shape[1], 8):
        ks = slice(k0, k0 + 8)
        if split:
            c = _rz(c.double() + xl[:, ks] @ yh[ks])
            c = _rz(c.double() + xh[:, ks] @ yl[ks])
        d = _rz(d.double() + xh[:, ks] @ yh[ks])
    return d + c


def _emulated_forward(q, k, v, bias, keep, scale, inv_keep, causal,
                      dtype):
    """fused_fwd_kernel's arithmetic for one (b, h) on the CPU: 64-row
    query tiles, 64-key tiles (causal tiles stop at the diagonal), S by
    _mma_product, the online softmax of softmax_tile (bias, causal keys
    at NEG_INF, ex2 of the log2e-scaled argument, the pre-dropout l,
    dead rows contributing 0), dropout, e rounded to bfloat16 for
    bfloat16, and O = O·alpha + P·V with each tile's P·V summed apart.
    q (Tq, D), k and v (Tk, D) as float32 values, bias (Tk,), keep
    (Tq, Tk) bool or None. Returns O (Tq, D) in `dtype`."""
    split = dtype == torch.float32
    Tq, Tk = q.shape[0], k.shape[0]
    neg, log2e = fa.NEG_INF, 1.4426950408889634
    out = torch.empty_like(q)
    for r0 in range(0, Tq, 64):
        rows = torch.arange(r0, min(r0 + 64, Tq))
        n = -(-Tk // 64)
        if causal:
            last = rows[-1].item() + Tk - Tq
            n = 0 if last < 0 else min(n, last // 64 + 1)
        m = torch.full((len(rows),), neg)
        l = torch.zeros(len(rows))
        acc = torch.zeros((len(rows), q.shape[1]))
        for kt in range(n):
            cols = torch.arange(kt * 64, min(kt * 64 + 64, Tk))
            x = _mma_product(q[rows], k[cols].T, split) * scale + bias[cols]
            if causal:
                x = torch.where(rows[:, None] + (Tk - Tq) < cols[None, :],
                                x.clamp(max=neg), x)
            m_new = torch.maximum(m, x.amax(1))
            dead = m_new <= neg / 2
            alpha = torch.where(dead, 1.0, torch.exp2((m - m_new) * log2e))
            ms = torch.where(dead, torch.inf, m_new * log2e)
            e = torch.exp2(x * log2e - ms[:, None])
            l = l * alpha + e.sum(1)
            m = m_new
            if keep is not None:
                e = torch.where(keep[rows][:, cols], e, 0.0)
            if dtype != torch.float32:
                e = e.to(dtype).float()
            acc = acc * alpha[:, None] + _mma_product(e, v[cols], split)
        out[rows] = acc * (inv_keep / l.clamp_min(1e-30))[:, None]
    return out.to(dtype)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emulated_forward_tile_loop_meets_the_kernel_tolerance(dtype,
                                                               causal):
    """The redesigned forward's arithmetic (split-TF32 products whose
    sums the tensor cores truncate, the online softmax over 64-key tiles,
    bfloat16 rounding of e) against the plain version on BERT-shaped
    inputs for one (b, h): T = 130 (off the tile grid), D = 64, key
    padding, dropout 0.1, causal and not; float32 within 1e-5 absolute,
    bfloat16 within 1.2e-2 of the largest plain value, the tolerances
    chip_smoke.py holds the kernel to on the card."""
    T, D, p = 130, 64, 0.1
    rng = np.random.default_rng(7)
    q, k, v = (torch.tensor(rng.standard_normal((1, 1, T, D)),
                            dtype=dtype) for _ in range(3))
    mask = torch.arange(T)[None, :] < torch.tensor([[101]])
    bias = fa._key_bias(mask, 1, T, q.device)
    seed = torch.tensor([12345, -678], dtype=torch.int32)
    scale = 1.0 / math.sqrt(D)
    want = fa._fused_reference(q, k, v, bias, seed, scale, p, causal,
                               "BHTD")[0, 0].float()
    keep = fa._keep_mask(seed, p, 1, 1, T, T)[0, 0]
    got = _emulated_forward(q[0, 0].float(), k[0, 0].float(),
                            v[0, 0].float(), bias[0], keep, scale,
                            1.0 / (1.0 - p), causal, dtype).float()
    err = (got - want).abs().max().item()
    if dtype == torch.float32:
        assert err <= 1e-5
    else:
        assert err <= 1.2e-2 * want.abs().max().item()
    assert got.abs().max().item() > 0
