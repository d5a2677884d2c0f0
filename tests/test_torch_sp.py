"""Sequence parallelism (ring and Ulysses attention over the "sp" axis)
against the JAX package.

The JAX side runs parallel.ring_attention / ulysses_attention on
conftest's 8-device virtual CPU mesh; the port's on `["cpu"] * N`,
where the per-shard attention is the fused kernel's plain version. Same
seeded (B, H, T, D) operands; outputs and gradients at atol 1e-5. The
gradient oracle is jax.grad of the single-device attention (the JAX
tests hold their sp routes' gradients to it too; differentiating the
reference's shard_map on the virtual mesh takes tens of seconds).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mxnet_tpu import parallel as jpar  # noqa: E402
from mxnet_tpu.ops.nn import dot_product_attention as jdpa  # noqa: E402

from mxnet_tpu_torch import MXNetError  # noqa: E402
from mxnet_tpu_torch import parallel as par  # noqa: E402
from mxnet_tpu_torch.ops import nn as port_nn  # noqa: E402

B, T, D = 2, 32, 8


def _qkv(H=4, seed=0):
    r = np.random.default_rng(seed)
    return [r.standard_normal((B, H, T, D)).astype(np.float32)
            for _ in range(3)]


def _mask(seed, full=False):
    if full:
        m = np.ones((B, T), bool)
        m[1] = False               # row 1: every key masked
        return m
    return np.random.default_rng(seed).random((B, T)) > 0.3


def _jax(kind, arrays, n_sp, mask, causal, grads):
    fn = jpar.ring_attention if kind == "ring" else jpar.ulysses_attention
    mesh = jpar.make_mesh(sp=n_sp, devices=jax.devices()[:n_sp])
    m = None if mask is None else jnp.asarray(mask)

    def f(q, k, v):
        with jpar.mesh_scope(mesh):
            return fn(q, k, v, mask=m, causal=causal)

    q, k, v = (jnp.asarray(a) for a in arrays)
    out = np.asarray(f(q, k, v))
    if not grads:
        return out, None

    def single(q, k, v):
        o = jdpa.raw_fn(q, k, v, mask=None if m is None else
                        m[:, None, None, :], causal=causal, impl="xla")
        return (o * o).sum()

    g = jax.grad(single, argnums=(0, 1, 2))(q, k, v)
    return out, [np.asarray(x) for x in g]


def _port(kind, arrays, n_sp, mask, causal, grads):
    fn = par.ring_attention if kind == "ring" else par.ulysses_attention
    mesh = par.make_mesh(sp=n_sp, devices=["cpu"] * n_sp)
    q, k, v = (torch.from_numpy(a).requires_grad_(grads) for a in arrays)
    m = None if mask is None else torch.from_numpy(mask)
    with par.mesh_scope(mesh):
        out = fn(q, k, v, mask=m, causal=causal)
    if not grads:
        return out.detach().numpy(), None
    (out * out).sum().backward()
    return out.detach().numpy(), [x.grad.numpy() for x in (q, k, v)]


@pytest.mark.parametrize("kind", ["ring", "ulysses"])
@pytest.mark.parametrize("case", ["plain", "causal", "padding",
                                  "masked_rows"])
def test_sp_attention_matches_jax(kind, case):
    n_sp = 4
    arrays = _qkv()
    mask = {"padding": _mask(1), "masked_rows": _mask(0, full=True)}.get(
        case)
    causal = case in ("causal", "masked_rows")
    grads = case in ("causal", "padding")
    want, wg = _jax(kind, arrays, n_sp, mask, causal, grads)
    got, gg = _port(kind, arrays, n_sp, mask, causal, grads)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if case == "masked_rows":
        np.testing.assert_array_equal(got[1], 0.0)
    for a, b in zip(gg or (), wg or ()):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_sp_routes_and_refusals_match_jax():
    """impl='auto' picks the reference's route (Ulysses when the heads
    divide by sp, ring otherwise, none for T % sp or attention dropout);
    ring / ulysses refuse dropout, a mesh without sp and bad heads."""
    from mxnet_tpu.ops.nn import _sp_auto_impl as jauto
    mesh = par.make_mesh(sp=4, devices=["cpu"] * 4)
    jmesh = jpar.make_mesh(sp=4, devices=jax.devices()[:4])
    for H, Tq in ((4, 32), (2, 32), (4, 30)):
        a = _qkv(H)
        tq = torch.from_numpy(a[0][:, :, :Tq])
        jq = jnp.asarray(a[0][:, :, :Tq])
        for drop in (False, True):
            with par.mesh_scope(mesh), jpar.mesh_scope(jmesh):
                got = port_nn._sp_auto_impl(tq, tq, None, drop)
                assert got == jauto(jq, jq, None, train_drop=drop)
        # and the values of the auto route are the plain attention's
        tk, tv = (torch.from_numpy(x[:, :, :Tq]) for x in a[1:])
        with par.mesh_scope(mesh):
            out = port_nn.dot_product_attention(tq, tk, tv, impl="auto")
        ref = jdpa.raw_fn(jq, *(jnp.asarray(x[:, :, :Tq]) for x in a[1:]),
                          impl="xla")
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5)
    q, k, v = (torch.from_numpy(x) for x in _qkv())
    assert port_nn._sp_auto_impl(q, k, None, False) is None  # no mesh
    with par.mesh_scope(mesh):
        for impl in ("ring", "ulysses"):
            with pytest.raises(MXNetError, match="dropout"):
                port_nn.dot_product_attention(q, k, v, impl=impl,
                                              dropout_p=0.1)
        with pytest.raises(MXNetError, match="ring_attention"):
            par.ulysses_attention(*(torch.from_numpy(x)
                                    for x in _qkv(H=2)))
    with par.mesh_scope(par.make_mesh(dp=4, devices=["cpu"] * 4)):
        with pytest.raises(MXNetError, match="'sp' axis"):
            par.ring_attention(q, k, v)
    with par.mesh_scope(par.make_mesh(tp=2, sp=4, devices=["cpu"] * 8)):
        with pytest.raises(MXNetError, match="per-device heads"):
            par.ulysses_attention(q, k, v)
    assert par.sp_enabled(mesh) and not par.sp_enabled(None)


def test_ulysses_records_all_to_all_and_ring_permutes():
    q, k, v = (torch.from_numpy(x) for x in _qkv())
    mesh = par.make_mesh(sp=4, devices=["cpu"] * 4)
    from mxnet_tpu_torch.parallel import collectives
    with par.mesh_scope(mesh), collectives.recording() as rec:
        par.ulysses_attention(q, k, v)
        par.ring_attention(q, k, v)
    kinds = [r["kind"] for r in rec]
    assert kinds.count("all_to_all") == 4         # q, k, v in; out back
    assert kinds.count("collective_permute") == 2 * 3   # k, v; 3 hops
    per_shard = B * 4 * (T // 4) * D * 4
    assert all(r["bytes"] == per_shard for r in rec)
