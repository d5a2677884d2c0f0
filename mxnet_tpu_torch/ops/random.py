"""Random sampling ops.

Counterpart of mxnet_tpu/ops/random.py: its 18 samplers and `seed`.
Every draw comes from the port's `rng` generators on the device the
result lands on (`ctx=`, the device of an array argument, else the
default device), so `mx.random.seed(n)` makes the draws repeat within
the port. The streams are not `jax.random`'s: the same seed gives other
numbers than the reference (rng.py), so tests hold these samplers by
their moments and by their determinism under a seed.
"""
from __future__ import annotations

import math

import torch

from .. import device as _device
from .. import rng as _rng
from .registry import op

__all__ = ["seed"]


def _shape(shape):
    if shape is None:
        return ()
    if isinstance(shape, int):
        return (shape,)
    return tuple(shape)


def _dt(dtype):
    from ..ndarray.ndarray import to_torch_dtype
    return to_torch_dtype(dtype)


def _dev(ctx, *arrays):
    for a in arrays:
        if isinstance(a, torch.Tensor):
            return a.device
    return _device.to_torch(ctx)


def _gen(dev):
    return _rng.generator(dev)


def _uniform(shape, dev, dtype=torch.float32):
    return torch.rand(shape, device=dev, generator=_gen(dev), dtype=dtype)


def _gamma(alpha, dev):
    """Gamma(alpha, 1) draws of alpha's shape (Marsaglia-Tsang with the
    alpha < 1 boost), from the device's generator."""
    a = alpha.to(torch.float32)
    boost = a < 1
    d = torch.where(boost, a + 1, a) - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.zeros_like(d)
    todo = torch.ones_like(d, dtype=torch.bool)
    gen = _gen(dev)
    while bool(todo.any()):
        x = torch.randn(d.shape, device=dev, generator=gen)
        u = torch.rand(d.shape, device=dev, generator=gen)
        v = (1 + c * x) ** 3
        ok = (v > 0) & (torch.log(u.clamp_min(1e-38))
                        < 0.5 * x * x + d - d * v
                        + d * torch.log(v.clamp_min(1e-38)))
        take = todo & ok
        out = torch.where(take, d * v, out)
        todo = todo & ~ok
    u = torch.rand(d.shape, device=dev, generator=gen).clamp_min(1e-38)
    return torch.where(boost, out * u ** (1.0 / a), out)


def _poisson(lam, dev):
    return torch.poisson(lam.to(torch.float32), generator=_gen(dev))


@op("random_uniform", nodiff=True)
def uniform(low=0.0, high=1.0, shape=None, dtype="float32", ctx=None):
    dev = _dev(ctx, low, high)
    u = _uniform(_shape(shape), dev, _dt(dtype))
    return u * (high - low) + low


@op("random_normal", nodiff=True)
def normal(loc=0.0, scale=1.0, shape=None, dtype="float32", ctx=None):
    dev = _dev(ctx, loc, scale)
    z = torch.randn(_shape(shape), device=dev, generator=_gen(dev),
                    dtype=_dt(dtype))
    return z * scale + loc


random_normal = normal
random_uniform = uniform


@op("random_randint", nodiff=True)
def randint(low, high, shape=None, dtype="int32", ctx=None):
    dev = _dev(ctx)
    return torch.randint(int(low), int(high), _shape(shape), device=dev,
                         generator=_gen(dev), dtype=_dt(dtype))


@op("random_gamma", nodiff=True)
def gamma(alpha=1.0, beta=1.0, shape=None, dtype="float32", ctx=None):
    dev = _dev(ctx, alpha)
    a = torch.full(_shape(shape), float(alpha), device=dev) \
        if not isinstance(alpha, torch.Tensor) else \
        alpha.float().broadcast_to(_shape(shape) or alpha.shape)
    return (_gamma(a, dev) * beta).to(_dt(dtype))


@op("random_exponential", nodiff=True)
def exponential(scale=1.0, shape=None, dtype="float32", ctx=None):
    dev = _dev(ctx)
    u = _uniform(_shape(shape), dev)
    return (-torch.log1p(-u) * scale).to(_dt(dtype))


@op("random_poisson", nodiff=True)
def poisson(lam=1.0, shape=None, dtype="float32", ctx=None):
    dev = _dev(ctx, lam)
    rates = torch.full(_shape(shape), float(lam), device=dev)
    return _poisson(rates, dev).to(_dt(dtype))


@op("random_negative_binomial", nodiff=True)
def negative_binomial(k=1, p=0.5, shape=None, dtype="float32", ctx=None):
    dev = _dev(ctx)
    a = torch.full(_shape(shape), float(k), device=dev)
    lam = _gamma(a, dev) * ((1 - p) / p)
    return _poisson(lam, dev).to(_dt(dtype))


@op("random_generalized_negative_binomial", nodiff=True)
def generalized_negative_binomial(mu=1.0, alpha=1.0, shape=None,
                                  dtype="float32", ctx=None):
    dev = _dev(ctx)
    r = 1.0 / alpha
    p = r / (r + mu)
    lam = _gamma(torch.full(_shape(shape), r, device=dev), dev) \
        * ((1 - p) / p)
    return _poisson(lam, dev).to(_dt(dtype))


@op("sample_multinomial", nodiff=True)
def multinomial(data, shape=1, get_prob=False, dtype="int32"):
    """data (..., K) probabilities; `shape` draws a row."""
    dev = data.device
    n = shape if isinstance(shape, int) else math.prod(shape)
    batch = tuple(data.shape[:-1])
    probs = data.reshape(-1, data.shape[-1]).float().clamp_min(0)
    samp = torch.multinomial(probs, n, replacement=True,
                             generator=_gen(dev))
    out_shape = batch + ((n,) if n > 1 else ())
    out = samp.reshape(out_shape).to(_dt(dtype))
    if get_prob:
        lsm = torch.log_softmax(torch.log(probs.clamp_min(1e-38)), dim=-1)
        lp = torch.gather(lsm, 1, samp)
        return (out, lp.reshape(out_shape))
    return out


@op("categorical", nodiff=True)
def categorical(logits, shape=None, axis=-1, dtype="int32"):
    dev = logits.device
    x = logits.movedim(axis, -1)
    batch = tuple(x.shape[:-1])
    s = _shape(shape)
    n = math.prod(s) // max(math.prod(batch), 1) if s else 1
    g = -torch.log(-torch.log(
        _uniform((n,) + batch + (x.shape[-1],), dev).clamp_min(1e-38)))
    idx = torch.argmax(x.float() + g, dim=-1)
    return idx.reshape(s if s else batch).to(_dt(dtype))


@op("shuffle", nodiff=True)
def shuffle(data, axis=0):
    dev = data.device
    perm = torch.randperm(data.shape[axis], device=dev, generator=_gen(dev))
    return data.index_select(axis, perm)


@op("random_permutation", nodiff=True)
def permutation(n, ctx=None, dtype="int32"):
    dev = _dev(ctx)
    return torch.randperm(int(n), device=dev, generator=_gen(dev)).to(
        _dt(dtype))


@op("bernoulli", nodiff=True)
def bernoulli(prob=None, logit=None, shape=None, dtype="float32", ctx=None):
    dev = _dev(ctx, prob, logit)
    if prob is None:
        prob = torch.sigmoid(logit) if isinstance(logit, torch.Tensor) \
            else 1.0 / (1.0 + math.exp(-logit))
    p = prob if isinstance(prob, torch.Tensor) else torch.tensor(
        float(prob), device=dev)
    s = _shape(shape) if shape is not None else tuple(p.shape)
    return (_uniform(s, dev) < p).to(_dt(dtype))


def _per_param(param, s):
    return param.reshape(tuple(param.shape) + (1,) * len(s)) if s else param


@op("sample_gamma", nodiff=True)
def sample_gamma(alpha, beta, shape=None, dtype="float32"):
    dev = alpha.device
    s = _shape(shape)
    full = tuple(alpha.shape) + s
    a = _per_param(alpha.float(), s).broadcast_to(full)
    return (_gamma(a, dev) * _per_param(beta, s)).to(_dt(dtype))


@op("sample_normal", nodiff=True)
def sample_normal(mu, sigma, shape=None, dtype="float32"):
    dev = mu.device
    s = _shape(shape)
    z = torch.randn(tuple(mu.shape) + s, device=dev, generator=_gen(dev),
                    dtype=_dt(dtype))
    return z * _per_param(sigma, s) + _per_param(mu, s)


@op("sample_uniform", nodiff=True)
def sample_uniform(low, high, shape=None, dtype="float32"):
    dev = low.device
    s = _shape(shape)
    u = _uniform(tuple(low.shape) + s, dev, _dt(dtype))
    lo, hi = _per_param(low, s), _per_param(high, s)
    return u * (hi - lo) + lo


@op("gumbel", nodiff=True)
def gumbel(shape=None, dtype="float32", ctx=None):
    dev = _dev(ctx)
    u = _uniform(_shape(shape), dev).clamp_min(1e-38)
    return (-torch.log(-torch.log(u))).to(_dt(dtype))


@op("laplace", nodiff=True)
def laplace(loc=0.0, scale=1.0, shape=None, dtype="float32", ctx=None):
    dev = _dev(ctx)
    u = _uniform(_shape(shape), dev) - 0.5
    z = -torch.sign(u) * torch.log1p(-2 * torch.abs(u))
    return (z * scale + loc).to(_dt(dtype))


def seed(seed_state, ctx=None):
    """Reseed every device's generator (parity: mx.random.seed)."""
    _rng.seed(seed_state)
