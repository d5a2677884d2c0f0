"""Neural-network ops on tensors.

Counterparts of mxnet_tpu/ops/nn.py `FullyConnected` (weight (out, in)),
`Convolution` (2-D), `BatchNorm`, `LayerNorm`, `Activation`, `gelu`,
`Dropout`, `Pooling` (2-D) and `dot_product_attention`. The matrix
products go to torch.matmul and the convolutions to F.conv2d, as the JAX
package leaves them to XLA (no Pallas body); attention goes to the fused
kernel (ops/fused_attention.py) where it takes the call. BatchNorm and
pooling are plain torch ops that reproduce the reference's arithmetic.

The port has no autograd training scope: where the reference applies
dropout only under `autograd.record(train_mode=True)`, the caller here
passes the rate only in training (the layers pass 0 in eval mode).
Random draws come from mxnet_tpu_torch.rng.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import rng as _rng
from ..base import MXNetError, not_ported
from . import fused_attention as _fa

__all__ = ["fully_connected", "convolution", "batch_norm", "layer_norm",
           "activation", "gelu", "dropout", "pooling",
           "dot_product_attention"]


def fully_connected(x, weight, bias=None, scale=None):
    """x @ weight.T (+ bias): weight is (num_hidden, in_features) as in
    the reference (parity: src/operator/nn/fully_connected.cc).

    An int8 weight is a w8 code array (serving/weight_quant.py) and needs
    its per-out-tile float32 `scale`: y[..., o] = (x @ codes.T)[..., o] *
    scale[o // tile], before the bias (the reference's
    `_w8_dequant_matmul`). The codes are cast to x's dtype for the
    product, which writes a float copy of the weight on every call."""
    if weight.dtype != torch.int8:
        return F.linear(x, weight, bias)
    if scale is None:
        raise MXNetError("an int8 weight reached fully_connected without "
                         "its w8 scales")
    n_out, n_tiles = weight.shape[0], scale.shape[0]
    if n_out % n_tiles:
        raise MXNetError(f"w8 scale count {n_tiles} does not divide out "
                         f"dim {n_out}")
    y = torch.matmul(x, weight.to(x.dtype).T)
    y = y.reshape(*y.shape[:-1], n_tiles, n_out // n_tiles)
    y = (y * scale.to(x.dtype)[:, None]).reshape(*y.shape[:-2], n_out)
    return y if bias is None else y + bias


def _tup(v, n, fill=0):
    """An int/tuple/None window parameter as an n-tuple. As in the
    reference, an absent or all-zero stride/dilate means the default
    when `fill` is nonzero."""
    if v is None:
        return (fill,) * n
    v = (v,) * n if isinstance(v, int) else tuple(int(i) for i in v)
    if fill and v and all(i == 0 for i in v):
        return (fill,) * n
    return v


def convolution(x, weight, bias=None, stride=None, pad=None, dilate=None,
                groups=1):
    """2-D convolution, NCHW input and OIHW weight (O, I/groups, kH, kW),
    symmetric padding, then the bias per output channel (parity:
    src/operator/nn/convolution.cc). The 1-D and 3-D forms and
    Deconvolution are not ported."""
    if weight.dim() != 4:
        raise not_ported(f"{weight.dim() - 2}-D Convolution")
    y = F.conv2d(x, weight, None, _tup(stride, 2, fill=1), _tup(pad, 2),
                 _tup(dilate, 2, fill=1), groups)
    return y if bias is None else y + bias.reshape(1, -1, 1, 1)


def batch_norm(x, gamma, beta, moving_mean, moving_var, eps=1e-5,
               momentum=0.9, fix_gamma=True, use_global_stats=False,
               training=False, axis=1):
    """Batch normalisation with the reference's arithmetic (parity:
    src/operator/nn/batch_norm.cc through mxnet_tpu's BatchNorm op).

    In training (and not `use_global_stats`) the statistics are those of
    the batch, taken in float32 over every axis but `axis`: for bfloat16
    input the variance is one pass, max(E[x^2] - E[x]^2, 0), else two
    passes; it is biased in both. Otherwise the moving statistics
    normalise. The per-channel a = g * rsqrt(var + eps) and
    b = beta - g * rsqrt(var + eps) * mean are computed in float32, cast
    to x's dtype, and y = x * a + b in that dtype (g is 1 under
    `fix_gamma`). Returns y, or in training (y, mean, var) with the
    statistics cast to the moving statistics' dtype; the caller updates
    those (new = old * momentum + batch * (1 - momentum)), as the
    reference's layer does — `momentum` is not read here."""
    red = tuple(i for i in range(x.dim()) if i != axis)
    bshape = tuple(x.shape[axis] if i == axis else 1 for i in range(x.dim()))
    g32 = torch.ones_like(gamma, dtype=torch.float32) if fix_gamma \
        else gamma.float()
    training = training and not use_global_stats
    if training:
        x32 = x.float()
        mean = x32.mean(dim=red)
        if x.dtype == torch.bfloat16:
            var = ((x32 * x32).mean(dim=red) - mean * mean).clamp_min(0.0)
        else:
            var = (x32 - mean.reshape(bshape)).square().mean(dim=red)
    else:
        mean = moving_mean.float()
        var = moving_var.float()
    scale = g32 * torch.rsqrt(var + eps)
    a = scale.to(x.dtype)
    b = (beta.float() - scale * mean).to(x.dtype)
    y = x * a.reshape(bshape) + b.reshape(bshape)
    if training:
        return y, mean.to(moving_mean.dtype), var.to(moving_var.dtype)
    return y


def layer_norm(x, gamma, beta, eps=1e-5):
    """LayerNorm over the last axis. Normalises in float32 and casts
    back to x's dtype BEFORE gamma/beta, as the JAX op does — in
    bfloat16 the affine step rounds in bfloat16."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    y = ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    return y * gamma + beta


_ACTS = {"relu": F.relu,
         "gelu": F.gelu,
         "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
         "tanh": torch.tanh}


def activation(x, act_type):
    """Parity: src/operator/nn/activation.cc (the reference's `_act`;
    its other act_types are not ported)."""
    fn = _ACTS.get(act_type)
    if fn is None:
        raise MXNetError(f"unknown act_type {act_type}")
    return fn(x)


def gelu(x, approximate=False):
    """GELU; approximate=True is the tanh form (the MLM head's)."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def dropout(x, p):
    """Inverted dropout with rate p (parity: the reference's `Dropout`):
    keep with probability 1 - p and scale by 1 / (1 - p). The mask is
    drawn from the current generator of x's device."""
    if p <= 0:
        return x
    u = torch.rand(x.shape, device=x.device,
                   generator=_rng.generator(x.device))
    return torch.where(u < 1.0 - p, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                          device=x.device))


def _full_pad(size, kernel, stride, pad):
    """Extra right padding of the "full" (ceil) pooling convention."""
    extra = []
    for n, k, s, p in zip(size, kernel, stride, pad):
        out = math.ceil((n + 2 * p - k) / s) + 1
        extra.append(max(0, (out - 1) * s + k - (n + 2 * p)))
    return extra


def pooling(x, kernel=None, pool_type="max", global_pool=False, stride=None,
            pad=None, pooling_convention="valid", count_include_pad=True):
    """2-D max or avg pooling of NCHW input (parity:
    src/operator/nn/pooling.cc through lax.reduce_window): max pads with
    -inf, avg divides by the window's size or, without
    `count_include_pad`, by its elements inside the input.
    `pooling_convention="full"` widens the right padding so the output
    size rounds up. A global pool reduces H and W with keepdims; its
    bfloat16 mean accumulates in float32, as jnp.mean does. The "sum"
    and "lp" pool types are not ported."""
    if x.dim() != 4:
        raise not_ported(f"{x.dim() - 2}-D Pooling")
    if pool_type in ("sum", "lp"):
        raise not_ported(f"pool_type {pool_type!r}")
    if pool_type not in ("max", "avg"):
        raise MXNetError(f"unknown pool_type {pool_type}")
    if global_pool:
        if pool_type == "max":
            return x.amax(dim=(2, 3), keepdim=True)
        return x.mean(dim=(2, 3), keepdim=True,
                      dtype=torch.float32).to(x.dtype)
    if pooling_convention not in ("valid", "full"):
        raise MXNetError(f"unknown pooling_convention {pooling_convention}")
    kernel, stride, pad = _tup(kernel, 2), _tup(stride, 2, fill=1), \
        _tup(pad, 2)
    extra = _full_pad(x.shape[2:], kernel, stride, pad) \
        if pooling_convention == "full" else [0, 0]
    if not any(extra) and all(2 * p <= k for p, k in zip(pad, kernel)):
        # torch pads symmetrically up to half the window
        if pool_type == "max":
            return F.max_pool2d(x, kernel, stride, pad)
        return F.avg_pool2d(x, kernel, stride, pad,
                            count_include_pad=count_include_pad)
    # explicit padding: (left, right, top, bottom)
    widths = (pad[1], pad[1] + extra[1], pad[0], pad[0] + extra[0])
    if pool_type == "max":
        return F.max_pool2d(F.pad(x, widths, value=-math.inf), kernel,
                            stride)
    s = F.avg_pool2d(F.pad(x, widths), kernel, stride, divisor_override=1)
    if count_include_pad:
        return s / float(math.prod(kernel))
    ones = F.pad(torch.ones_like(x[:1, :1]), widths)
    return s / F.avg_pool2d(ones, kernel, stride, divisor_override=1)


_ATTN_IMPLS = ("auto", "fused", "torch", "xla")


def _einsum_attention(q, k, v, mask, scale, causal, dropout_p, bthd):
    """The reference's plain softmax attention (its 'xla' path): scores
    in float32, masked with -inf, fully masked rows zero, dropout from
    the current generator."""
    d = q.shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = (torch.einsum("bqhd,bkhd->bhqk" if bthd else "bhqd,bhkd->bhqk",
                           q, k) * s).float()
    Tq, Tk = logits.shape[-2], logits.shape[-1]
    if causal:
        cm = torch.ones((Tq, Tk), dtype=torch.bool,
                        device=q.device).tril(Tk - Tq)
        logits = logits.masked_fill(~cm, -math.inf)
    if mask is not None:
        logits = logits.masked_fill(~mask, -math.inf)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    if causal or mask is not None:
        any_valid = torch.isfinite(logits).any(dim=-1, keepdim=True)
        w = torch.where(any_valid, w, torch.zeros((), dtype=w.dtype,
                                                  device=w.device))
    if dropout_p > 0:
        w = dropout(w, dropout_p)
    return torch.einsum("bhqk,bkhd->bqhd" if bthd else "bhqk,bhkd->bhqd",
                        w, v)


def dot_product_attention(q, k, v, mask=None, scale=None, causal=False,
                          dropout_p=0.0, impl="auto", layout="BHTD"):
    """q, k, v: (B, H, T, D), or (B, T, H, D) with layout="BTHD" (the
    shape a head-split reshape produces; both routes take it natively).

    impl 'auto' and 'fused' go to the fused attention kernel whenever
    fused_attention.supported() holds (float32/bfloat16, head dim <= 128,
    key-padding mask or none; any T), with seed words drawn
    from the current generator when dropout_p > 0; 'torch' takes the same
    route through the kernel's plain PyTorch version (the reference the
    kernel is held to). Otherwise 'auto', 'torch' and 'xla' take one
    plain softmax attention, and 'fused' raises. 'flash', 'ring' and
    'ulysses' are not ported.

    mask: (B, Tk) key padding, or a boolean mask broadcastable to
    (B, H, Tq, Tk); True = attend. Fully masked rows yield zeros.
    dropout_p applies as given: pass 0 outside training."""
    if impl in ("flash", "ring", "ulysses"):
        raise not_ported(f"dot_product_attention impl={impl!r}")
    if impl not in _ATTN_IMPLS:
        raise MXNetError(f"unknown attention impl {impl!r}")
    if layout not in ("BHTD", "BTHD"):
        raise MXNetError(f"unknown attention layout {layout!r}")
    if mask is not None and mask.dim() == 2:
        # (B, Tk) key padding -> canonical (B, 1, 1, Tk) for every path
        mask = mask[:, None, None, :]
    if impl != "xla":
        if _fa.supported(q, k, mask, layout=layout):
            seed = _rng.seed_words(q.device) if dropout_p > 0 else None
            return _fa.fused_attention(
                q, k, v, mask=mask, scale=scale, causal=causal,
                dropout_p=dropout_p, seed=seed, layout=layout,
                impl="torch" if impl == "torch" else "auto")
        if impl == "fused":
            # an explicit request must not silently measure another path
            raise MXNetError("dot_product_attention impl='fused': the fused "
                             "kernel does not take this call")
    return _einsum_attention(q, k, v, mask, scale, causal, dropout_p,
                             layout == "BTHD")
