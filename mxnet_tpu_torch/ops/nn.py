"""Neural-network ops on tensors.

Counterparts of mxnet_tpu/ops/nn.py `FullyConnected` (weight (out, in)),
`LayerNorm`, the `gelu_tanh` activation, `gelu`, `Dropout` and
`dot_product_attention`. The matrix products go to torch.matmul, as the
JAX package leaves them to XLA; attention goes to the fused kernel
(ops/fused_attention.py) where it takes the call.

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

__all__ = ["fully_connected", "layer_norm", "activation", "gelu", "dropout",
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


def layer_norm(x, gamma, beta, eps=1e-5):
    """LayerNorm over the last axis. Normalises in float32 and casts
    back to x's dtype BEFORE gamma/beta, as the JAX op does — in
    bfloat16 the affine step rounds in bfloat16."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    y = ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    return y * gamma + beta


_ACTS = {"gelu": F.gelu,
         "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
         "tanh": torch.tanh}


def activation(x, act_type):
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
