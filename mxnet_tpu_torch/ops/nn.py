"""Neural-network ops on tensors: the serving path's plain operators.

Counterparts of mxnet_tpu/ops/nn.py `FullyConnected` (weight (out, in)),
`LayerNorm` and the `gelu_tanh` activation. The matrix products go to
torch.matmul, as the JAX package leaves them to XLA.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError

__all__ = ["fully_connected", "layer_norm", "activation"]


def fully_connected(x, weight, bias=None):
    """x @ weight.T (+ bias): weight is (num_hidden, in_features) as in
    the reference (parity: src/operator/nn/fully_connected.cc)."""
    return F.linear(x, weight, bias)


def layer_norm(x, gamma, beta, eps=1e-5):
    """LayerNorm over the last axis. Normalises in float32 and casts
    back to x's dtype BEFORE gamma/beta, as the JAX op does — in
    bfloat16 the affine step rounds in bfloat16."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    y = ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    return y * gamma + beta


_ACTS = {"gelu_tanh": lambda x: F.gelu(x, approximate="tanh")}


def activation(x, act_type):
    fn = _ACTS.get(act_type)
    if fn is None:
        raise MXNetError(f"unknown act_type {act_type}")
    return fn(x)
