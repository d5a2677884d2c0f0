"""Basic layers as torch modules.

Counterparts of mxnet_tpu/gluon/nn/basic_layers.py `Dense`, `LayerNorm`,
`Embedding` and `Dropout`, with the reference's parameter names
(weight/bias, gamma/beta) so that a structure path such as
`backbone.layer0.attn.query.weight` names the same tensor in both
packages. Parameters are trainable and allocated uninitialised on the
given device; models/convert.py fills them (seeded random, or from the
JAX package). Inference paths (the serving engine) run under
torch.no_grad.
"""
from __future__ import annotations

import torch
from torch import nn

from ..base import MXNetError
from ..ops import nn as _ops

__all__ = ["Dense", "LayerNorm", "Embedding", "Dropout"]


def _param(*shape, device, dtype):
    return nn.Parameter(torch.empty(*shape, device=device, dtype=dtype))


class Dense(nn.Module):
    """y = x @ weight.T + bias with weight (units, in_units).

    `quantize_(codes, scale)` turns the layer into a w8 layer for
    serving: the int8 `codes` (units, in_units) and float32 per-out-tile
    `scale` become buffers and the float weight is dropped."""

    def __init__(self, in_units, units, use_bias=True, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.weight = _param(units, in_units, device=device, dtype=dtype)
        self.bias = _param(units, device=device, dtype=dtype) \
            if use_bias else None
        self.register_buffer("codes", None)
        self.register_buffer("scale", None)

    def quantize_(self, codes, scale):
        if tuple(codes.shape) != tuple(self.weight.shape):
            raise MXNetError(f"w8 codes of shape {tuple(codes.shape)} for "
                             f"a weight of {tuple(self.weight.shape)}")
        del self.weight
        self.weight = None
        self.codes = codes.to(torch.int8)
        self.scale = scale.float()
        return self

    def forward(self, x, bias=True):
        """bias=False: the bias-free product (a row-parallel shard's
        partial, whose bias is added once after the reduction)."""
        b = self.bias if bias else None
        if self.codes is not None:
            return _ops.fully_connected(x, self.codes, b, scale=self.scale)
        return _ops.fully_connected(x, self.weight, b)


class LayerNorm(nn.Module):
    def __init__(self, in_channels, epsilon=1e-5, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.epsilon = epsilon
        self.gamma = _param(in_channels, device=device, dtype=dtype)
        self.beta = _param(in_channels, device=device, dtype=dtype)

    def forward(self, x):
        return _ops.layer_norm(x, self.gamma, self.beta, self.epsilon)


class Embedding(nn.Module):
    """Row lookup into weight (input_dim, output_dim). Indices must lie
    in range: unlike jnp.take, torch raises (CPU) or asserts on the
    device (CUDA) for an index past the table."""

    def __init__(self, input_dim, output_dim, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.weight = _param(input_dim, output_dim, device=device,
                             dtype=dtype)

    def forward(self, ids):
        return self.weight[ids]


class Dropout(nn.Module):
    """Inverted dropout, active only in train() mode (the reference's is
    active only under autograd training). Draws from the current
    generator (mxnet_tpu_torch.rng)."""

    def __init__(self, rate):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x):
        return _ops.dropout(x, self.rate) if self.training else x
