"""Basic layers as torch modules.

Counterparts of mxnet_tpu/gluon/nn/basic_layers.py `Dense`,
`HybridSequential`, `BatchNorm`, `LayerNorm`, `Embedding`, `Dropout` and
`Flatten`, and of `Activation` (mxnet_tpu/gluon/nn/activations.py), with the
reference's parameter names (weight/bias, gamma/beta, running_mean/
running_var) so that a structure path such as
`backbone.layer0.attn.query.weight` or `features.4.0.body.1.running_var`
names the same tensor in both packages. Parameters are allocated
uninitialised on the given device; models/convert.py or
initializer.initialize fills them (seeded random, or from the JAX
package). BatchNorm's running statistics are parameters that do not
require grad (the reference's grad_req "null"), so the optimizer of
parallel.TrainStep never sees them. Inference paths (the serving engine)
run under torch.no_grad.

Every layer is a gluon HybridBlock whose forward is written over tensors
(gluon/block.py): it also takes NDArrays, and gains `collect_params()` /
`initialize()`. Dropout and BatchNorm's batch statistics are on when
`autograd.training_active(layer)` holds: the layer is in train() mode
(as parallel.TrainStep sets it) or the autograd scope is training (a
gluon user under `autograd.record()`), so TrainStep and the serving
engine run as before and a gluon user gets the reference's behaviour.
"""
from __future__ import annotations

import functools

import torch
from torch import nn

from .. import autograd as _ag
from ..base import MXNetError
from ..gluon.block import Block, HybridBlock
from ..ops import nn as _ops

__all__ = ["Dense", "BatchNorm", "LayerNorm", "Embedding", "Dropout",
           "Flatten", "Activation", "HybridSequential", "Sequential",
           "TensorBlock"]


class TensorBlock(HybridBlock):
    """A HybridBlock whose forward takes and returns tensors."""

    _forward_kind = "tensor"


def _param(*shape, device, dtype, requires_grad=True):
    return nn.Parameter(torch.empty(*shape, device=device, dtype=dtype),
                        requires_grad=requires_grad)


@functools.lru_cache(maxsize=16)
def _in_dtype(value, dtype):
    """`value` rounded to `dtype`: the reference multiplies an array by a
    Python float as a weakly typed scalar of the array's own dtype (0.9
    is 0.8984375 against a bfloat16 array)."""
    return float(torch.tensor(value, dtype=dtype))


class Dense(TensorBlock):
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


class BatchNorm(TensorBlock):
    """Batch normalisation over `axis` with running statistics (parity:
    gluon.nn.BatchNorm). In train() mode (and not `use_global_stats`)
    the batch's statistics normalise and the running ones are updated
    in place, outside autograd: new = old * momentum + batch * (1 -
    momentum), in the statistics' dtype, as the reference's
    `_update_stats`. In eval() mode the running statistics normalise.
    scale=False fixes gamma at 1 and center=False leaves beta at its
    value; neither then requires grad."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, *, in_channels,
                 device=None, dtype=torch.float32):
        super().__init__()
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._scale = scale
        self._use_global_stats = use_global_stats
        kw = dict(device=device, dtype=dtype)
        self.gamma = _param(in_channels, requires_grad=scale, **kw)
        self.beta = _param(in_channels, requires_grad=center, **kw)
        self.running_mean = _param(in_channels, requires_grad=False, **kw)
        self.running_var = _param(in_channels, requires_grad=False, **kw)

    def forward(self, x):
        out = _ops.batch_norm(
            x, self.gamma, self.beta, self.running_mean, self.running_var,
            eps=self._epsilon, momentum=self._momentum,
            fix_gamma=not self._scale,
            use_global_stats=self._use_global_stats,
            training=_ag.training_active(self),
            axis=self._axis)
        if not isinstance(out, tuple):
            return out
        y, mean, var = out
        self._update_stats(mean, var)
        return y

    def _update_stats(self, mean, var):
        m = self._momentum
        with torch.no_grad():
            for stat, batch in ((self.running_mean, mean),
                                (self.running_var, var)):
                stat.mul_(_in_dtype(m, stat.dtype)).add_(
                    batch.detach() * _in_dtype(1 - m, stat.dtype))

    def extra_repr(self):
        return (f"axis={self._axis}, eps={self._epsilon}, "
                f"momentum={self._momentum}, "
                f"in_channels={self.gamma.shape[0]}")


class LayerNorm(TensorBlock):
    def __init__(self, in_channels, epsilon=1e-5, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.epsilon = epsilon
        self.gamma = _param(in_channels, device=device, dtype=dtype)
        self.beta = _param(in_channels, device=device, dtype=dtype)

    def forward(self, x):
        return _ops.layer_norm(x, self.gamma, self.beta, self.epsilon)


class Embedding(TensorBlock):
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


class Dropout(TensorBlock):
    """Inverted dropout, active in train() mode or under autograd
    training. Draws from the current generator (mxnet_tpu_torch.rng)."""

    def __init__(self, rate):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x):
        return _ops.dropout(x, self.rate) if _ag.training_active(self) else x


class Flatten(TensorBlock):
    """(B, ...) -> (B, -1) (parity: gluon.nn.Flatten)."""

    def forward(self, x):
        return x.reshape(x.shape[0], -1)


class Activation(TensorBlock):
    """ops.nn.activation as a layer (parity: gluon.nn.Activation)."""

    def __init__(self, activation):
        super().__init__()
        self._act = activation

    def forward(self, x):
        return _ops.activation(x, self._act)

    def extra_repr(self):
        return self._act


class HybridSequential(HybridBlock, nn.Sequential):
    """Children run in order and are named 0, 1, ... as the reference's
    (parity: gluon.nn.HybridSequential; `add` appends). Its inputs pass
    through unchanged: each child adapts them to its own kind."""

    _forward_kind = "any"

    def add(self, *blocks):
        for b in blocks:
            self.append(b)
        return self


class Sequential(Block, nn.Sequential):
    """Parity: gluon.nn.Sequential."""

    _forward_kind = "any"

    def add(self, *blocks):
        for b in blocks:
            self.append(b)
        return self
