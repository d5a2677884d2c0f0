"""Basic layers with the reference's constructors.

Counterpart of mxnet_tpu/gluon/nn/basic_layers.py: thin subclasses of
the port's layers (mxnet_tpu_torch/nn) that take the reference's
arguments (`Dense(units, activation=None, use_bias=True, flatten=True,
dtype, weight_initializer, bias_initializer, in_units=0)`, ...), keep
its deferred shapes (a 0 is filled at the first call) and its
initializers, and the cheap layers the port lacked: Identity, Lambda,
HybridLambda, (Hybrid)Concatenate, GroupNorm, RMSNorm and
InstanceNorm. The port's own models keep the port's argument order.
"""
from __future__ import annotations

import math

import torch

from ... import autograd as _ag
from ... import nn as _pnn
from ...base import MXNetError
from ...ops import nn as _nnops
from ...ops import registry as _registry
from ...ops import tensor as _tensor
from ..block import Block, HybridBlock
from ..parameter import Parameter
from ._common import META, configure, dtype_of, fill_shape, gluon_mode

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout",
           "Embedding", "BatchNorm", "InstanceNorm", "LayerNorm",
           "GroupNorm", "RMSNorm", "Flatten", "Lambda", "HybridLambda",
           "Identity", "Concatenate", "HybridConcatenate"]

Sequential = _pnn.Sequential
HybridSequential = _pnn.HybridSequential
Flatten = _pnn.Flatten


class Dense(_pnn.Dense):
    """Parity: gluon.nn.Dense; weight (units, in_units)."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, **kwargs):
        super().__init__(in_units, units, use_bias=use_bias, device=META,
                         dtype=dtype_of(dtype))
        self._units = units
        self._flatten = flatten
        self._act = activation
        configure(self, weight=weight_initializer, bias=bias_initializer)

    def infer_shape(self, x, *args):
        in_units = math.prod(x.shape[1:]) if self._flatten else x.shape[-1]
        fill_shape(self, "weight", (self._units, in_units))

    def forward(self, x, bias=True):
        if self._flatten and x.dim() > 2:
            x = x.reshape(x.shape[0], -1)
        y = super().forward(x, bias)
        return y if self._act is None else _nnops.Activation(y, self._act)

    def extra_repr(self):
        return (f"{self.weight.shape[1] or None} -> {self._units}, "
                f"{self._act or 'linear'}")


class Dropout(_pnn.Dropout):
    """Parity: gluon.nn.Dropout(rate, axes): one mask shared along
    `axes`."""

    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(rate)
        self._axes = tuple(axes)
        gluon_mode(self)

    def forward(self, x):
        if not self._axes:
            return super().forward(x)
        if not _ag.training_active(self) or self.rate <= 0:
            return x
        shape = tuple(1 if i in self._axes else s
                      for i, s in enumerate(x.shape))
        mask = _nnops.dropout(torch.ones(shape, dtype=x.dtype,
                                         device=x.device), self.rate)
        return x * mask


class Embedding(_pnn.Embedding):
    """Parity: gluon.nn.Embedding; indices past the table clip, as the
    reference's take does. sparse_grad is not ported (dense
    gradients)."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, **kwargs):
        super().__init__(input_dim, output_dim, device=META,
                         dtype=dtype_of(dtype))
        configure(self, weight=weight_initializer)

    def forward(self, ids):
        return self.weight[ids.long().clamp(0, self.weight.shape[0] - 1)]


class BatchNorm(_pnn.BatchNorm):
    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 **kwargs):
        super().__init__(axis, momentum, epsilon, center, scale,
                         use_global_stats, in_channels=in_channels,
                         device=META)
        configure(self, gamma=gamma_initializer, beta=beta_initializer,
                  running_mean=running_mean_initializer,
                  running_var=running_variance_initializer)

    def infer_shape(self, x, *args):
        c = x.shape[self._axis]
        for name in ("gamma", "beta", "running_mean", "running_var"):
            fill_shape(self, name, (c,))


class _Norm(_pnn.layers.TensorBlock):
    """gamma / beta of `in_channels` over one axis."""

    def __init__(self, axis, epsilon, center, scale, beta_initializer,
                 gamma_initializer, in_channels, use_beta=True):
        super().__init__()
        self._axis = axis
        self._epsilon = epsilon
        self.gamma = Parameter("gamma", shape=(in_channels,),
                               init=gamma_initializer,
                               allow_deferred_init=True,
                               grad_req="write" if scale else "null")
        if use_beta:
            self.beta = Parameter("beta", shape=(in_channels,),
                                  init=beta_initializer,
                                  allow_deferred_init=True,
                                  grad_req="write" if center else "null")
        object.__setattr__(self, "_deferred", True)
        gluon_mode(self)

    def infer_shape(self, x, *args):
        c = x.shape[self._axis]
        for name in ("gamma", "beta"):
            if name in self._parameters:
                self.__dict__[name].shape = (c,)

    def _gb(self):
        g = self._parameters["gamma"]
        return g, self._parameters.get("beta")


class LayerNorm(_Norm):
    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(axis, epsilon, center, scale, beta_initializer,
                         gamma_initializer, in_channels)

    def forward(self, x):
        g, b = self._gb()
        return _nnops.LayerNorm(x, g, b, axis=self._axis, eps=self._epsilon)


class GroupNorm(_Norm):
    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(1, epsilon, center, scale, beta_initializer,
                         gamma_initializer, in_channels)
        self._num_groups = num_groups

    def forward(self, x):
        g, b = self._gb()
        return _nnops.GroupNorm(x, g, b, num_groups=self._num_groups,
                                eps=self._epsilon)


class InstanceNorm(_Norm):
    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        if axis != 1:
            raise MXNetError("InstanceNorm supports axis=1 (NC+) only")
        super().__init__(1, epsilon, center, scale, beta_initializer,
                         gamma_initializer, in_channels)

    def forward(self, x):
        g, b = self._gb()
        return _nnops.InstanceNorm(x, g, b, eps=self._epsilon)


class RMSNorm(_Norm):
    def __init__(self, axis=-1, epsilon=1e-6, gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(axis, epsilon, True, True, None, gamma_initializer,
                         in_channels, use_beta=False)

    def forward(self, x):
        g, _ = self._gb()
        return _nnops.rms_norm(x, g, axis=self._axis, eps=self._epsilon)


class Identity(HybridBlock):
    _forward_kind = "any"

    def forward(self, x):
        return x


def _resolve(function):
    return _registry.get_op(function) if isinstance(function, str) \
        else function


class Lambda(Block):
    """A function (or a registered op's name) as a block; its inputs pass
    through unchanged."""

    _forward_kind = "any"

    def __init__(self, function, **kwargs):
        super().__init__()
        self._func = _resolve(function)

    def forward(self, *args):
        return self._func(*args)


class HybridLambda(Lambda, HybridBlock):
    pass


class HybridConcatenate(HybridBlock):
    """Runs every child on the same input and concatenates the outputs
    along `axis`."""

    _forward_kind = "any"

    def __init__(self, axis=-1, **kwargs):
        super().__init__()
        self.axis = axis

    def add(self, *blocks):
        for b in blocks:
            self.register_child(b)
        return self

    def forward(self, x):
        return _tensor.concat(*[b(x) for b in self._modules.values()],
                              dim=self.axis)


class Concatenate(HybridConcatenate):
    pass
