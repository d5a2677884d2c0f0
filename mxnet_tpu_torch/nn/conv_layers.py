"""Convolution and pooling layers.

Counterparts of mxnet_tpu/gluon/nn/conv_layers.py `Conv2D` (through
`_Conv`), `MaxPool2D`, `AvgPool2D` and `GlobalAvgPool2D`, channel-first (NCHW) as the reference's default. The
reference infers a convolution's input channels at the first forward;
torch has no deferred shapes, so `in_channels` is a required argument
here. The weight (channels, in_channels / groups, kH, kW) is allocated
uninitialised on the given device, as the other layers' are
(initializer.initialize or models/convert.py fills it).

Not ported yet: the 1-D and 3-D forms, the transposed convolutions,
the global max pools, ReflectionPad2D and Conv2D's fused `activation`.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from ..ops import nn as _ops
from .layers import TensorBlock, _param

__all__ = ["Conv2D", "MaxPool2D", "AvgPool2D", "GlobalAvgPool2D"]


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


class Conv2D(TensorBlock):
    """y = conv2d(x, weight) (+ bias)."""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", *, in_channels,
                 use_bias=True, device=None, dtype=torch.float32):
        super().__init__()
        if layout != "NCHW":
            raise MXNetError(f"layout {layout!r} not supported: channel-first "
                             "only, as the reference")
        if in_channels <= 0 or in_channels % groups:
            raise MXNetError(f"in_channels {in_channels} must be positive "
                             f"and divisible by groups {groups}")
        self._kernel = _pair(kernel_size)
        self._strides = _pair(strides)
        self._padding = _pair(padding)
        self._dilation = _pair(dilation)
        self._groups = groups
        self.weight = _param(channels, in_channels // groups, *self._kernel,
                             device=device, dtype=dtype)
        self.bias = _param(channels, device=device, dtype=dtype) \
            if use_bias else None

    def forward(self, x):
        return _ops.convolution(x, self.weight, self.bias, self._strides,
                                self._padding, self._dilation, self._groups)

    def extra_repr(self):
        o, i = self.weight.shape[:2]
        return (f"{i * self._groups} -> {o}, kernel_size={self._kernel}, "
                f"stride={self._strides}, padding={self._padding}")


class _Pooling(TensorBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, count_include_pad=True, layout="NCHW"):
        super().__init__()
        if layout != "NCHW":
            raise MXNetError(f"layout {layout!r} not supported: channel-first "
                             "only, as the reference")
        self._pool_size = pool_size
        self._strides = strides if strides is not None else pool_size
        self._padding = padding
        self._ceil = ceil_mode
        self._global = global_pool
        self._type = pool_type
        self._count_include_pad = count_include_pad

    def forward(self, x):
        return _ops.pooling(
            x, self._pool_size, self._type, self._global, self._strides,
            self._padding, "full" if self._ceil else "valid",
            self._count_include_pad)

    def extra_repr(self):
        if self._global:
            return ""
        return (f"size={self._pool_size}, stride={self._strides}, "
                f"padding={self._padding}, ceil_mode={self._ceil}")


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 ceil_mode=False, layout="NCHW"):
        super().__init__(_pair(pool_size),
                         _pair(strides) if strides is not None else None,
                         _pair(padding), ceil_mode, False, "max",
                         layout=layout)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 ceil_mode=False, count_include_pad=True, layout="NCHW"):
        super().__init__(_pair(pool_size),
                         _pair(strides) if strides is not None else None,
                         _pair(padding), ceil_mode, False, "avg",
                         count_include_pad, layout)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW"):
        super().__init__((1, 1), None, (0, 0), False, True, "avg",
                         layout=layout)
