"""Convolution and pooling layers with the reference's constructors
(counterpart of mxnet_tpu/gluon/nn/conv_layers.py). Conv2D defers its
input channels (in_channels=0) as the reference's does and applies its
fused `activation`; the 2-D pools are the port's. The 1-D and 3-D
forms, the transposed convolutions, the global max pools, the 1-D / 3-D
pools and ReflectionPad2D are not ported yet: constructing one raises.
"""
from __future__ import annotations

from ... import nn as _pnn
from ...base import not_ported
from ...nn.layers import _param
from ...ops import nn as _nnops
from ._common import META, configure, dtype_of, fill_shape

__all__ = ["Conv2D", "MaxPool2D", "AvgPool2D", "GlobalAvgPool2D",
           "Conv1D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
           "Conv3DTranspose", "MaxPool1D", "MaxPool3D", "AvgPool1D",
           "AvgPool3D", "GlobalMaxPool1D", "GlobalMaxPool2D",
           "GlobalMaxPool3D", "GlobalAvgPool1D", "GlobalAvgPool3D",
           "ReflectionPad2D"]

MaxPool2D = _pnn.MaxPool2D
AvgPool2D = _pnn.AvgPool2D
GlobalAvgPool2D = _pnn.GlobalAvgPool2D


class Conv2D(_pnn.Conv2D):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, dtype="float32",
                 **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels=in_channels or groups,
                         use_bias=use_bias, device=META,
                         dtype=dtype_of(dtype))
        if not in_channels:
            self.weight = _param(channels, 0, *self._kernel, device=META,
                                 dtype=dtype_of(dtype))
        self._channels = channels
        self._act = activation
        configure(self, weight=weight_initializer, bias=bias_initializer)

    def infer_shape(self, x, *args):
        fill_shape(self, "weight", (self._channels,
                                    x.shape[1] // self._groups)
                   + self._kernel)

    def forward(self, x):
        y = super().forward(x)
        return y if self._act is None else _nnops.Activation(y, self._act)


def _later(name):
    def init(self, *args, **kwargs):
        raise not_ported(f"gluon.nn.{name}")
    return type(name, (_pnn.layers.TensorBlock,), {"__init__": init})


for _name in __all__[4:]:
    globals()[_name] = _later(_name)
del _name
