"""Activation layers (counterpart of mxnet_tpu/gluon/nn/activations.py):
Activation (every act_type of the reference), LeakyReLU, PReLU, ELU,
SELU, Swish / SiLU and GELU, over the registered ops."""
from __future__ import annotations

from ...nn.layers import TensorBlock
from ...ops import nn as _nnops
from ..parameter import Parameter

__all__ = ["Activation", "LeakyReLU", "PReLU", "ELU", "SELU", "Swish",
           "SiLU", "GELU"]


class Activation(TensorBlock):
    def __init__(self, activation, **kwargs):
        super().__init__()
        self._act_type = activation

    def forward(self, x):
        return _nnops.Activation(x, act_type=self._act_type)

    def extra_repr(self):
        return self._act_type


class LeakyReLU(TensorBlock):
    def __init__(self, alpha=0.01, **kwargs):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return _nnops.LeakyReLU(x, act_type="leaky", slope=self._alpha)


class PReLU(TensorBlock):
    def __init__(self, alpha_initializer="zeros", in_channels=1, **kwargs):
        super().__init__()
        self.alpha = Parameter("alpha", shape=(in_channels,),
                               init=alpha_initializer)

    def forward(self, x):
        return _nnops.LeakyReLU(x, self._parameters["alpha"],
                                act_type="prelu")


class ELU(TensorBlock):
    def __init__(self, alpha=1.0, **kwargs):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return _nnops.LeakyReLU(x, act_type="elu", slope=self._alpha)


class SELU(TensorBlock):
    def forward(self, x):
        return _nnops.LeakyReLU(x, act_type="selu")


class Swish(TensorBlock):
    def __init__(self, beta=1.0, **kwargs):
        super().__init__()
        self._beta = beta

    def forward(self, x):
        if self._beta == 1.0:
            return _nnops.silu(x)
        return x * _nnops.Activation(x * self._beta, act_type="sigmoid")


SiLU = Swish


class GELU(TensorBlock):
    def __init__(self, approximation="none", **kwargs):
        super().__init__()
        self._approx = approximation in ("tanh", True)

    def forward(self, x):
        return _nnops.gelu(x, approximate=self._approx)
