"""Transformer blocks with the reference's constructors (counterpart of
mxnet_tpu/gluon/nn/transformer.py): the port's blocks, their parameters
on the meta device until `initialize()`."""
from __future__ import annotations

from ... import nn as _pnn
from ._common import META, gluon_mode

__all__ = ["MultiHeadAttention", "PositionwiseFFN",
           "TransformerEncoderLayer", "TransformerEncoder"]


def _gluon(cls):
    def init(self, *args, **kwargs):
        kwargs.setdefault("device", META)
        cls.__init__(self, *args, **kwargs)
        gluon_mode(self)
    return type(cls.__name__, (cls,), {"__init__": init,
                                       "__doc__": cls.__doc__})


MultiHeadAttention = _gluon(_pnn.MultiHeadAttention)
PositionwiseFFN = _gluon(_pnn.PositionwiseFFN)
TransformerEncoderLayer = _gluon(_pnn.TransformerEncoderLayer)
TransformerEncoder = _gluon(_pnn.TransformerEncoder)
