"""Layers (counterpart of mxnet_tpu.gluon.nn: the basic layers, the 2-D
convolution and pooling layers, and the transformer blocks), as gluon
HybridBlocks over tensors in the port's argument order. gluon.nn has the
same layers with the reference's constructors."""
from . import layers  # noqa: F401
from .conv_layers import AvgPool2D, Conv2D, GlobalAvgPool2D, MaxPool2D
from .layers import (Activation, BatchNorm, Dense, Dropout, Embedding,
                     Flatten, HybridSequential, LayerNorm, Sequential,
                     TensorBlock)
from .transformer import (MultiHeadAttention, PositionwiseFFN,
                          TransformerEncoder, TransformerEncoderLayer)

__all__ = ["Activation", "AvgPool2D", "BatchNorm", "Conv2D", "Dense",
           "Dropout", "Embedding", "Flatten", "GlobalAvgPool2D",
           "HybridSequential", "LayerNorm", "MaxPool2D",
           "MultiHeadAttention", "PositionwiseFFN", "Sequential",
           "TensorBlock", "TransformerEncoder", "TransformerEncoderLayer"]
