"""Layers (counterpart of mxnet_tpu.gluon.nn: the basic layers and the
transformer blocks)."""
from .layers import Dense, Dropout, Embedding, LayerNorm
from .transformer import (MultiHeadAttention, PositionwiseFFN,
                          TransformerEncoder, TransformerEncoderLayer)

__all__ = ["Dense", "Dropout", "Embedding", "LayerNorm", "MultiHeadAttention",
           "PositionwiseFFN", "TransformerEncoder", "TransformerEncoderLayer"]
