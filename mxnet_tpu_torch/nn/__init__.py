"""Layers (counterpart of mxnet_tpu.gluon.nn, serving-path subset)."""
from .layers import Dense, Embedding, LayerNorm

__all__ = ["Dense", "Embedding", "LayerNorm"]
