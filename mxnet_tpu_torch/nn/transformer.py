"""Transformer building blocks.

Counterparts of mxnet_tpu/gluon/nn/transformer.py `MultiHeadAttention`,
`PositionwiseFFN`, `TransformerEncoderLayer` and `TransformerEncoder`,
with its attribute names (attn.query/key/value/proj, ffn.fc1/fc2,
ln1/ln2, layer{i}) so that models/convert.load_jax_params copies by
name. The attention core is ops.nn.dot_product_attention with
layout="BTHD": the head split is a free reshape and the fused kernel
reads the (B, T, H, D) view through its strides. Dropout (and attention
dropout) is active only in train() mode.
"""
from __future__ import annotations

from torch import nn

from ..base import MXNetError
from ..ops import nn as _ops
from .layers import Dense, Dropout, LayerNorm

__all__ = ["MultiHeadAttention", "PositionwiseFFN",
           "TransformerEncoderLayer", "TransformerEncoder"]


class MultiHeadAttention(nn.Module):
    """Multi-head attention over (B, T, C) inputs. attention_impl as in
    ops.nn.dot_product_attention ('auto' | 'fused' | 'torch' | 'xla')."""

    def __init__(self, units, num_heads, dropout=0.0, use_bias=True,
                 attention_impl="auto", causal=False, device=None,
                 dtype=None):
        super().__init__()
        if units % num_heads:
            raise MXNetError(f"units {units} not divisible by heads "
                             f"{num_heads}")
        self._units, self._num_heads = units, num_heads
        self._dropout = dropout
        self._causal = causal
        self._impl = attention_impl
        kw = dict(use_bias=use_bias, device=device, dtype=dtype)
        self.query = Dense(units, units, **kw)
        self.key = Dense(units, units, **kw)
        self.value = Dense(units, units, **kw)
        self.proj = Dense(units, units, **kw)

    def _split(self, x):
        b, t, _ = x.shape
        h = self._num_heads
        return x.view(b, t, h, self._units // h)

    def forward(self, x, mask=None, kv=None):
        kv = x if kv is None else kv
        q = self._split(self.query(x))
        k = self._split(self.key(kv))
        v = self._split(self.value(kv))
        out = _ops.dot_product_attention(
            q, k, v, mask, causal=self._causal,
            dropout_p=self._dropout if self.training else 0.0,
            impl=self._impl, layout="BTHD")
        b, t, h, d = out.shape
        return self.proj(out.reshape(b, t, h * d))


class PositionwiseFFN(nn.Module):
    """fc1 -> activation -> dropout -> fc2."""

    def __init__(self, units, hidden_size, activation="gelu", dropout=0.0,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.fc1 = Dense(units, hidden_size, **kw)
        self.fc2 = Dense(hidden_size, units, **kw)
        self._activation = activation
        self.dropout = Dropout(dropout) if dropout else None

    def forward(self, x):
        h = _ops.activation(self.fc1(x), self._activation)
        if self.dropout is not None:
            h = self.dropout(h)
        return self.fc2(h)


class TransformerEncoderLayer(nn.Module):
    """Post-LN (BERT-style) or pre-LN encoder layer."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 attention_dropout=0.0, activation="gelu", pre_norm=False,
                 layer_norm_eps=1e-12, attention_impl="auto", device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self._pre_norm = pre_norm
        self.attn = MultiHeadAttention(units, num_heads,
                                       dropout=attention_dropout,
                                       attention_impl=attention_impl, **kw)
        self.ffn = PositionwiseFFN(units, hidden_size, activation, dropout,
                                   **kw)
        self.ln1 = LayerNorm(units, layer_norm_eps, **kw)
        self.ln2 = LayerNorm(units, layer_norm_eps, **kw)
        self.dropout = Dropout(dropout) if dropout else None

    def _drop(self, h):
        return self.dropout(h) if self.dropout is not None else h

    def forward(self, x, mask=None):
        if self._pre_norm:
            x = x + self._drop(self.attn(self.ln1(x), mask))
            return x + self._drop(self.ffn(self.ln2(x)))
        x = self.ln1(x + self._drop(self.attn(x, mask)))
        return self.ln2(x + self._drop(self.ffn(x)))


class TransformerEncoder(nn.Module):
    """A stack of encoder layers named layer0, layer1, ..."""

    def __init__(self, num_layers, units, hidden_size, num_heads,
                 dropout=0.0, attention_dropout=0.0, activation="gelu",
                 pre_norm=False, layer_norm_eps=1e-12,
                 attention_impl="auto", device=None, dtype=None):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer{i}", TransformerEncoderLayer(
                units, hidden_size, num_heads, dropout, attention_dropout,
                activation, pre_norm, layer_norm_eps, attention_impl,
                device=device, dtype=dtype))

    def forward(self, x, mask=None):
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i}")(x, mask)
        return x
