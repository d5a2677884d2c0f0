"""BERT for masked-language-model pretraining.

Counterpart of mxnet_tpu/models/bert.py `BertConfig`, `bert_base_config`,
`bert_large_config`, `BertModel`, `_MLMHead` and `BertForMaskedLM`.
Module and parameter names follow the reference
(`backbone.encoder.layer0.attn.query.weight`, `mlm.decoder_bias`, ...),
so models/convert.py carries JAX weights across by name. The MLM decoder
is tied to `backbone.word_embed.weight`: the head keeps the embedding
outside its registered submodules, so the weight is one parameter,
counted once.

Models start in eval() mode, where dropout is off (the reference applies
it only under autograd training); parallel.TrainStep runs its forward in
train() mode.

Not ported yet: `BertForPretraining` (the next-sentence head).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..base import MXNetError, not_ported, resolve_device
from ..nn import Dense, Dropout, Embedding, LayerNorm, TransformerEncoder
from ..ops import nn as _ops
from .convert import init_params
from .gpt2 import _DTYPES

__all__ = ["BertConfig", "BertModel", "BertForMaskedLM", "bert_base_config",
           "bert_large_config"]


class BertConfig:
    def __init__(self, vocab_size=30522, units=768, hidden_size=3072,
                 num_layers=12, num_heads=12, max_length=512,
                 type_vocab_size=2, dropout=0.1, attention_dropout=0.1,
                 layer_norm_eps=1e-12, activation="gelu_tanh",
                 attention_impl="auto", dtype="float32"):
        self.vocab_size = vocab_size
        self.units = units
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.max_length = max_length
        self.type_vocab_size = type_vocab_size
        self.dropout = dropout
        self.attention_dropout = attention_dropout
        self.layer_norm_eps = layer_norm_eps
        self.activation = activation
        self.attention_impl = attention_impl
        self.dtype = dtype

    def num_params(self):
        """Analytic parameter count (the MFU formula's N)."""
        c = self
        embed = (c.vocab_size + c.max_length + c.type_vocab_size) * c.units \
            + 2 * c.units
        per_layer = (4 * (c.units * c.units + c.units)          # qkv + proj
                     + 2 * c.units * c.hidden_size               # fc1+fc2 w
                     + c.hidden_size + c.units                   # fc biases
                     + 4 * c.units)                              # 2 LN
        pooler = c.units * c.units + c.units
        return embed + c.num_layers * per_layer + pooler


def bert_base_config(**kw):
    return BertConfig(**kw)


def bert_large_config(**kw):
    kw.setdefault("units", 1024)
    kw.setdefault("hidden_size", 4096)
    kw.setdefault("num_layers", 24)
    kw.setdefault("num_heads", 16)
    return BertConfig(**kw)


class BertModel(nn.Module):
    """Embeddings + transformer encoder. The pooler (the reference's
    use_pooler=True, which only BertForPretraining needs) is not ported
    yet."""

    def __init__(self, config, use_pooler=False, device=None, dtype=None):
        super().__init__()
        if use_pooler:
            raise not_ported("the BERT pooler (BertForPretraining)")
        c = self.config = config
        kw = dict(device=device, dtype=dtype)
        self.word_embed = Embedding(c.vocab_size, c.units, **kw)
        self.token_type_embed = Embedding(c.type_vocab_size, c.units, **kw)
        self.position_embed = Embedding(c.max_length, c.units, **kw)
        self.embed_ln = LayerNorm(c.units, c.layer_norm_eps, **kw)
        self.embed_dropout = Dropout(c.dropout) if c.dropout else None
        self.encoder = TransformerEncoder(
            c.num_layers, c.units, c.hidden_size, c.num_heads,
            dropout=c.dropout, attention_dropout=c.attention_dropout,
            activation=c.activation, layer_norm_eps=c.layer_norm_eps,
            attention_impl=c.attention_impl, **kw)

    def forward(self, inputs, token_types=None, valid_length=None):
        t = inputs.shape[1]
        positions = torch.arange(t, device=inputs.device)
        x = self.word_embed(inputs) + self.position_embed(positions)
        if token_types is not None:
            x = x + self.token_type_embed(token_types)
        x = self.embed_ln(x)
        if self.embed_dropout is not None:
            x = self.embed_dropout(x)
        mask = None
        if valid_length is not None:
            mask = positions[None, :] < valid_length.reshape(-1, 1)
        return self.encoder(x, mask)


class _MLMHead(nn.Module):
    """Transform + decoder (weight-tied to the word embedding) + bias."""

    def __init__(self, config, word_embed, device=None, dtype=None):
        super().__init__()
        c = config
        kw = dict(device=device, dtype=dtype)
        self.transform = Dense(c.units, c.units, **kw)
        self._act = c.activation
        self.transform_ln = LayerNorm(c.units, c.layer_norm_eps, **kw)
        # tied weight: kept out of _modules, so the embedding is neither
        # registered nor updated a second time through this path
        object.__setattr__(self, "_word_embed", word_embed)
        self.decoder_bias = nn.Parameter(
            torch.zeros(c.vocab_size, device=device, dtype=dtype))

    def forward(self, hidden, masked_positions=None):
        if masked_positions is not None:
            # only the masked slots: (B, M, C)
            idx = masked_positions.reshape(masked_positions.shape[0], -1)
            hidden = torch.gather(hidden, 1, idx.long()[:, :, None].expand(
                -1, -1, hidden.shape[-1]))
        h = self.transform(hidden)
        if self._act == "gelu_tanh":
            h = _ops.gelu(h, approximate=True)
        else:
            h = _ops.activation(h, self._act)
        h = self.transform_ln(h)
        return F.linear(h, self._word_embed.weight, self.decoder_bias)


class BertForMaskedLM(nn.Module):
    """BERT with the MLM head.

    The parameters live on `device` (default: the CUDA card; raises
    without one) in `config.dtype`, and start as seeded random weights
    (models/convert.py init_params, seed 0); load_jax_params replaces
    them with a JAX model's."""

    def __init__(self, config, device=None):
        super().__init__()
        if config.dtype not in _DTYPES:
            raise MXNetError(f"dtype {config.dtype!r} unsupported "
                             f"({', '.join(_DTYPES)})")
        self.config = config
        kw = dict(device=resolve_device(device), dtype=_DTYPES[config.dtype])
        self.backbone = BertModel(config, **kw)
        self.mlm = _MLMHead(config, self.backbone.word_embed, **kw)
        init_params(self)
        self.eval()

    @property
    def device(self):
        return self.backbone.word_embed.weight.device

    def forward(self, inputs, token_types=None, valid_length=None,
                masked_positions=None):
        """inputs/token_types (B, T) int, valid_length (B,) int,
        masked_positions (B, M) int. Returns MLM logits (B, M, V), or
        (B, T, V) without masked_positions."""
        seq = self.backbone(inputs, token_types, valid_length)
        return self.mlm(seq, masked_positions)
