"""GPT-2 for training and for serving over a ragged paged KV cache.

Counterpart of mxnet_tpu/models/gpt2.py. Module and parameter names
follow the reference (`backbone.layer3.attn.query.weight`,
`backbone.ln_f.gamma`, ...), so models/convert.py can carry JAX weights
across by name. The LM head is tied to `backbone.word_embed.weight`.

Ported:
  * the `cache=None` training forward: positions 0..t-1, the embedding
    and block dropouts, and per layer one causal attention over the
    (B, T, H, D) head split through ops.nn.dot_product_attention at the
    config's attention_impl (the fused attention kernels). Dropout is
    active only in train() mode; the model starts in eval() mode, as the
    reference applies dropout only under autograd training.
  * the ragged-cache forward the serving engine runs — every slot
    writes its rows at its own length (`PagedKVCache.write_decode`) and
    attends over its own pages through the ragged attention kernels: one
    query row per slot goes to `ragged_decode_attention`, anything else
    to `ragged_span_attention` with the cache's per-slot `spans` as
    q_counts. A quantized (int8) cache sends every call, one row
    included, to `ragged_span_attention` with the layer's scales, and q
    keeps its dtype.

Not ported yet: the lockstep KVCache path, `generate()`, LoRA adapters
and the tensor-parallel split.
"""
from __future__ import annotations

import torch
from torch import nn

from ..base import MXNetError, not_ported, resolve_device
from ..nn import Dense, Dropout, Embedding, LayerNorm
from ..ops import nn as _ops
from ..ops.ragged_attention import (ragged_decode_attention,
                                    ragged_span_attention)
from .convert import init_params
from .kv_cache import PagedKVCache

__all__ = ["GPT2Config", "GPT2Model", "GPT2ForCausalLM", "gpt2_small_config",
           "gpt2_medium_config", "gpt2_774m_config", "gpt2_xl_config"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class GPT2Config:
    def __init__(self, vocab_size=50257, units=768, num_layers=12,
                 num_heads=12, max_length=1024, dropout=0.1,
                 attention_dropout=0.1, layer_norm_eps=1e-5,
                 activation="gelu_tanh", attention_impl="auto",
                 dtype="float32"):
        self.vocab_size = vocab_size
        self.units = units
        self.hidden_size = 4 * units
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.max_length = max_length
        self.dropout = dropout
        self.attention_dropout = attention_dropout
        self.layer_norm_eps = layer_norm_eps
        self.activation = activation
        self.attention_impl = attention_impl
        self.dtype = dtype

    def num_params(self):
        c = self
        embed = (c.vocab_size + c.max_length) * c.units
        per_layer = (4 * (c.units * c.units + c.units)
                     + 2 * c.units * c.hidden_size
                     + c.hidden_size + c.units
                     + 4 * c.units)
        return embed + c.num_layers * per_layer + 2 * c.units  # final LN


def gpt2_small_config(**kw):           # 124M
    return GPT2Config(**kw)


def gpt2_medium_config(**kw):          # 355M
    kw.setdefault("units", 1024)
    kw.setdefault("num_layers", 24)
    kw.setdefault("num_heads", 16)
    return GPT2Config(**kw)


def gpt2_774m_config(**kw):            # the BASELINE.json target workload
    kw.setdefault("units", 1280)
    kw.setdefault("num_layers", 36)
    kw.setdefault("num_heads", 20)
    return GPT2Config(**kw)


def gpt2_xl_config(**kw):              # 1.5B
    kw.setdefault("units", 1600)
    kw.setdefault("num_layers", 48)
    kw.setdefault("num_heads", 25)
    return GPT2Config(**kw)


class GPT2Attention(nn.Module):
    """Causal self-attention: over the chunk itself (no cache, training)
    or over a ragged paged KV cache."""

    def __init__(self, units, num_heads, device, dtype, dropout=0.0,
                 attention_impl="auto"):
        super().__init__()
        if units % num_heads:
            raise MXNetError(f"units {units} % heads {num_heads} != 0")
        self._units, self._num_heads = units, num_heads
        self._dropout, self._impl = dropout, attention_impl
        kw = dict(device=device, dtype=dtype)
        self.query = Dense(units, units, **kw)
        self.key = Dense(units, units, **kw)
        self.value = Dense(units, units, **kw)
        self.proj = Dense(units, units, **kw)

    def forward(self, x, cache, layer_idx):
        b, t, _ = x.shape
        h, d = self._num_heads, self._units // self._num_heads
        q = self.query(x).view(b, t, h, d)
        k = self.key(x).view(b, t, h, d)
        v = self.value(x).view(b, t, h, d)
        if cache is None:
            # training: the head split stays (B, T, H, D), which the fused
            # kernel reads through its strides
            out = _ops.dot_product_attention(
                q, k, v, causal=True,
                dropout_p=self._dropout if self.training else 0.0,
                impl=self._impl, layout="BTHD")
            return self.proj(out.reshape(b, t, h * d)), None
        # the cache takes the reference's (B, H, t, D) layout
        cache = cache.write_decode(layer_idx, k.transpose(1, 2),
                                   v.transpose(1, 2))
        kp, vp = cache.k_pages[layer_idx], cache.v_pages[layer_idx]
        # query 0's own (just written) position counts toward the length;
        # over float pools q is cast to the pool dtype and the output
        # back. int8 pools keep q in its own dtype (a cast would destroy
        # it) and pass the layer's scales; t == 1 takes the span kernel
        # too, as in the reference (there is no int8 decode kernel)
        lengths = cache.length + 1
        quant = cache.quantized
        if t == 1 and not quant:
            out = ragged_decode_attention(
                q[:, 0].to(kp.dtype), kp, vp, cache.page_table, lengths,
                impl=cache.attn_impl)
        else:
            out = ragged_span_attention(
                q if quant else q.to(kp.dtype), kp, vp, cache.page_table,
                lengths, q_counts=cache.spans, impl=cache.attn_impl,
                k_scale=cache.k_scale[layer_idx] if quant else None,
                v_scale=cache.v_scale[layer_idx] if quant else None)
        out = out.to(q.dtype).reshape(b, t, h * d)
        return self.proj(out), cache


class GPT2Block(nn.Module):
    """Pre-LN transformer block (GPT-2 style)."""

    def __init__(self, cfg, device, dtype):
        super().__init__()
        c, kw = cfg, dict(device=device, dtype=dtype)
        self.ln1 = LayerNorm(c.units, c.layer_norm_eps, **kw)
        self.attn = GPT2Attention(c.units, c.num_heads,
                                  dropout=c.attention_dropout,
                                  attention_impl=c.attention_impl, **kw)
        self.ln2 = LayerNorm(c.units, c.layer_norm_eps, **kw)
        self.fc1 = Dense(c.units, c.hidden_size, **kw)
        self.fc2 = Dense(c.hidden_size, c.units, **kw)
        self._activation = c.activation
        self.dropout = Dropout(c.dropout) if c.dropout else None

    def _drop(self, h):
        return self.dropout(h) if self.dropout is not None else h

    def forward(self, x, cache, layer_idx):
        h, cache = self.attn(self.ln1(x), cache, layer_idx)
        x = x + self._drop(h)
        h = _ops.activation(self.fc1(self.ln2(x)), self._activation)
        return x + self._drop(self.fc2(h)), cache


class GPT2Model(nn.Module):
    """Embeddings + pre-LN blocks + final LN."""

    def __init__(self, config, device, dtype):
        super().__init__()
        c = self.config = config
        kw = dict(device=device, dtype=dtype)
        self.word_embed = Embedding(c.vocab_size, c.units, **kw)
        self.position_embed = Embedding(c.max_length, c.units, **kw)
        self.embed_dropout = Dropout(c.dropout) if c.dropout else None
        for i in range(c.num_layers):
            self.add_module(f"layer{i}", GPT2Block(c, **kw))
        self.ln_f = LayerNorm(c.units, c.layer_norm_eps, **kw)

    def blocks(self):
        return [getattr(self, f"layer{i}")
                for i in range(self.config.num_layers)]

    def forward(self, inputs, cache=None):
        """(hidden states (B, t, C), cache advanced by t or None)."""
        if cache is not None and not cache.ragged:
            raise not_ported("the GPT-2 forward over a lockstep cache")
        t = inputs.shape[1]
        positions = torch.arange(t, device=inputs.device)
        if cache is not None:
            # per-slot positions: slot b's row j sits at length[b] + j.
            # Dead rows of a slot near capacity (and parked free slots)
            # run past the position table; jnp.take fills those with NaN,
            # a torch index would fault, so they are clamped. Their values
            # never reach a live row: dead rows write no KV and attend
            # nothing.
            positions = (cache.length[:, None].long() + positions).clamp(
                max=self.config.max_length - 1)
        x = self.word_embed(inputs) + self.position_embed(positions)
        if self.embed_dropout is not None:
            x = self.embed_dropout(x)
        for i, block in enumerate(self.blocks()):
            x, cache = block(x, cache, i)
        return self.ln_f(x), None if cache is None else cache.advance(t)


class GPT2ForCausalLM(nn.Module):
    """GPT-2 with the weight-tied LM head.

    The parameters live on `device` (default: the CUDA card; raises
    without one) in `config.dtype`, and start as seeded random weights
    (models/convert.py init_params, seed 0); load_jax_params replaces
    them with a JAX model's. The model starts in eval() mode (no
    dropout)."""

    def __init__(self, config, device=None):
        super().__init__()
        if config.dtype not in _DTYPES:
            raise MXNetError(f"dtype {config.dtype!r} unsupported "
                             f"({', '.join(_DTYPES)})")
        self.config = config
        self.backbone = GPT2Model(config, resolve_device(device),
                                  _DTYPES[config.dtype])
        init_params(self)
        self.eval()

    @property
    def device(self):
        return self.backbone.word_embed.weight.device

    @property
    def dtype(self):
        return self.backbone.word_embed.weight.dtype

    def forward(self, inputs, cache=None):
        """inputs (B, t) int token ids; cache None (training: positions
        0..t-1, causal attention over the chunk) or a ragged
        PagedKVCache. Returns the logits (B, t, V) alone without a cache,
        as the reference does, else (logits, cache advanced by t)."""
        h, cache = self.backbone(inputs, cache)
        logits = _ops.fully_connected(h, self.backbone.word_embed.weight)
        return logits if cache is None else (logits, cache)

    def make_cache(self, batch, max_length, paged=True, page_size=64,
                   dtype=None, page_table=None, lengths=None,
                   attn_impl="auto", kv_dtype=None):
        if not paged:
            raise not_ported("the contiguous KVCache")
        c = self.config
        return PagedKVCache.create(
            c.num_layers, batch, c.num_heads, max_length,
            c.units // c.num_heads, dtype=dtype or self.dtype,
            page_size=page_size, page_table=page_table, lengths=lengths,
            attn_impl=attn_impl, kv_dtype=kv_dtype, device=self.device)

    def generate(self, *args, **kwargs):
        raise not_ported("GPT2ForCausalLM.generate (lockstep decode)")
