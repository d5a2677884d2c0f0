"""Transformer NMT (Sockeye-3 style) with beam-search decoding.

Counterpart of mxnet_tpu/models/nmt.py `NMTConfig`, `nmt_base_config`
and `TransformerNMT`: a pre-LN encoder-decoder transformer trained with
teacher forcing (the output layer tied to `tgt_embed`) and decoded with
length-penalised beam search over the contiguous lockstep KVCache
(models/kv_cache.py). Module and parameter names follow the reference
(`src_embed`, `tgt_embed`, `enc{i}` / `dec{i}` with `ln1`–`ln3`, `attn`,
`self_attn`, `cross_attn`, `ffn.fc1`, `ffn.fc2`; `enc_ln`, `dec_ln`), so
models/convert.load_jax_params copies JAX weights by name.

Every attention goes through ops.nn.dot_product_attention at its
MultiHeadAttention's impl ("auto": the fused kernels on the card): the
encoder, the decoder's causal self-attention and the cross-attention in
the (B, T, H, D) layout with key padding from `src_valid_length`, the
decoder's cached self-attention in (B, H, T, D) over the cache's whole
buffer under its key mask, one query row a step.

Where the reference runs the beam loop as one lax.fori_loop program,
here a Python loop runs the same body `max_length` times; it keeps the
reference's float32 arithmetic (log_softmax, the eos-only row of
finished beams, NEG = -1e9) and its tie order (lax.top_k and argsort
put the lower index first: a stable descending sort here). The
cross-attention recomputes key(memory) and value(memory) every step, as
the reference does.
"""
from __future__ import annotations

import torch

from ..base import MXNetError, resolve_device
from ..nn.layers import TensorBlock
from ..nn import Dropout, Embedding, LayerNorm
from ..nn.layers import _in_dtype
from ..nn.transformer import MultiHeadAttention, PositionwiseFFN
from ..ops import nn as _ops
from .convert import init_params
from .gpt2 import _DTYPES
from .kv_cache import KVCache

__all__ = ["NMTConfig", "TransformerNMT", "nmt_base_config"]

NEG = -1e9


class NMTConfig:
    def __init__(self, src_vocab_size=32000, tgt_vocab_size=32000,
                 units=512, hidden_size=2048, enc_layers=6, dec_layers=6,
                 num_heads=8, max_length=256, dropout=0.1,
                 attention_dropout=0.0, layer_norm_eps=1e-5,
                 activation="relu", bos_id=2, eos_id=3, pad_id=0,
                 dtype="float32"):
        self.src_vocab_size = src_vocab_size
        self.tgt_vocab_size = tgt_vocab_size
        self.units = units
        self.hidden_size = hidden_size
        self.enc_layers = enc_layers
        self.dec_layers = dec_layers
        self.num_heads = num_heads
        self.max_length = max_length
        self.dropout = dropout
        self.attention_dropout = attention_dropout
        self.layer_norm_eps = layer_norm_eps
        self.activation = activation
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.dtype = dtype


def nmt_base_config(**kw):
    """Transformer-base (Sockeye 3's default): vocab 32000 / 32000, 512
    units, 2048 hidden, 6 + 6 layers, 8 heads, 256 positions, dropout
    0.1."""
    return NMTConfig(**kw)


def _sinusoid_positions(T, C, dtype, device):
    """(T, C) sin | cos position table, computed in float32 and cast."""
    pos = torch.arange(T, device=device, dtype=torch.float32)[:, None]
    dim = torch.arange(C // 2, device=device, dtype=torch.float32)[None, :]
    ang = pos / torch.pow(torch.tensor(10000.0, device=device), 2 * dim / C)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _drop(dropout, h):
    return dropout(h) if dropout is not None else h


class _EncoderLayer(TensorBlock):
    """Pre-LN encoder layer."""

    def __init__(self, c, **kw):
        super().__init__()
        self.ln1 = LayerNorm(c.units, c.layer_norm_eps, **kw)
        self.attn = MultiHeadAttention(c.units, c.num_heads,
                                       dropout=c.attention_dropout, **kw)
        self.ln2 = LayerNorm(c.units, c.layer_norm_eps, **kw)
        self.ffn = PositionwiseFFN(c.units, c.hidden_size, c.activation,
                                   c.dropout, **kw)
        self.dropout = Dropout(c.dropout) if c.dropout else None

    def forward(self, x, mask=None):
        x = x + _drop(self.dropout, self.attn(self.ln1(x), mask))
        return x + _drop(self.dropout, self.ffn(self.ln2(x)))


class _DecoderLayer(TensorBlock):
    """Pre-LN decoder layer: causal self-attention (over the chunk, or
    over a lockstep cache), cross-attention over the encoder memory, FFN."""

    def __init__(self, c, **kw):
        super().__init__()
        e = c.layer_norm_eps
        self.ln1 = LayerNorm(c.units, e, **kw)
        self.self_attn = MultiHeadAttention(
            c.units, c.num_heads, dropout=c.attention_dropout, causal=True,
            **kw)
        self.ln2 = LayerNorm(c.units, e, **kw)
        self.cross_attn = MultiHeadAttention(
            c.units, c.num_heads, dropout=c.attention_dropout, **kw)
        self.ln3 = LayerNorm(c.units, e, **kw)
        self.ffn = PositionwiseFFN(c.units, c.hidden_size, c.activation,
                                   c.dropout, **kw)
        self.dropout = Dropout(c.dropout) if c.dropout else None

    def forward(self, x, memory, src_mask=None, cache=None, layer_idx=None):
        """cache None: the teacher-forcing pass (causal self-attention).
        cache given: one decode step, x (B, 1, C); the self-attention's
        q/k/v come from the same Dense layers and attend over the cache's
        whole (B, H, T_max, D) buffer under its key mask."""
        h = self.ln1(x)
        if cache is None:
            sa = self.self_attn(h)
        else:
            a = self.self_attn
            q = a._split(a.query(h))
            k = a._split(a.key(h))
            v = a._split(a.value(h))
            k_all, v_all, cache = cache.write(layer_idx, k, v)
            mask = cache.key_mask(extra=1)[None, None, None, :]
            out = _ops.dot_product_attention(
                q, k_all.to(q.dtype), v_all.to(q.dtype), mask,
                impl=a._impl)
            b, hh, t, d = out.shape
            sa = a.proj(out.transpose(1, 2).reshape(b, t, hh * d))
        x = x + _drop(self.dropout, sa)
        ca = self.cross_attn(self.ln2(x), mask=src_mask, kv=memory)
        x = x + _drop(self.dropout, ca)
        x = x + _drop(self.dropout, self.ffn(self.ln3(x)))
        return x, cache


class TransformerNMT(TensorBlock):
    """Encoder-decoder transformer with the target embedding tied to the
    output layer. The parameters live on `device` (default: the CUDA
    card; raises without one) in `config.dtype` and start as seeded
    random weights (models/convert.py init_params, seed 0);
    load_jax_params replaces them with a JAX model's. The model starts
    in eval() mode (no dropout)."""

    def __init__(self, config, device=None):
        super().__init__()
        if config.dtype not in _DTYPES:
            raise MXNetError(f"dtype {config.dtype!r} unsupported "
                             f"({', '.join(_DTYPES)})")
        c = self.config = config
        kw = dict(device=resolve_device(device), dtype=_DTYPES[c.dtype])
        self.src_embed = Embedding(c.src_vocab_size, c.units, **kw)
        self.tgt_embed = Embedding(c.tgt_vocab_size, c.units, **kw)
        self.enc_dropout = Dropout(c.dropout) if c.dropout else None
        for i in range(c.enc_layers):
            self.add_module(f"enc{i}", _EncoderLayer(c, **kw))
        self.enc_ln = LayerNorm(c.units, c.layer_norm_eps, **kw)
        for i in range(c.dec_layers):
            self.add_module(f"dec{i}", _DecoderLayer(c, **kw))
        self.dec_ln = LayerNorm(c.units, c.layer_norm_eps, **kw)
        self._positions = {}
        init_params(self)
        self.eval()

    @property
    def device(self):
        return self.tgt_embed.weight.device

    @property
    def dtype(self):
        return self.tgt_embed.weight.dtype

    def _enc_layers(self):
        return [getattr(self, f"enc{i}")
                for i in range(self.config.enc_layers)]

    def _dec_layers(self):
        return [getattr(self, f"dec{i}")
                for i in range(self.config.dec_layers)]

    def _position_table(self):
        """The (max_length, units) sinusoid table in the model's dtype,
        made once (its rows do not depend on the table's length)."""
        key = (self.dtype, self.device)
        if key not in self._positions:
            c = self.config
            self._positions[key] = _sinusoid_positions(
                c.max_length, c.units, self.dtype, self.device)
        return self._positions[key]

    def _embed(self, embed, ids):
        """embed(ids) * sqrt(units) + positions 0..t-1, with the scale
        rounded to the embedding's dtype (the reference's weakly typed
        scalar)."""
        c = self.config
        x = embed(ids) * _in_dtype(c.units ** 0.5, self.dtype)
        return x + self._position_table()[:ids.shape[1]]

    # -- encode -------------------------------------------------------------
    def encode(self, src, src_valid_length=None):
        """Encoder memory (B, Ts, C) and the (B, Ts) key mask (None
        without valid lengths)."""
        x = _drop(self.enc_dropout, self._embed(self.src_embed, src))
        mask = None
        if src_valid_length is not None:
            pos = torch.arange(src.shape[1], device=src.device)
            mask = pos[None, :] < src_valid_length.reshape(-1, 1)
        for layer in self._enc_layers():
            x = layer(x, mask)
        return self.enc_ln(x), mask

    # -- teacher-forcing forward -------------------------------------------
    def forward(self, src, tgt, src_valid_length=None):
        """Training pass: logits (B, T_tgt, V_tgt)."""
        memory, src_mask = self.encode(src, src_valid_length)
        x = _drop(self.enc_dropout, self._embed(self.tgt_embed, tgt))
        for layer in self._dec_layers():
            x, _ = layer(x, memory, src_mask)
        x = self.dec_ln(x)
        return _ops.fully_connected(x, self.tgt_embed.weight)

    def _decode_step(self, tok, memory, src_mask, cache):
        """One incremental decoder step: tok (B, 1) -> logits (B, V) and
        the cache advanced by one."""
        c = self.config
        x = self.tgt_embed(tok) * _in_dtype(c.units ** 0.5, self.dtype)
        x = x + self._position_table().index_select(
            0, cache.length.long().reshape(1))
        for i, layer in enumerate(self._dec_layers()):
            x, cache = layer(x, memory, src_mask, cache=cache, layer_idx=i)
        cache = cache.advance(1)
        x = self.dec_ln(x)
        logits = _ops.fully_connected(x, self.tgt_embed.weight)
        return logits[:, 0, :], cache

    # -- beam search --------------------------------------------------------
    @torch.no_grad()
    def translate(self, src, src_valid_length=None, beam_size=4,
                  max_length=None, alpha=0.6):
        """Length-penalised beam search (Sockeye/GNMT lp =
        ((5 + len) / 6)^alpha). src (B, Ts) ints, src_valid_length (B,)
        or None. Returns (tokens (B, beam, L) int32, scores (B, beam)
        float32), best first; sequences end at eos and pad with eos."""
        c = self.config
        K = int(beam_size)
        max_length = int(max_length or c.max_length)
        if max_length > c.max_length:
            raise MXNetError(f"max_length {max_length} > model max "
                             f"{c.max_length}")
        dev = self.device
        ids = torch.as_tensor(src, device=dev).long()
        vl = None if src_valid_length is None else torch.as_tensor(
            src_valid_length, device=dev).to(torch.int32)
        return self._beam_core(ids, vl, K, max_length, alpha)

    def _beam_core(self, src_ids, src_vl, K, max_length, alpha):
        c = self.config
        B = src_ids.shape[0]
        dev = self.device
        memory, src_mask = self.encode(src_ids, src_vl)
        mem = memory.repeat_interleave(K, dim=0)
        smask = None if src_mask is None \
            else src_mask.repeat_interleave(K, dim=0)
        cache = KVCache.create(c.dec_layers, B * K, c.num_heads, max_length,
                               c.units // c.num_heads, dtype=self.dtype,
                               device=dev)
        toks = torch.full((B, K, max_length), c.eos_id, dtype=torch.int32,
                          device=dev)
        # beam 0 live, the others at NEG so that step 1 expands one beam
        scores = torch.tensor([0.0] + [NEG] * (K - 1), dtype=torch.float32,
                              device=dev).repeat(B, 1)
        finished = torch.zeros((B, K), dtype=torch.bool, device=dev)
        cur = torch.full((B * K, 1), c.bos_id, dtype=torch.long, device=dev)
        V = c.tgt_vocab_size
        # finished beams extend only with eos, at no cost
        eos_only = torch.full((V,), NEG, dtype=torch.float32, device=dev)
        eos_only[c.eos_id] = 0.0
        base = torch.arange(B, device=dev)[:, None] * K
        for t in range(max_length):
            logits, cache = self._decode_step(cur, mem, smask, cache)
            logp = torch.log_softmax(logits.float(), dim=-1).reshape(B, K, V)
            logp = torch.where(finished[..., None], eos_only, logp)
            flat = (scores[..., None] + logp).reshape(B, K * V)
            # lax.top_k: the lower index first among equal totals
            flat, idx = torch.sort(flat, dim=-1, descending=True,
                                   stable=True)
            scores, idx = flat[:, :K], idx[:, :K]
            parent = torch.div(idx, V, rounding_mode="floor")
            token = (idx - parent * V).to(torch.int32)
            toks = torch.gather(toks, 1, parent[..., None].expand(
                B, K, max_length))
            toks[:, :, t] = token
            finished = torch.gather(finished, 1, parent) \
                | (token == c.eos_id)
            cache = cache.reorder((base + parent).reshape(-1))
            cur = token.reshape(B * K, 1).long()
        # length penalty over the tokens up to and including the first eos
        lengths = (toks == c.eos_id).to(torch.int32).argmax(dim=-1) + 1
        lengths = torch.where(finished, lengths,
                              torch.full_like(lengths, max_length))
        final = scores / torch.pow((5.0 + lengths.float()) / 6.0, alpha)
        order = torch.sort(final, dim=1, descending=True, stable=True)[1]
        toks = torch.gather(toks, 1, order[..., None].expand(
            B, K, max_length))
        return toks, torch.gather(final, 1, order)
