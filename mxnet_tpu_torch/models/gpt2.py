"""GPT-2 for training, lockstep generation and serving over a ragged
paged KV cache.

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
  * LoRA adapters (the reference's `_lora`/`_lora_delta`): the forward
    takes an `AdapterBatch` (a serving AdapterPool's slab and each
    row's slab slot) and adds each row's own low-rank delta to the
    query/key/value/proj outputs. The reference installs it as a module
    global around its traced program; here it is a forward argument.
    Without one the forward is the adapter-free one, bit for bit.
  * the serving tensor-parallel split (the reference's `_tp_ctx`): a
    shard GPT2Model built with tp=(rank, size) holds its head slice of
    query/key/value and fc1 (column-parallel) and the matching in-slice
    of proj and fc2 (row-parallel); `tp_forward` runs the shards in
    lockstep over a parallel.tp.TPGroup, one reduction per projection,
    the row-parallel bias added once after it. The reference's
    `_lora_delta` under tp is `lora_rank_part` + `lora_finish`.
    parallel/tp.py `shard_gpt2` builds the shards from a full model.
  * the lockstep (static-cache) forward and `generate()`: a contiguous
    KVCache or a scalar-length PagedKVCache. The chunk is written at the
    cache's length (`write_prompt` for a prompt, `write` for one token)
    and attends over the layer's whole (B, H, T_max, D) view under the
    mask `valid & causal`, (1, 1, t, T_max), K and V cast to q's dtype,
    in the (B, H, T, D) layout. One token's mask is key padding, so the
    fused attention kernel takes it through its BHTD strides; a prompt's
    is not, and takes the plain softmax attention, as the reference
    leaves it to XLA.

Not ported: `generate(mesh=...)`.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import autograd as _ag
from ..base import MXNetError, not_ported, resolve_device
from ..nn.layers import TensorBlock
from ..nn import Dense, Dropout, Embedding, LayerNorm
from ..ops import nn as _ops
from ..ops.ragged_attention import (ragged_decode_attention,
                                    ragged_span_attention)
from .convert import init_params
from .kv_cache import KVCache, PagedKVCache

__all__ = ["GPT2Config", "GPT2Model", "GPT2ForCausalLM", "gpt2_small_config",
           "gpt2_medium_config", "gpt2_774m_config", "gpt2_xl_config",
           "AdapterBatch", "tp_forward", "gpt2_pp_functions"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class AdapterBatch(NamedTuple):
    """The LoRA operand of a batched forward: an AdapterPool's slab, A
    (4, L, S, U, R) and B (4, L, S, R, U) with scale (S,) = alpha/rank
    (the leading 4 = query/key/value/proj), and each batch row's slab
    slot `slots` (Bsz,). Slot 0 is the null adapter (zeros, scale 0).
    An int8 slab carries per-(proj, layer, slot) float32 dequant scales
    `a_scale`/`b_scale` (4, L, S); a float slab None."""
    A: torch.Tensor
    B: torch.Tensor
    scale: torch.Tensor
    slots: torch.Tensor
    a_scale: Optional[torch.Tensor] = None
    b_scale: Optional[torch.Tensor] = None


def _lora_slice(ad, leaf, pidx, layer):
    """Each row's slice of slab leaf `leaf` ("A": (Bsz, U, R), "B":
    (Bsz, R, U)) for projection `pidx` of `layer`, dequantized to
    float32 for an int8 slab."""
    slots = ad.slots.long()
    g = getattr(ad, leaf)[pidx, layer][slots]
    sc = ad.a_scale if leaf == "A" else ad.b_scale
    if sc is not None:
        g = g.float() * sc[pidx, layer][slots][:, None, None]
    return g


def lora_delta(ad, pidx, layer, x):
    """Each row's low-rank delta for projection `pidx` of `layer`: x @
    A_s @ B_s * alpha/r with s the row's slab slot, in the reference's
    order (the products in the slab's dtype, float32 for an int8 slab
    after the gathered slices are dequantized; scaled in float32; cast
    to x's dtype)."""
    ag = _lora_slice(ad, "A", pidx, layer)
    bg = _lora_slice(ad, "B", pidx, layer)
    d = torch.bmm(torch.bmm(x.to(ag.dtype), ag), bg)
    return (d.float() * ad.scale[ad.slots.long()][:, None, None]).to(x.dtype)


def lora_rank_part(ad, pidx, layer, x, rank):
    """Under tensor parallelism, shard `rank`'s rank-R partial of
    projection `pidx`'s delta: its U-slice of the input against its
    local U rows of A (ad holds the shard's slab slices). For
    query/key/value the input is the replicated residual, sliced here
    at the shard's head offset; proj's input is already the shard's
    head slice. The partials' sum (all_reduce) is x @ A."""
    ag = _lora_slice(ad, "A", pidx, layer)
    u = ag.shape[1]
    xs = x if pidx == 3 else x[..., rank * u:(rank + 1) * u]
    return torch.bmm(xs.to(ag.dtype), ag)


def lora_finish(ad, pidx, layer, r, dtype, rank, size):
    """The shard's delta from the reduced rank-R product `r`: r @ its
    out-slice of B, scaled in float32 and cast to `dtype`. For proj the
    slice is scattered to its head offset in a full-width zero tensor,
    so that proj's own reduction assembles the whole delta."""
    d = torch.bmm(r, _lora_slice(ad, "B", pidx, layer))
    d = (d.float() * ad.scale[ad.slots.long()][:, None, None]).to(dtype)
    if pidx != 3:
        return d
    u = d.shape[-1]
    full = torch.zeros(d.shape[:-1] + (u * size,), dtype=d.dtype,
                       device=d.device)
    full[..., rank * u:(rank + 1) * u] = d
    return full


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


class GPT2Attention(TensorBlock):
    """Causal self-attention: over the chunk itself (no cache, training),
    over a lockstep cache (generate) or over a ragged paged KV cache
    (serving). tp=(rank, size): shard `rank` of a
    size-way head split (num_heads / size heads; query/key/value give
    units / size outputs, proj takes units / size inputs)."""

    def __init__(self, units, num_heads, device, dtype, dropout=0.0,
                 attention_impl="auto", tp=(0, 1)):
        super().__init__()
        if units % num_heads:
            raise MXNetError(f"units {units} % heads {num_heads} != 0")
        rank, size = tp
        if num_heads % size:
            raise MXNetError(f"tp={size} must divide num_heads "
                             f"({num_heads})")
        self._units, self._num_heads = units, num_heads
        self._dropout, self._impl = dropout, attention_impl
        self._tp = (rank, size)
        kw = dict(device=device, dtype=dtype)
        local = units // size
        self.query = Dense(units, local, **kw)
        self.key = Dense(units, local, **kw)
        self.value = Dense(units, local, **kw)
        self.proj = Dense(local, units, **kw)

    def _project(self, dense, pidx, x, layer_idx, adapters):
        y = dense(x)
        if adapters is None:
            return y
        return y + lora_delta(adapters, pidx, layer_idx, x)

    def forward(self, x, cache, layer_idx, adapters=None):
        b, t, _ = x.shape
        h, d = self._num_heads, self._units // self._num_heads
        q = self._project(self.query, 0, x, layer_idx, adapters)
        k = self._project(self.key, 1, x, layer_idx, adapters)
        v = self._project(self.value, 2, x, layer_idx, adapters)
        q, k, v = (y.view(b, t, h, d) for y in (q, k, v))
        if cache is None:
            # training: the head split stays (B, T, H, D), which the fused
            # kernel reads through its strides
            out = _ops.dot_product_attention(
                q, k, v, causal=True,
                dropout_p=self._dropout if _ag.training_active(self)
                else 0.0,
                impl=self._impl, layout="BTHD")
            out = out.reshape(b, t, h * d)
            return self._project(self.proj, 3, out, layer_idx,
                                 adapters), None
        if cache.ragged:
            out, cache = self._attend(q, k, v, cache, layer_idx)
        else:
            out, cache = self._attend_lockstep(q, k, v, cache, layer_idx)
        return self._project(self.proj, 3, out, layer_idx, adapters), cache

    def _attend_lockstep(self, q, k, v, cache, layer_idx):
        """Write the chunk's k/v (B, t, h, d) at the lockstep cache's
        length and attend over the layer's whole buffer. Returns the
        output (B, t, h * d) and the cache."""
        b, t, h, d = q.shape
        write = cache.write_prompt if t > 1 else cache.write
        k_all, v_all, cache = write(layer_idx, k.transpose(1, 2),
                                    v.transpose(1, 2))
        valid = cache.key_mask(extra=t)                     # (T_max,)
        q_pos = cache.length + torch.arange(t, device=q.device)
        k_pos = torch.arange(k_all.shape[2], device=q.device)
        causal = k_pos[None, :] <= q_pos[:, None]           # (t, T_max)
        mask = (valid[None, :] & causal)[None, None]        # (1,1,t,T_max)
        out = _ops.dot_product_attention(
            q.transpose(1, 2), k_all.to(q.dtype), v_all.to(q.dtype), mask,
            impl=self._impl)
        return out.transpose(1, 2).reshape(b, t, h * d), cache

    def _attend(self, q, k, v, cache, layer_idx):
        """Write the chunk's k/v (B, t, h, d) into the ragged cache and
        attend each slot's live rows over its pages. Returns the output
        (B, t, h * d) in q's dtype and the cache."""
        b, t, h, d = q.shape
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
        return out.to(q.dtype).reshape(b, t, h * d), cache

    def tp_attend(self, x, cache, layer_idx, deltas=None):
        """A shard's attention under tensor parallelism up to proj: its
        query/key/value head slice of x (plus each one's reduced LoRA
        delta in `deltas`), the cache write and the attention over its
        pools. Returns the (B, t, units / size) output."""
        b, t, _ = x.shape
        h = self._num_heads // self._tp[1]
        d = self._units // self._num_heads
        ys = [dense(x) for dense in (self.query, self.key, self.value)]
        if deltas is not None:
            ys = [y + dl for y, dl in zip(ys, deltas)]
        q, k, v = (y.view(b, t, h, d) for y in ys)
        return self._attend(q, k, v, cache, layer_idx)[0]


class GPT2Block(TensorBlock):
    """Pre-LN transformer block (GPT-2 style)."""

    def __init__(self, cfg, device, dtype, tp=(0, 1)):
        super().__init__()
        c, kw = cfg, dict(device=device, dtype=dtype)
        if c.hidden_size % tp[1]:
            raise MXNetError(f"tp={tp[1]} must divide the FFN hidden size "
                             f"({c.hidden_size})")
        self.ln1 = LayerNorm(c.units, c.layer_norm_eps, **kw)
        self.attn = GPT2Attention(c.units, c.num_heads,
                                  dropout=c.attention_dropout,
                                  attention_impl=c.attention_impl, tp=tp,
                                  **kw)
        self.ln2 = LayerNorm(c.units, c.layer_norm_eps, **kw)
        self.fc1 = Dense(c.units, c.hidden_size // tp[1], **kw)
        self.fc2 = Dense(c.hidden_size // tp[1], c.units, **kw)
        self._activation = c.activation
        self.dropout = Dropout(c.dropout) if c.dropout else None

    def _drop(self, h):
        return self.dropout(h) if self.dropout is not None else h

    def forward(self, x, cache, layer_idx, adapters=None):
        h, cache = self.attn(self.ln1(x), cache, layer_idx, adapters)
        x = x + self._drop(h)
        h = _ops.activation(self.fc1(self.ln2(x)), self._activation)
        return x + self._drop(self.fc2(h)), cache

    def tp_mlp(self, x):
        """A shard's MLP partial under tensor parallelism: fc1's hidden
        slice (column-parallel), then fc2's bias-free partial product
        (row-parallel; w8 scales applied to the partial)."""
        h = _ops.activation(self.fc1(self.ln2(x)), self._activation)
        return self.fc2(h, bias=False)


class GPT2Model(TensorBlock):
    """Embeddings + pre-LN blocks + final LN. tp=(rank, size) builds
    shard `rank` of a size-way tensor-parallel split (parallel/tp.py
    shard_gpt2 fills it; tp_forward runs it)."""

    def __init__(self, config, device, dtype, tp=(0, 1)):
        super().__init__()
        c = self.config = config
        kw = dict(device=device, dtype=dtype)
        self.tp = tuple(tp)
        self.word_embed = Embedding(c.vocab_size, c.units, **kw)
        self.position_embed = Embedding(c.max_length, c.units, **kw)
        self.embed_dropout = Dropout(c.dropout) if c.dropout else None
        for i in range(c.num_layers):
            self.add_module(f"layer{i}", GPT2Block(c, tp=tp, **kw))
        self.ln_f = LayerNorm(c.units, c.layer_norm_eps, **kw)

    def blocks(self):
        return [getattr(self, f"layer{i}")
                for i in range(self.config.num_layers)]

    def embed(self, inputs, cache=None):
        """Token plus position embeddings of the chunk (B, t)."""
        t = inputs.shape[1]
        positions = torch.arange(t, device=inputs.device)
        if cache is not None and not cache.ragged:
            # lockstep: every row's token j sits at length + j
            positions = (cache.length + positions).clamp(
                max=self.config.max_length - 1)
        elif cache is not None:
            # per-slot positions: slot b's row j sits at length[b] + j.
            # Dead rows of a slot near capacity (and parked free slots)
            # run past the position table; jnp.take fills those with NaN,
            # a torch index would fault, so they are clamped. Their values
            # never reach a live row: dead rows write no KV and attend
            # nothing.
            positions = (cache.length[:, None].long() + positions).clamp(
                max=self.config.max_length - 1)
        return self.word_embed(inputs) + self.position_embed(positions)

    def forward(self, inputs, cache=None, adapters=None):
        """(hidden states (B, t, C), cache advanced by t or None)."""
        if self.tp[1] > 1:
            raise MXNetError("a tensor-parallel shard runs only inside "
                             "tp_forward")
        t = inputs.shape[1]
        x = self.embed(inputs, cache)
        if self.embed_dropout is not None:
            x = self.embed_dropout(x)
        for i, block in enumerate(self.blocks()):
            x, cache = block(x, cache, i, adapters)
        return self.ln_f(x), None if cache is None else cache.advance(t)


def _add_bias(full, dense):
    return full if dense.bias is None else full + dense.bias


@torch.no_grad()
def tp_forward(shards, group, inputs, caches, adapters=None):
    """The serving forward under tensor parallelism: the shard backbones
    (parallel/tp.py shard_gpt2) in lockstep over `group`, one shard
    after another between reductions, as the reference's shard_map body
    runs on every shard between its psums:

      * each shard embeds the chunk (replicated embeddings);
      * per layer, each shard's attention partial (its heads over its
        own pools, then proj's bias-free partial product), ONE
        all_reduce, proj's bias once, the residual; then each shard's
        MLP partial, ONE all_reduce, fc2's bias once, the residual;
      * the final LayerNorm and the tied LM head once, on shard 0.

    inputs (B, t) token ids on shard 0's device; caches one ragged
    PagedKVCache per shard over its (L, pages, page, H / size, D) pools,
    written in place; adapters None or one AdapterBatch per shard (its
    slab slices: A on the U axis, B on the out axis): each projection's
    rank-R partial is reduced once more before its delta, and proj's
    delta rides proj's own reduction. Returns the logits (B, t, V) on
    shard 0's device. Serving only: no dropout."""
    size = group.size
    ranks = range(size)
    blocks = [s.blocks() for s in shards]
    xs = [s.embed(x, c) for s, x, c in
          zip(shards, group.broadcast(inputs), caches)]
    for i in range(shards[0].config.num_layers):
        bl = [blocks[r][i] for r in ranks]
        hs = [bl[r].ln1(xs[r]) for r in ranks]
        deltas = [None] * size
        if adapters is not None:
            per = []
            for pidx in range(3):
                red = group.all_reduce([lora_rank_part(
                    adapters[r], pidx, i, hs[r], r) for r in ranks])
                per.append([lora_finish(adapters[r], pidx, i, red[r],
                                        hs[r].dtype, r, size)
                            for r in ranks])
            deltas = [[per[p][r] for p in range(3)] for r in ranks]
        outs = [bl[r].attn.tp_attend(hs[r], caches[r], i, deltas[r])
                for r in ranks]
        parts = [bl[r].attn.proj(outs[r], bias=False) for r in ranks]
        if adapters is not None:
            red = group.all_reduce([lora_rank_part(
                adapters[r], 3, i, outs[r], r) for r in ranks])
            parts = [parts[r] + lora_finish(adapters[r], 3, i, red[r],
                                            outs[r].dtype, r, size)
                     for r in ranks]
        full = group.all_reduce(parts)
        xs = [xs[r] + _add_bias(full[r], bl[r].attn.proj) for r in ranks]
        full = group.all_reduce([bl[r].tp_mlp(xs[r]) for r in ranks])
        xs = [xs[r] + _add_bias(full[r], bl[r].fc2) for r in ranks]
    h = shards[0].ln_f(xs[0])
    return _ops.fully_connected(h, shards[0].word_embed.weight)


class GPT2ForCausalLM(TensorBlock):
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

    def forward(self, inputs, cache=None, adapters=None):
        """inputs (B, t) int token ids; cache None (training: positions
        0..t-1, causal attention over the chunk), a lockstep cache
        (KVCache, or a scalar-length PagedKVCache) or a ragged
        PagedKVCache; adapters None or an AdapterBatch (each row's LoRA
        delta). Returns the logits (B, t, V) alone without a cache, as
        the reference does, else (logits, cache advanced by t)."""
        h, cache = self.backbone(inputs, cache, adapters)
        logits = _ops.fully_connected(h, self.backbone.word_embed.weight)
        return logits if cache is None else (logits, cache)

    def make_cache(self, batch, max_length, paged=False, page_size=64,
                   dtype=None, page_table=None, lengths=None,
                   attn_impl="auto", kv_dtype=None):
        """A contiguous KVCache (paged=False, the reference's default) or
        a PagedKVCache (lockstep without `lengths`, ragged with them), in
        the model's dtype and on its device."""
        c = self.config
        if kv_dtype is not None and not paged:
            raise MXNetError("kv_dtype needs a paged cache")
        dims = (c.num_layers, batch, c.num_heads, max_length,
                c.units // c.num_heads)
        if not paged:
            return KVCache.create(*dims, dtype=dtype or self.dtype,
                                  device=self.device)
        return PagedKVCache.create(
            *dims, dtype=dtype or self.dtype, page_size=page_size,
            page_table=page_table, lengths=lengths, attn_impl=attn_impl,
            kv_dtype=kv_dtype, device=self.device)

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens, do_sample=False,
                 temperature=1.0, top_k=None, top_p=None,
                 eos_token_id=None, seed=0, paged=False, page_size=64,
                 mesh=None):
        """Autoregressive generation over a lockstep cache: one prefill
        forward of the prompt, then one single-token forward a step
        (greedy, or temperature / top-k / top-p sampling). input_ids (B,
        T0) ints; returns (B, max_new_tokens) int32 on the model's
        device. The eos token itself is emitted, and every later position
        of its row is eos; the loop ends early once every row has emitted
        eos. paged=True decodes over a lockstep PagedKVCache of
        `page_size` pages (capacity rounded up to whole pages), else over
        a contiguous KVCache.

        The reference compiles the decode into one lax.while_loop; here a
        Python loop runs the same body, one forward a step (the step after
        the last emitted token included, as the reference's body runs it).
        Sampled tokens are drawn by Gumbel-max from a torch.Generator on
        the model's device seeded with `seed`, so they are reproducible
        for a seed but are not the reference's jax.random draws; greedy
        decoding is the reference's, token for token."""
        from ..serving.sampling import filtered_logits  # serving imports us
        if mesh is not None:
            raise not_ported("GPT2ForCausalLM.generate over a device mesh")
        if top_p is not None and top_p >= 1.0:
            top_p = None  # the full distribution: a true no-op
        dev = self.device
        ids = torch.as_tensor(input_ids, device=dev).long()
        B, T0 = ids.shape
        total = T0 + max_new_tokens
        c = self.config
        if total > c.max_length:
            raise MXNetError(
                f"prompt {T0} + {max_new_tokens} new > max_length "
                f"{c.max_length}")
        if paged:
            total = -(-total // page_size) * page_size
        gen = torch.Generator(device=dev).manual_seed(int(seed)) \
            if do_sample else None
        # filtered_logits' per-row knobs (top_k 0 and top_p 1: no filter)
        knobs = [torch.full((B,), x, dtype=dt, device=dev) for x, dt in (
            (temperature, torch.float32), (top_k or 0, torch.int64),
            (1.0 if top_p is None else top_p, torch.float32))]

        def select(logits):
            logits = logits.float()
            if not do_sample:
                return torch.argmax(logits, dim=-1).to(torch.int32)
            filtered = filtered_logits(logits, *knobs)
            u = torch.rand(filtered.shape, generator=gen, device=dev)
            return torch.argmax(filtered - torch.log(-torch.log(u)),
                                dim=-1).to(torch.int32)

        eos = -1 if eos_token_id is None else int(eos_token_id)
        cache = self.make_cache(B, total, paged=paged, page_size=page_size)
        logits, cache = self(ids, cache)
        tok = select(logits[:, -1])
        out = torch.full((B, max_new_tokens), 0 if eos < 0 else eos,
                         dtype=torch.int32, device=dev)
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        for i in range(max_new_tokens):
            # rows that emitted eos keep padding with it; the early exit
            # reads `done` back only when an eos can end a row
            if eos >= 0 and bool(done.all()):
                break
            out[:, i] = torch.where(done, eos, tok)
            logits, cache = self(tok[:, None], cache)
            done = done | (tok == eos)
            tok = select(logits[:, -1])
        return out


def gpt2_pp_functions(model, n_stages):
    """A GPT2ForCausalLM split into the (embed_fn, stage_fn,
    head_loss_fn) triple parallel.PPTrainStep takes, with its parameter
    trees: returns (embed_fn, stage_fn, head_loss_fn, embed_params,
    stacked_body_params, head_params, tied) (parity:
    mxnet_tpu/models/gpt2.py `gpt2_pp_functions`).

    Stage s owns num_layers / n_stages consecutive blocks (a list of
    per-block dicts of name -> tensor, stacked over the stages); the
    token + position embedding runs on stage 0 and the final LayerNorm,
    the tied LM head and the causal cross-entropy (float32) on the last.
    tied = [("wte", "wte")]: PPTrainStep sums the two wte gradients and
    mirrors the embed copy into the head. The blocks run through
    torch.func.functional_call on the model's own modules (the fused
    attention kernel on the card). Dropout must be 0: the 1F1B backward
    recomputes each stage."""
    from ..parallel.pp import stack_stage_params
    c = model.config
    if c.dropout or c.attention_dropout:
        raise MXNetError("gpt2_pp_functions: build the model with "
                         "dropout=0 (pipeline recompute must be "
                         "deterministic)")
    backbone = model.backbone
    blocks = backbone.blocks()
    L = len(blocks)
    if L % n_stages:
        raise MXNetError(f"{L} layers not divisible by {n_stages} stages")
    k = L // n_stages

    def block_params(b):
        return {n: p.detach() for n, p in b.named_parameters()}

    stacked = stack_stage_params(
        [[block_params(b) for b in blocks[s * k:(s + 1) * k]]
         for s in range(n_stages)])
    template = blocks[:k]

    def stage_fn(stage_params, h):
        for i in range(k):
            h, _ = torch.func.functional_call(template[i], stage_params[i],
                                              (h, None, i))
        return h

    wte = backbone.word_embed.weight.detach()
    embed_params = {"wte": wte,
                    "wpe": backbone.position_embed.weight.detach()}
    head_params = {"g": backbone.ln_f.gamma.detach(),
                   "b": backbone.ln_f.beta.detach(), "wte": wte}
    eps = c.layer_norm_eps

    def embed_fn(ep, ids):
        t = ids.shape[1]
        return ep["wte"][ids.long()] + ep["wpe"][:t][None]

    def head_loss_fn(hp, h, labels):
        x32 = h.float()
        xn = torch.nn.functional.layer_norm(
            x32, x32.shape[-1:], hp["g"].float(), hp["b"].float(), eps)
        logp = torch.log_softmax(xn @ hp["wte"].float().t(), -1)
        return -logp.gather(-1, labels.long()[..., None]).mean()

    return (embed_fn, stage_fn, head_loss_fn, embed_params, stacked,
            head_params, [("wte", "wte")])
