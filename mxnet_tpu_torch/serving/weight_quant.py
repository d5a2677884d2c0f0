"""w8 weight serving: int8 weight codes with per-out-tile float32 scales.

Counterpart of mxnet_tpu/serving/weight_quant.py at tp = 1.
`ServingEngine(weight_dtype="int8")` quantizes the megatron column/row
dense weights ONCE at construction (symmetric int8, one scale per tile
of output rows) and serves from the codes: each quantized `Dense` holds
its `codes` and `scale` as buffers in place of the float weight, and
ops.nn.fully_connected applies the scale to the product's output before
the bias. Embeddings, the tied LM head, norms and biases stay float.

The tiling keeps the reference's rules, so codes and scales equal the
reference's byte for byte: a column-parallel weight (query/key/value,
fc1) tiles at the finest legal tensor-parallel split (`max_shards`, the
engine passes num_heads), a row-parallel one (proj, fc2) over its whole
out dim; a tile is the largest divisor of that extent <= 128. The
tensor-parallel scale layout itself is not ported.
"""
from __future__ import annotations

import re
from typing import NamedTuple

import torch

from ..base import MXNetError

__all__ = ["QuantizedWeight", "pick_out_tile", "quantize_weight",
           "build_weight_plan", "dequantize", "megatron_kind",
           "COL_WEIGHT_PATTERN", "ROW_WEIGHT_PATTERN"]

# per-out-tile scale granularity cap (the reference's DEFAULT_TILE_CAP)
DEFAULT_TILE_CAP = 128

# the megatron column/row weight classifiers, a copy of
# mxnet_tpu/parallel/rules.py's (first match wins, column first)
COL_WEIGHT_PATTERN = (r"(query|key|value|qkv|attn_in|ffn?_?1|intermediate"
                      r"|fc1)\.weight$")
ROW_WEIGHT_PATTERN = (r"(proj|attn_out|out_proj|ffn?_?2|output|fc2)"
                      r"\.weight$")
_COL_WEIGHT_RE = re.compile(COL_WEIGHT_PATTERN)
_ROW_WEIGHT_RE = re.compile(ROW_WEIGHT_PATTERN)


def megatron_kind(name):
    """'col' / 'row' / None for a parameter path under the megatron dense
    split."""
    if _COL_WEIGHT_RE.search(name):
        return "col"
    if _ROW_WEIGHT_RE.search(name):
        return "row"
    return None


class QuantizedWeight(NamedTuple):
    """One quantized serving weight."""
    index: int              # position in the model's named_parameters()
    name: str               # parameter path
    kind: str               # 'col' | 'row' (megatron split)
    codes: torch.Tensor     # int8 (out, in)
    scale: torch.Tensor     # float32 (out // tile,)
    tile: int               # out rows per scale entry


def pick_out_tile(n, cap=DEFAULT_TILE_CAP):
    """Largest divisor of `n` that is <= cap (>= 1)."""
    for d in range(min(int(n), int(cap)), 0, -1):
        if n % d == 0:
            return d
    return 1


def quantize_weight(w, kind, max_shards=None):
    """Symmetric int8 quantization of a (out, in) dense weight with
    per-out-tile float32 scales, computed in float32 on w's device.
    Returns (codes, scale, tile)."""
    w = w.detach().float()
    if w.dim() != 2:
        raise MXNetError(f"w8 quantizes 2-D dense weights, got "
                         f"{tuple(w.shape)}")
    out_dim = int(w.shape[0])
    if kind == "col":
        shards = int(max_shards or 1)
        if out_dim % shards:
            raise MXNetError(f"column-parallel out dim {out_dim} / "
                             f"max_shards {shards} not compatible")
        tile = pick_out_tile(out_dim // shards)
    elif kind == "row":
        tile = pick_out_tile(out_dim)
    else:
        raise MXNetError(f"unknown w8 weight kind {kind!r}")
    n_tiles = out_dim // tile
    grouped = w.reshape(n_tiles, tile, w.shape[1])
    amax = grouped.abs().amax(dim=(1, 2))
    scale = amax.clamp_min(1e-8) / 127.0
    codes = torch.clamp(torch.round(grouped / scale[:, None, None]),
                        -127, 127).to(torch.int8)
    return codes.reshape(w.shape), scale, tile


def dequantize(q):
    """The merged dequantized float32 weight of a QuantizedWeight (or any
    (codes, scale) pair), a tensor on the codes' device: the weight of
    the float model a w8 engine is held to."""
    rows = q.codes.shape[0] // q.scale.shape[0]
    return q.codes.float() * q.scale.float().repeat_interleave(rows)[:, None]


def build_weight_plan(named_params, max_shards=None):
    """Classify and quantize a model's serving weights: every 2-D weight
    matching the megatron column/row split. named_params: iterable of
    (name, tensor) in the model's parameter order. Returns a list of
    QuantizedWeight (possibly empty)."""
    plan = []
    for index, (name, p) in enumerate(named_params):
        kind = megatron_kind(name)
        if kind is None or p.dim() != 2:
            continue
        codes, scale, t = quantize_weight(p, kind, max_shards=max_shards)
        plan.append(QuantizedWeight(index, name, kind, codes, scale, t))
    return plan
