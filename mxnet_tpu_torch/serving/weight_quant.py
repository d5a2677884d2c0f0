"""w8 weight serving: int8 weight codes with per-out-tile float32 scales.

Counterpart of mxnet_tpu/serving/weight_quant.py.
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
out dim; a tile is the largest divisor of that extent <= 128.

Under tensor parallelism (`shard_quantized`, the reference's scale
layout) each shard takes:

  * column-parallel: its out rows of the codes and the scale tiles of
    those rows (a tile never straddles two shards, because it divides
    out_dim // max_shards);
  * row-parallel: its in columns of the codes and ALL the scales, which
    it applies to its partial product before the reduction (a scale
    depends only on the out index, so scaling the partials equals
    scaling the sum).

The codes and scales themselves are the same bytes at any tp.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..base import MXNetError
from ..parallel.rules import (COL_WEIGHT_PATTERN, ROW_WEIGHT_PATTERN,
                              megatron_kind)

__all__ = ["QuantizedWeight", "pick_out_tile", "quantize_weight",
           "build_weight_plan", "dequantize", "megatron_kind",
           "shard_quantized", "COL_WEIGHT_PATTERN", "ROW_WEIGHT_PATTERN"]

# per-out-tile scale granularity cap (the reference's DEFAULT_TILE_CAP)
DEFAULT_TILE_CAP = 128


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


def quantize_weight(w, kind, tp=1, max_shards=None):
    """Symmetric int8 quantization of a (out, in) dense weight with
    per-out-tile float32 scales, computed in float32 on w's device.
    `tp` is the shard count the engine serves at; `max_shards` (column
    weights) the finest legal one, which pins the tile. Returns (codes,
    scale, tile)."""
    w = w.detach().float()
    if w.dim() != 2:
        raise MXNetError(f"w8 quantizes 2-D dense weights, got "
                         f"{tuple(w.shape)}")
    out_dim = int(w.shape[0])
    if kind == "col":
        tp = int(tp)
        shards = int(max_shards or tp)
        if shards % tp or out_dim % shards:
            raise MXNetError(
                f"column-parallel out dim {out_dim} / max_shards "
                f"{shards} not compatible with tp={tp}")
        tile = pick_out_tile(out_dim // shards)
        if (out_dim // tp) % tile:
            raise MXNetError(f"out tile {tile} does not divide per-shard "
                             f"out dim {out_dim // tp}")
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


def shard_quantized(codes, scale, kind, rank, size):
    """Shard `rank` of `size`'s slice of one quantized weight: (codes,
    scale). Column-parallel: the out rows [rank * o, (rank + 1) * o) of
    the codes, o = out // size, and the scale tiles of those rows;
    row-parallel: the in columns likewise, with every scale. Views (the
    caller copies what it keeps)."""
    if kind == "col":
        o = codes.shape[0] // size
        tile = codes.shape[0] // scale.shape[0]
        if o % tile:
            raise MXNetError(f"out tile {tile} does not divide per-shard "
                             f"out dim {o}")
        return (codes[rank * o:(rank + 1) * o],
                scale[rank * o // tile:(rank + 1) * o // tile])
    if kind == "row":
        i = codes.shape[1] // size
        return codes[:, rank * i:(rank + 1) * i], scale
    raise MXNetError(f"unknown w8 weight kind {kind!r}")


def build_weight_plan(named_params, tp=1, max_shards=None):
    """Classify and quantize a model's serving weights: every 2-D weight
    matching the megatron column/row split. named_params: iterable of
    (name, tensor) in the model's parameter order. Returns a list of
    QuantizedWeight (possibly empty)."""
    plan = []
    for index, (name, p) in enumerate(named_params):
        kind = megatron_kind(name)
        if kind is None or p.dim() != 2:
            continue
        codes, scale, t = quantize_weight(p, kind, tp=tp,
                                          max_shards=max_shards)
        plan.append(QuantizedWeight(index, name, kind, codes, scale, t))
    return plan
