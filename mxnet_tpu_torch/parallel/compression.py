"""Compressed gradient collectives: the 2-bit wire over the dp shards.

Counterpart of mxnet_tpu/parallel/compression.py (`quantize_2bit`,
`dequantize_2bit`, `compressed_psum_mean`), the wire of
src/kvstore/gradient_compression.cc: 16 2-bit codes a uint32 word
(code 1 = +threshold, 2 = -threshold, 0 = 0; code j of a word in bits
2j..2j+1), each shard's quantization error kept as its residual and
added to its next gradient. The packed words are the reference's bit
for bit. torch has no uint32 arithmetic on every device, so the words
are built in int64 and returned as torch.uint32 (the collective moves
their int32 view: the same bytes).

`compressed_psum_mean` runs over the shards of the dp axis as a list
(parallel/collectives.py): each shard quantizes gradient + residual,
the packed words are all_gathered (recorded as such: 1/16 of the
float32 bytes), and every shard dequantizes and averages them.
TrainStep(compression="2bit") calls it (parallel/step.py).
"""
from __future__ import annotations

import torch

from . import collectives as _coll
from .mesh import place

__all__ = ["quantize_2bit", "dequantize_2bit", "compressed_psum_mean",
           "packed_words"]


def packed_words(n):
    """Words of the packed payload of n values."""
    return (int(n) + 15) // 16


def quantize_2bit(flat, threshold):
    """float (N,) -> packed words ((N+15)//16,) uint32."""
    flat = flat.reshape(-1)
    codes = torch.where(flat >= threshold, 1,
                        torch.where(flat <= -threshold, 2, 0)).to(
        torch.int64)
    pad = (-codes.shape[0]) % 16
    if pad:
        codes = torch.cat([codes, codes.new_zeros(pad)])
    shifts = torch.arange(16, device=codes.device, dtype=torch.int64) * 2
    words = (codes.reshape(-1, 16) << shifts).sum(dim=1)
    return ((words + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32).view(
        torch.uint32)


def dequantize_2bit(packed, threshold, n):
    """Packed words (..., W) int32 or uint32 -> float32 (..., n)."""
    if packed.dtype == torch.uint32:
        packed = packed.view(torch.int32)
    w = packed.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(16, device=w.device, dtype=torch.int64) * 2
    codes = (w[..., :, None] >> shifts) & 0x3
    codes = codes.reshape(codes.shape[:-2] + (-1,))[..., :n]
    t = torch.tensor(threshold, dtype=torch.float32, device=w.device)
    zero = torch.zeros((), dtype=torch.float32, device=w.device)
    return torch.where(codes == 1, t, torch.where(codes == 2, -t, zero))


def compressed_psum_mean(grads, residuals, threshold, devices=None):
    """Mean-reduce one gradient per dp shard through the 2-bit wire.

    grads: each shard's local gradient (any shape); residuals: each
    shard's float32 error-feedback buffer of that shape. Returns
    (reduced: the mean on every shard's device, float32, equal on every
    shard; new_residuals). The all_gather moves the packed words."""
    devices = [g.device for g in grads] if devices is None else devices
    shape = grads[0].shape
    n = grads[0].numel()
    packed, new_res = [], []
    for g, r in zip(grads, residuals):
        flat = g.reshape(-1).float() + place(r, g.device).reshape(-1)
        words = quantize_2bit(flat, threshold)
        own = dequantize_2bit(words, threshold, n)
        new_res.append((flat - own).reshape(shape))
        packed.append(words.view(torch.int32))
    gathered = _coll.all_gather(packed, 0, devices, tiled=False)
    out = []
    for gw in gathered:
        vals = dequantize_2bit(gw, threshold, n)
        out.append((vals.sum(dim=0) / vals.shape[0]).reshape(shape))
    return out, new_res
