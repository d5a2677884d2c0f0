"""Gradient compression with error feedback: 2-bit and blockwise int8.

Counterpart of mxnet_tpu/gradient_compression.py (`TwoBitCompressor`,
`Int8BlockCompressor`), the codecs of src/kvstore/gradient_compression.cc
that the kvstore applies on its cross-process reduce:

  * 2-bit: values at or above +threshold quantize to +threshold, at or
    below -threshold to -threshold, else 0; 16 codes a uint32 word (code
    1 = +t, 2 = -t, in bits 2j..2j+1), the payload 1/16 of float32's;
  * int8 blocks: each `block`-sized run of the flattened gradient is
    quantized symmetrically against scale = max(|block|, 1e-12) / 127,
    codes rounded half to even and clipped to [-127, 127]; the payload is
    one uint8 array, the code bytes (padded length) then the float32
    scales' bytes.

The quantization error of a key is kept as its residual and added to its
next gradient. The payloads are the reference's bytes, and
`compress(key, grad).nbytes == wire_bytes(grad.shape)`. They run where
the gradient lives (the card or the CPU).
"""
from __future__ import annotations

import math

import torch

from .base import MXNetError
from .parallel.compression import dequantize_2bit, quantize_2bit

__all__ = ["TwoBitCompressor", "Int8BlockCompressor"]


def _flat32(grad):
    return grad.reshape(-1).float()


class TwoBitCompressor:
    """Stateful per-key 2-bit compressor (residual = error feedback)."""

    def __init__(self, threshold=0.5):
        t = float(threshold)
        if t <= 0:
            raise MXNetError("2bit compression threshold must be > 0")
        self.threshold = t
        self._residual = {}

    def compress(self, key, grad):
        """grad (any shape, float) -> packed uint32 words. Adds the
        stored residual first and keeps the new quantization error."""
        flat = _flat32(grad)
        res = self._residual.get(key)
        if res is not None:
            flat = flat + res
        packed = quantize_2bit(flat, self.threshold)
        self._residual[key] = flat - dequantize_2bit(packed, self.threshold,
                                                     flat.shape[0])
        return packed

    def decompress(self, packed, shape, dtype=torch.float32):
        n = math.prod(shape)
        return dequantize_2bit(packed, self.threshold, n).reshape(
            shape).to(dtype)

    def wire_bytes(self, shape):
        return ((math.prod(shape) + 15) // 16) * 4


class Int8BlockCompressor:
    """Blockwise int8 compressor with error feedback (see module doc)."""

    def __init__(self, block=256):
        b = int(block)
        if b < 1:
            raise MXNetError("int8 compression block must be >= 1")
        self.block = b
        self._residual = {}

    def _quantize(self, flat):
        b = self.block
        pad = (-flat.shape[0]) % b
        g = torch.cat([flat, flat.new_zeros(pad)]) if pad else flat
        g = g.reshape(-1, b)
        # the reference's max / 127 compiles to a product with float32
        # 1/127, which this reproduces bit for bit
        scale = torch.clamp(g.abs().amax(dim=1), min=1e-12) * torch.tensor(
            1.0 / 127.0, dtype=torch.float32, device=g.device)
        codes = torch.clamp(torch.round(g / scale[:, None]), -127,
                            127).to(torch.int8)
        return torch.cat([codes.reshape(-1).view(torch.uint8),
                          scale.float().view(torch.uint8)])

    def _dequantize(self, payload, n):
        b = self.block
        nb = (n + b - 1) // b
        padded = nb * b
        codes = payload[:padded].view(torch.int8).reshape(nb, b)
        scale = payload[padded:].clone().view(torch.float32)
        return (codes.float() * scale[:, None]).reshape(-1)[:n]

    def compress(self, key, grad):
        """grad (any shape, float) -> uint8 payload (codes then scales).
        Adds the stored residual first and keeps the new error."""
        flat = _flat32(grad)
        res = self._residual.get(key)
        if res is not None:
            flat = flat + res
        payload = self._quantize(flat)
        self._residual[key] = flat - self._dequantize(payload,
                                                      flat.shape[0])
        return payload

    def decompress(self, payload, shape, dtype=torch.float32):
        return self._dequantize(payload, math.prod(shape)).reshape(
            shape).to(dtype)

    def wire_bytes(self, shape):
        n = math.prod(shape)
        nb = (n + self.block - 1) // self.block
        return nb * self.block + nb * 4
