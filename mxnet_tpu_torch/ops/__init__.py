"""Operators: plain tensor functions and the hand-written CUDA kernels
(the modules `fused_attention`, `ragged_attention` and `detection`)."""
from . import detection, fused_attention, nn
from .ragged_attention import (LAUNCHES, ragged_decode_attention,
                               ragged_span_attention, ragged_supported,
                               reset_launches)

__all__ = ["detection", "fused_attention", "nn", "LAUNCHES",
           "ragged_decode_attention", "ragged_span_attention",
           "ragged_supported", "reset_launches"]
