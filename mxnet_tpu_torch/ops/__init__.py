"""Operators: plain tensor functions and the hand-written CUDA kernels
(the modules `fused_attention` and `ragged_attention`)."""
from . import fused_attention, nn
from .ragged_attention import (LAUNCHES, ragged_decode_attention,
                               ragged_span_attention, ragged_supported,
                               reset_launches)

__all__ = ["fused_attention", "nn", "LAUNCHES", "ragged_decode_attention",
           "ragged_span_attention", "ragged_supported", "reset_launches"]
