"""Operators: plain tensor functions and the hand-written CUDA kernels."""
from . import nn
from .ragged_attention import (LAUNCHES, ragged_decode_attention,
                               ragged_span_attention, ragged_supported,
                               reset_launches)

__all__ = ["nn", "LAUNCHES", "ragged_decode_attention",
           "ragged_span_attention", "ragged_supported", "reset_launches"]
