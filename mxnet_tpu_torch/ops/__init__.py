"""Operators: plain tensor functions and the hand-written CUDA kernels
(the modules `fused_attention`, `ragged_attention` and `detection`), and
the op registry behind mx.nd (`registry`, with the op modules `tensor`,
`math`, `init`, `random` and the registered forms in `nn` and
`detection`)."""
from . import detection, fused_attention, nn, registry
from . import init, math, random, tensor  # noqa: F401  (fill the registry)
from .ragged_attention import (LAUNCHES, ragged_decode_attention,
                               ragged_span_attention, ragged_supported,
                               reset_launches)
from .registry import OPS, apply_op, get_op, op

__all__ = ["detection", "fused_attention", "nn", "registry", "init", "math",
           "random", "tensor", "OPS", "apply_op", "get_op", "op", "LAUNCHES",
           "ragged_decode_attention", "ragged_span_attention",
           "ragged_supported", "reset_launches"]
