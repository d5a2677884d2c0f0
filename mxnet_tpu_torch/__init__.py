"""PyTorch and CUDA port of mxnet_tpu.

The JAX package `mxnet_tpu` is the reference; this package computes the
same functions with PyTorch, and every Pallas kernel of the reference
that it has ported is a CUDA kernel written for Hopper
(`csrc/`, built at first use by `ops/_build.py`). It imports torch and
never jax.

Ported so far: GPT-2 continuous-batching serving over a ragged paged KV
cache (`serving.ServingEngine`, `models.GPT2ForCausalLM`,
`models.PagedKVCache`, `ops.ragged_span_attention`,
`ops.ragged_decode_attention`), and the single-device BERT MLM training
step (`models.BertForMaskedLM`, `loss.SoftmaxCrossEntropyLoss`,
`optimizer.AdamW`, `parallel.TrainStep`, `ops.fused_attention`).
ROADMAP.md lists what is still to come.
"""
from .base import MXNetError, resolve_device

__all__ = ["MXNetError", "resolve_device"]
