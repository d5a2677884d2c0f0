"""PyTorch and CUDA port of mxnet_tpu.

The JAX package `mxnet_tpu` is the reference; this package computes the
same functions with PyTorch, and every Pallas kernel of the reference
is a CUDA kernel written for Hopper (`csrc/`, built at first use by
`ops/_build.py`). It imports torch and never jax.

`import mxnet_tpu_torch as mx` gives the reference's namespace: mx.nd
(NDArray and the op registry), mx.autograd, mx.gluon (Block,
Parameter, nn, loss, Trainer, utils), mx.init / mx.initializer,
mx.optimizer, mx.lr_scheduler, mx.random, mx.rng, mx.amp, mx.np /
mx.npx, mx.checkpoint, mx.operator, mx.functional, mx.kv / mx.kvstore,
mx.cpu() / mx.gpu()
(the default device is the card; without one, placing an array there
raises); `mxnet_tpu_torch.serialization` reads and writes the
reference's `.params` files. Below it: GPT-2 serving over a ragged
paged KV cache (`serving`, `models`), training steps
(`parallel.TrainStep`, `checkpoint.TrainCheckpoint`), BERT,
GPT-2, NMT, ResNet and SSD models, and the hand-written kernels
(`ops.fused_attention`, `ops.ragged_attention`, `ops.detection`).
ROADMAP.md lists what is still to come.
"""
from .base import MXNetError, resolve_device
from .device import (Context, Device, cpu, cpu_pinned, cpu_shared,  # noqa
                     current_context, current_device, default_device, gpu,
                     num_gpus, num_tpus, tpu)
from . import autograd  # noqa: F401
from . import ndarray  # noqa: F401
from . import ndarray as nd  # noqa: F401
from . import rng  # noqa: F401
from .ndarray.ndarray import NDArray, array, waitall  # noqa: F401
from .ops import random  # noqa: F401

__all__ = ["MXNetError", "resolve_device", "Context", "Device", "cpu",
           "gpu", "tpu", "num_gpus", "default_device", "current_context",
           "autograd", "nd", "ndarray", "rng", "random", "NDArray", "array",
           "waitall"]

_LAZY = {"gluon": "mxnet_tpu_torch.gluon",
         "optimizer": "mxnet_tpu_torch.optimizer",
         "initializer": "mxnet_tpu_torch.initializer",
         "init": "mxnet_tpu_torch.initializer",
         "lr_scheduler": "mxnet_tpu_torch.lr_scheduler",
         "metric": "mxnet_tpu_torch.metric",
         "models": "mxnet_tpu_torch.models",
         "parallel": "mxnet_tpu_torch.parallel",
         "serving": "mxnet_tpu_torch.serving",
         "telemetry": "mxnet_tpu_torch.telemetry",
         "context": "mxnet_tpu_torch.device",
         "amp": "mxnet_tpu_torch.amp",
         "np": "mxnet_tpu_torch.numpy",
         "npx": "mxnet_tpu_torch.numpy_extension",
         "checkpoint": "mxnet_tpu_torch.checkpoint",
         "operator": "mxnet_tpu_torch.operator",
         "functional": "mxnet_tpu_torch.functional",
         "kv": "mxnet_tpu_torch.kvstore",
         "kvstore": "mxnet_tpu_torch.kvstore"}


def __getattr__(name):
    spec = _LAZY.get(name)
    if spec is None:
        raise AttributeError(
            f"module 'mxnet_tpu_torch' has no attribute {name!r}")
    import importlib
    mod = importlib.import_module(spec)
    globals()[name] = mod
    return mod
