"""mx.npx: the ML extensions of the numpy namespace.

Counterpart of mxnet_tpu/numpy_extension/__init__.py: the ops with no
NumPy counterpart (softmax, activations, convolution, pooling, one_hot,
pick, sequence ops) and the set_np / is_np_* mode switches. The NDArray
follows NumPy semantics always, so the switches are accepted no-ops.
"""
from __future__ import annotations

from functools import partial as _partial

from ..ops.nn import (  # noqa: F401
    softmax, log_softmax, Activation as activation,
    Convolution as convolution, Pooling as pooling,
    FullyConnected as fully_connected, BatchNorm as batch_norm,
    LayerNorm as layer_norm, Dropout as dropout, dot_product_attention,
)
from ..ops.tensor import (  # noqa: F401
    reshape, pick, gather_nd, scatter_nd, one_hot, topk, sort, argsort,
    slice, slice_axis, slice_like, sequence_mask, stop_gradient, cast,
    Embedding as embedding,
)
from ..ops.math import clip, dot, batch_dot  # noqa: F401
from ..rng import seed  # noqa: F401

relu = _partial(activation, act_type="relu")
sigmoid = _partial(activation, act_type="sigmoid")

_np_mode = True


def set_np(shape=True, array=True, dtype=False):
    """Accepted no-op: numpy semantics are always on."""
    return True


def reset_np():
    return True


def is_np_shape():
    return True


def is_np_array():
    return True


def is_np_default_dtype():
    return True
