"""Creation ops.

Counterpart of mxnet_tpu/ops/init.py: zeros, ones, full, empty, arange,
linspace, eye, tri, meshgrid, indices. Placement is `ctx=` or the
default device (the innermost `with ctx:` scope, else the card, which
raises without one). `empty` returns zeros, as the reference's does.
"""
from __future__ import annotations

import numpy as _np
import torch

from .. import device as _device

__all__ = ["zeros", "ones", "full", "empty", "arange", "linspace", "eye",
           "tri", "meshgrid", "indices"]


def _nd(t):
    from ..ndarray.ndarray import NDArray
    return NDArray(t)


def _dt(dtype):
    from ..ndarray.ndarray import to_torch_dtype
    return to_torch_dtype(dtype)


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def zeros(shape, ctx=None, dtype="float32", **kwargs):
    return _nd(torch.zeros(_shape(shape), dtype=_dt(dtype),
                           device=_device.to_torch(ctx)))


def ones(shape, ctx=None, dtype="float32", **kwargs):
    return _nd(torch.ones(_shape(shape), dtype=_dt(dtype),
                          device=_device.to_torch(ctx)))


def full(shape, val=None, ctx=None, dtype="float32", fill_value=None,
         **kwargs):
    v = val if val is not None else fill_value
    return _nd(torch.full(_shape(shape), v, dtype=_dt(dtype),
                          device=_device.to_torch(ctx)))


def empty(shape, ctx=None, dtype="float32"):
    return zeros(shape, ctx=ctx, dtype=dtype)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype="float32"):
    # the reference's jnp.arange: numpy's element count, float32 values
    a = _np.arange(start, stop, step).astype(_np.float64)
    t = torch.as_tensor(a).to(_dt(dtype))
    if repeat != 1:
        t = t.repeat_interleave(repeat)
    return _nd(t.to(_device.to_torch(ctx)))


def linspace(start, stop, num, endpoint=True, ctx=None, dtype="float32"):
    num = int(num)
    if endpoint:
        t = torch.linspace(start, stop, num, dtype=torch.float64)
    else:
        t = torch.linspace(start, stop, num + 1, dtype=torch.float64)[:num]
    return _nd(t.to(_dt(dtype)).to(_device.to_torch(ctx)))


def eye(N, M=0, k=0, ctx=None, dtype="float32"):
    a = _np.eye(int(N), int(M) if M else None, k=k)
    return _nd(torch.as_tensor(a).to(_dt(dtype)).to(_device.to_torch(ctx)))


def tri(N, M=None, k=0, ctx=None, dtype="float32"):
    a = _np.tri(int(N), M, k=k)
    return _nd(torch.as_tensor(a).to(_dt(dtype)).to(_device.to_torch(ctx)))


def meshgrid(*arrays, indexing="xy"):
    from ..ndarray.ndarray import NDArray
    ts = [a._data if isinstance(a, NDArray) else torch.as_tensor(a)
          for a in arrays]
    return tuple(_nd(g) for g in torch.meshgrid(*ts, indexing=indexing))


def indices(dimensions, dtype="int32", ctx=None):
    a = _np.indices(tuple(dimensions))
    return _nd(torch.as_tensor(a).to(_dt(dtype)).to(_device.to_torch(ctx)))
