"""NDArray: the imperative tensor handle.

Counterpart of mxnet_tpu/ndarray/ndarray.py. An NDArray wraps one
torch.Tensor in `_data`, as the reference wraps a jax.Array; it is a
wrapper, not a torch.Tensor subclass, so the port's tensor paths
(parallel.TrainStep, the serving engine) never see it. Every operator
goes through the op funnel (ops/registry.py), which decides whether the
autograd graph is built.

Semantics follow the reference, not torch:
  * dtypes: a Python int becomes int32, a float float32, a bool bool;
    numpy int64 / float64 inputs become int32 / float32, and no op
    result is int64 or float64 (the reference runs JAX without 64-bit
    types). `dtype` is a numpy dtype (torch's bfloat16, which numpy
    lacks, is reported as torch.bfloat16).
  * `reshape` takes MXNet's special codes 0, -1, -2, -3 and -4.
  * in-place operators (`+=`, `x[...] = v`, `copyto`) write the tensor
    in place outside `autograd.record()` and rebind it inside (the
    reference's functional update, so the graph stays consistent); both
    bump `_version`.
  * `__bool__`, `__float__` and `__int__` take one element.
  * `array(x)` with no ctx lands on the default device (the card;
    without one it raises): CPU callers pass ctx=mx.cpu().
"""
from __future__ import annotations

import numpy as _np
import torch

from .. import autograd
from .. import device as _device
from ..base import MXNetError

__all__ = ["NDArray", "array", "waitall", "from_torch", "newaxis",
           "to_torch_dtype", "np_dtype"]

newaxis = None

_NAMED = {"float32": torch.float32, "float16": torch.float16,
          "bfloat16": torch.bfloat16, "float64": torch.float32,
          "int32": torch.int32, "int64": torch.int32, "int8": torch.int8,
          "uint8": torch.uint8, "int16": torch.int16, "bool": torch.bool,
          "bool_": torch.bool, "complex64": torch.complex64,
          "float": torch.float32, "int": torch.int32,
          "uint32": torch.int32, "uint64": torch.int32}
_NP_OF = {torch.float32: _np.dtype("float32"),
          torch.float16: _np.dtype("float16"),
          torch.int32: _np.dtype("int32"), torch.int8: _np.dtype("int8"),
          torch.uint8: _np.dtype("uint8"), torch.int16: _np.dtype("int16"),
          torch.bool: _np.dtype("bool"),
          torch.complex64: _np.dtype("complex64"),
          torch.int64: _np.dtype("int64"), torch.float64: _np.dtype("float64")}
# the reference's JAX runs without 64-bit types
_NARROW = {torch.int64: torch.int32, torch.float64: torch.float32,
           torch.complex128: torch.complex64}


def to_torch_dtype(dtype):
    """A dtype given as a string, numpy dtype or type, or torch.dtype, as
    the torch.dtype an NDArray holds (64-bit types narrowed)."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        return _NARROW.get(dtype, dtype)
    if dtype is float:
        return torch.float32
    if dtype is int:
        return torch.int32
    if dtype is bool:
        return torch.bool
    name = str(dtype) if isinstance(dtype, str) else _np.dtype(dtype).name
    try:
        return _NAMED[name]
    except KeyError:
        raise MXNetError(f"unsupported dtype {dtype!r}") from None


def np_dtype(tdtype):
    return _NP_OF.get(tdtype, tdtype)


def _default_dtype(value):
    if isinstance(value, (bool, _np.bool_)):
        return torch.bool
    if isinstance(value, (int, _np.integer)):
        return torch.int32
    if isinstance(value, complex):
        return torch.complex64
    return torch.float32


def _narrow(t):
    d = _NARROW.get(t.dtype)
    return t if d is None else t.to(d)


def _as_tensor(data, device=None, dtype=None):
    """Any array-like as a tensor on `device` (None: the default
    device), with the reference's default dtypes."""
    tdtype = to_torch_dtype(dtype)
    if isinstance(data, NDArray):
        data = data._data
    if isinstance(data, torch.Tensor):
        t = data
        if device is not None and t.device != device:
            t = t.to(device)
        if tdtype is not None and t.dtype != tdtype:
            t = t.to(tdtype)
        return t
    dev = _device.to_torch(None) if device is None else device
    if isinstance(data, _np.ndarray) or hasattr(data, "__array__") and \
            not isinstance(data, (list, tuple)):
        a = _np.asarray(data)
        if a.dtype.kind in "US" or a.dtype == object:
            raise MXNetError(f"cannot make an NDArray of {a.dtype}")
        if tdtype is None and a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.astype(_np.float32)).to(torch.bfloat16)
        else:
            # a copy: an NDArray never aliases the caller's numpy array
            t = torch.from_numpy(_np.array(a, copy=True, order="C"))
            t = _narrow(t) if tdtype is None else t.to(tdtype)
        return t.to(dev) if t.device != dev else t
    if tdtype is None:
        if _np.isscalar(data):
            tdtype = _default_dtype(data)
        else:
            a = _np.asarray(data)
            tdtype = to_torch_dtype(a.dtype)
    return torch.as_tensor(_np.asarray(data), device=dev).to(tdtype)


class NDArray:
    """Imperative tensor: a torch.Tensor in `_data`."""

    __slots__ = ("_data", "_version", "__weakref__")

    __array_priority__ = 1000.0

    def __init__(self, data, ctx=None, dtype=None):
        if isinstance(data, torch.Tensor) and ctx is None and dtype is None:
            self._data = data
        else:
            dev = None if ctx is None else _device.to_torch(ctx)
            self._data = _as_tensor(data, dev, dtype)
        self._version = 0

    # -- properties ------------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return np_dtype(self._data.dtype)

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def size(self):
        return self._data.numel()

    @property
    def itemsize(self):
        return self._data.element_size()

    @property
    def nbytes(self):
        return self.size * self.itemsize

    @property
    def context(self):
        return _device.from_torch_device(self._data.device)

    ctx = context
    device = context

    @property
    def stype(self):
        return "default"

    @property
    def T(self):
        return self.transpose()

    # -- synchronisation ---------------------------------------------------
    def wait_to_read(self):
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()

    wait_to_write = wait_to_read

    def asnumpy(self):
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy().copy()

    def asscalar(self):
        if self.size != 1:
            raise MXNetError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def item(self):
        return self.asscalar()

    def tolist(self):
        return self.asnumpy().tolist()

    # -- autograd ----------------------------------------------------------
    def attach_grad(self, grad_req="write", stype=None):
        """Make this array a tracked leaf with a zero gradient (parity:
        NDArray.attach_grad); it leaves any graph it was on."""
        if grad_req not in ("write", "add", "null"):
            raise MXNetError(f"invalid grad_req {grad_req!r}")
        t = self._data.detach()
        if grad_req != "null":
            t.requires_grad_(True)
            t.grad = torch.zeros_like(t)
        t._mx_grad_req = grad_req
        self._data = t

    @property
    def grad(self):
        g = self._data.grad if self._data.is_leaf else None
        return None if g is None else NDArray(g)

    @property
    def _grad_req(self):
        return autograd.grad_req_of(self._data)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        autograd.backward([self], [out_grad], retain_graph=retain_graph,
                          train_mode=train_mode)

    def detach(self):
        return NDArray(self._data.detach())

    def zero_grad(self):
        g = self._data.grad
        if g is not None:
            with torch.no_grad():
                g.zero_()

    def _assign_from(self, other):
        """Write `other`'s values into this array (same shape)."""
        src = other._data if isinstance(other, NDArray) else other
        if tuple(src.shape) != self.shape:
            raise MXNetError(f"in-place assign shape mismatch "
                             f"{tuple(src.shape)} vs {self.shape}")
        src = src.to(device=self._data.device, dtype=self._data.dtype)
        if autograd.is_recording() and (src.requires_grad
                                        or self._data.requires_grad):
            self._data = src
        else:
            with torch.no_grad():
                self._data.copy_(src)
        self._version += 1

    def _rebind(self, data):
        self._data = data
        self._version += 1

    # -- conversion and placement -----------------------------------------
    def astype(self, dtype, copy=True):
        td = to_torch_dtype(dtype)
        if not copy and td == self._data.dtype:
            return self
        from ..ops import tensor as _t
        return _t.cast(self, dtype=dtype)

    def as_in_context(self, ctx):
        dev = _device.to_torch(ctx)
        if dev == self._data.device:
            return self
        from ..ops import registry as _r
        return _r.apply_op("as_in_context", lambda x: x.to(dev), [self])

    as_in_ctx = as_in_context
    to_device = as_in_context

    def copyto(self, other):
        """Parity: NDArray.copyto: to a Device, a new array there; to an
        NDArray, its values overwritten."""
        if isinstance(other, _device.Device):
            return NDArray(self._data.detach().to(other.torch_device,
                                                  copy=True))
        other._assign_from(self._data.detach())
        return other

    def copy(self):
        return NDArray(self._data.detach().clone())

    def as_nd_ndarray(self):
        return self

    def as_np_ndarray(self):
        return self

    def tostype(self, stype):
        if stype != "default":
            raise MXNetError("sparse storage is not ported yet")
        return self

    # -- indexing ----------------------------------------------------------
    def __getitem__(self, key):
        from ..ops import tensor as _t
        return _t._getitem(self, key)

    def __setitem__(self, key, value):
        from ..ops import tensor as _t
        _t._setitem(self, key, value)

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    # -- operators ---------------------------------------------------------
    def _binop(self, name, other, reverse=False):
        from ..ops import math as _m
        fn = getattr(_m, name)
        if isinstance(other, (list, tuple, _np.ndarray)):
            other = NDArray(_as_tensor(other, self._data.device))
        return fn(other, self) if reverse else fn(self, other)

    def __add__(self, o):
        return self._binop("add", o)

    def __radd__(self, o):
        return self._binop("add", o, True)

    def __sub__(self, o):
        return self._binop("subtract", o)

    def __rsub__(self, o):
        return self._binop("subtract", o, True)

    def __mul__(self, o):
        return self._binop("multiply", o)

    def __rmul__(self, o):
        return self._binop("multiply", o, True)

    def __truediv__(self, o):
        return self._binop("divide", o)

    def __rtruediv__(self, o):
        return self._binop("divide", o, True)

    def __floordiv__(self, o):
        return self._binop("floor_divide", o)

    def __rfloordiv__(self, o):
        return self._binop("floor_divide", o, True)

    def __mod__(self, o):
        return self._binop("mod", o)

    def __rmod__(self, o):
        return self._binop("mod", o, True)

    def __pow__(self, o):
        return self._binop("power", o)

    def __rpow__(self, o):
        return self._binop("power", o, True)

    def __matmul__(self, o):
        return self._binop("matmul", o)

    def __rmatmul__(self, o):
        return self._binop("matmul", o, True)

    def __neg__(self):
        return self._binop("multiply", -1)

    def __abs__(self):
        from ..ops import math as _m
        return _m.abs(self)

    def __eq__(self, o):
        return self._binop("equal", o)

    def __ne__(self, o):
        return self._binop("not_equal", o)

    def __lt__(self, o):
        return self._binop("less", o)

    def __le__(self, o):
        return self._binop("less_equal", o)

    def __gt__(self, o):
        return self._binop("greater", o)

    def __ge__(self, o):
        return self._binop("greater_equal", o)

    def __and__(self, o):
        return self._binop("bitwise_and", o)

    def __or__(self, o):
        return self._binop("bitwise_or", o)

    def __xor__(self, o):
        return self._binop("bitwise_xor", o)

    def __invert__(self):
        from ..ops import math as _m
        return _m.logical_not(self) if self._data.dtype == torch.bool \
            else _m.bitwise_not(self)

    def __hash__(self):
        return id(self)

    def _iop(self, name, other):
        self._assign_from(self._binop(name, other))
        return self

    def __iadd__(self, o):
        return self._iop("add", o)

    def __isub__(self, o):
        return self._iop("subtract", o)

    def __imul__(self, o):
        return self._iop("multiply", o)

    def __itruediv__(self, o):
        return self._iop("divide", o)

    def __bool__(self):
        if self.size != 1:
            raise MXNetError("The truth value of an NDArray with multiple "
                             "elements is ambiguous")
        return bool(self._data.reshape(()).item())

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __index__(self):
        if self.ndim == 0 and not self._data.is_floating_point() \
                and self._data.dtype != torch.bool:
            return int(self.asscalar())
        raise TypeError("only integer scalar arrays can be converted to "
                        "index")

    def __repr__(self):
        return f"{self.asnumpy()!r}\n<NDArray {self.shape} @{self.context}>"

    def __str__(self):
        return str(self.asnumpy())

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    # -- method mirrors of ops ---------------------------------------------
    def reshape(self, *shape, **kwargs):
        from ..ops import tensor as _t
        if not shape and "shape" in kwargs:
            shape = kwargs["shape"]
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return _t.reshape(self, shape=shape)

    def reshape_like(self, other):
        return self.reshape(other.shape)

    def transpose(self, *axes):
        from ..ops import tensor as _t
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return _t.transpose(self, axes=axes if axes else None)

    def swapaxes(self, a1, a2):
        from ..ops import tensor as _t
        return _t.swapaxes(self, a1, a2)

    def flatten(self):
        from ..ops import tensor as _t
        return _t.flatten(self)

    def expand_dims(self, axis):
        from ..ops import tensor as _t
        return _t.expand_dims(self, axis=axis)

    def squeeze(self, axis=None):
        from ..ops import tensor as _t
        return _t.squeeze(self, axis=axis)

    def broadcast_to(self, shape):
        from ..ops import tensor as _t
        return _t.broadcast_to(self, shape=shape)

    def broadcast_like(self, other):
        return self.broadcast_to(other.shape)

    def repeat(self, repeats, axis=None):
        from ..ops import tensor as _t
        return _t.repeat(self, repeats=repeats, axis=axis)

    def tile(self, reps):
        from ..ops import tensor as _t
        return _t.tile(self, reps=reps)

    def slice_axis(self, axis, begin, end):
        from ..ops import tensor as _t
        return _t.slice_axis(self, axis=axis, begin=begin, end=end)

    def take(self, indices, axis=None, mode="clip"):
        from ..ops import tensor as _t
        return _t.take(self, indices, axis=axis, mode=mode)

    def clip(self, a_min=None, a_max=None):
        from ..ops import math as _m
        return _m.clip(self, a_min, a_max)

    def _unary(self, name):
        from ..ops import math as _m
        return getattr(_m, name)(self)

    def abs(self):
        return self._unary("abs")

    def sign(self):
        return self._unary("sign")

    def sqrt(self):
        return self._unary("sqrt")

    def square(self):
        return self._unary("square")

    def exp(self):
        return self._unary("exp")

    def log(self):
        return self._unary("log")

    def sum(self, axis=None, keepdims=False, dtype=None):
        from ..ops import math as _m
        return _m.sum(self, axis=axis, keepdims=keepdims, dtype=dtype)

    def mean(self, axis=None, keepdims=False, dtype=None):
        from ..ops import math as _m
        return _m.mean(self, axis=axis, keepdims=keepdims, dtype=dtype)

    def max(self, axis=None, keepdims=False):
        from ..ops import math as _m
        return _m.max(self, axis=axis, keepdims=keepdims)

    def min(self, axis=None, keepdims=False):
        from ..ops import math as _m
        return _m.min(self, axis=axis, keepdims=keepdims)

    def prod(self, axis=None, keepdims=False):
        from ..ops import math as _m
        return _m.prod(self, axis=axis, keepdims=keepdims)

    def argmax(self, axis=None, keepdims=False):
        from ..ops import tensor as _t
        return _t.argmax(self, axis=axis, keepdims=keepdims)

    def argmin(self, axis=None, keepdims=False):
        from ..ops import tensor as _t
        return _t.argmin(self, axis=axis, keepdims=keepdims)

    def argsort(self, axis=-1, is_ascend=True):
        from ..ops import tensor as _t
        return _t.argsort(self, axis=axis, is_ascend=is_ascend)

    def topk(self, axis=-1, k=1, ret_typ="indices", is_ascend=False):
        from ..ops import tensor as _t
        return _t.topk(self, axis=axis, k=k, ret_typ=ret_typ,
                       is_ascend=is_ascend)

    def dot(self, other):
        from ..ops import math as _m
        return _m.dot(self, other)

    def norm(self, ord=2, axis=None, keepdims=False):
        from ..ops import math as _m
        return _m.norm(self, ord=ord, axis=axis, keepdims=keepdims)

    def softmax(self, axis=-1):
        from ..ops import nn as _n
        return _n.softmax(self, axis=axis)

    def log_softmax(self, axis=-1):
        from ..ops import nn as _n
        return _n.log_softmax(self, axis=axis)

    def one_hot(self, depth, on_value=1.0, off_value=0.0):
        from ..ops import tensor as _t
        return _t.one_hot(self, depth=depth, on_value=on_value,
                          off_value=off_value)

    def pad(self, mode="constant", pad_width=None, constant_value=0):
        from ..ops import tensor as _t
        return _t.pad(self, pad_width=pad_width, mode=mode,
                      constant_value=constant_value)

    def split(self, num_outputs, axis=0):
        from ..ops import tensor as _t
        return _t.split(self, num_outputs=num_outputs, axis=axis)


def from_torch(x):
    return NDArray(x)


def array(source_array, ctx=None, dtype=None):
    """Parity: mx.nd.array: Python lists and scalars default to float32;
    numpy inputs keep their dtype but for the 64-bit ones (int32,
    float32). No ctx: the default device."""
    if isinstance(source_array, NDArray):
        source_array = source_array._data
    if dtype is None and not hasattr(source_array, "dtype"):
        dtype = "float32"
    dev = _device.to_torch(ctx)
    t = _as_tensor(source_array, dev, dtype)
    if isinstance(source_array, torch.Tensor):
        t = t.detach().clone() if t is source_array else t.detach()
    return NDArray(t)


def waitall():
    """Parity: mx.nd.waitall: wait for all queued work on the card."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
