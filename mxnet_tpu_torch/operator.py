"""mx.operator: user-defined operators.

Counterpart of mxnet_tpu/operator.py. Two ways in:

  * `register_op(name, fn, grad=None)`: fn is a function over torch
    tensors (a user's own CUDA kernel behind a wrapper enters the
    registry this way). It becomes an op of the registry (mx.nd.<name>)
    that takes NDArrays and records under autograd like a built-in. With
    grad=(fwd, bwd), in the reference's custom-vjp form — fwd(*inputs)
    -> (output, residuals), bwd(residuals, output_grad) -> one gradient
    per input — the op is a torch.autograd.Function with that backward;
    without it, torch differentiates fn.
  * the legacy class API, `CustomOp` / `CustomOpProp` + `@register`,
    invoked by `mx.nd.Custom(..., op_type=name)`: eager, and, as in the
    reference, it runs `forward(is_train=False)` only.
"""
from __future__ import annotations

import torch

from .base import MXNetError
from .ops.registry import op as _op_deco

__all__ = ["CustomOp", "CustomOpProp", "register", "register_op", "get"]

_custom_props = {}


def _custom_vjp(fn, fwd, bwd):
    class _Op(torch.autograd.Function):
        @staticmethod
        def forward(ctx, kwargs, *args):
            out, res = fwd(*args, **kwargs)
            ctx.res = res
            ctx.single = isinstance(out, torch.Tensor)
            return out

        @staticmethod
        def backward(ctx, *out_grads):
            grads = bwd(ctx.res, out_grads[0] if ctx.single else out_grads)
            if isinstance(grads, torch.Tensor):
                grads = (grads,)
            return (None,) + tuple(grads)

    def call(*args, **kwargs):
        return _Op.apply(kwargs, *args)

    call.__name__ = getattr(fn, "__name__", "custom_op")
    return call


def register_op(name, fn, grad=None, register_global=True):
    """fn(*tensors, **static_kwargs) as an operator over NDArrays; grad:
    an optional (fwd, bwd) pair. Returns the op; with register_global it
    is also mx.nd.<name>."""
    if grad is not None:
        fwd, bwd = grad
        fn = _custom_vjp(fn, fwd, bwd)
    return _op_deco(name, register=register_global)(fn)


class CustomOp:
    """Base class for legacy custom operators: subclasses implement
    forward / backward and write outputs with assign()."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise MXNetError(
            f"{type(self).__name__}.backward not implemented; legacy "
            "CustomOp autograd requires it (or use register_op)")

    @staticmethod
    def assign(dst, req, src):
        """Honour the write / add / null request."""
        if req in ("null", 0):
            return
        data = src._data if hasattr(src, "_data") else torch.as_tensor(
            src, device=dst._data.device)
        if req in ("add", 3):
            dst._rebind(dst._data + data)
        else:
            dst._rebind(data)


class CustomOpProp:
    """Declares a legacy custom op's signature."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]], []

    def infer_type(self, in_type):
        return in_type, [in_type[0]], []

    def create_operator(self, ctx, in_shapes, in_dtypes):
        raise NotImplementedError


def register(reg_name):
    """Class decorator registering a CustomOpProp under reg_name."""

    def deco(prop_cls):
        if not issubclass(prop_cls, CustomOpProp):
            raise MXNetError("register() expects a CustomOpProp subclass")
        _custom_props[reg_name] = prop_cls
        return prop_cls

    return deco


def get(reg_name):
    if reg_name not in _custom_props:
        raise MXNetError(f"no custom op {reg_name!r} registered "
                         f"(have {sorted(_custom_props)})")
    return _custom_props[reg_name]


def Custom(*data, op_type=None, **kwargs):
    """Run a registered legacy custom op eagerly (parity: mx.nd.Custom);
    its outputs start as float32 zeros on the first input's device."""
    from .device import from_torch_device
    from .ops import init as _init
    if op_type is None:
        raise MXNetError("Custom requires op_type=")
    prop = get(op_type)(**kwargs)
    in_shapes = [tuple(d.shape) for d in data]
    _, out_shapes, _ = prop.infer_shape(list(in_shapes))
    operator = prop.create_operator(None, in_shapes, [d.dtype for d in data])
    ctx = from_torch_device(data[0]._data.device) if data else None
    outs = [_init.zeros(tuple(s), ctx=ctx) for s in out_shapes]
    operator.forward(False, ["write"] * len(outs), list(data), outs, [])
    return outs[0] if len(outs) == 1 else tuple(outs)
