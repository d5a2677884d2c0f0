"""Block / HybridBlock: the model composition API.

Counterpart of mxnet_tpu/gluon/block.py. `Block` and `HybridBlock` are
torch.nn.Module subclasses, and the port's own layers and models
(nn/, models/, loss.py) are HybridBlocks: every model has
`collect_params()` / `initialize()` with no second class hierarchy.

A block's forward is written either over tensors (the port's layers and
models: `_forward_kind = "tensor"`) or over NDArrays (a user's gluon
block, the default: "ndarray"); containers pass their inputs through
("any"). `__call__` adapts the inputs: NDArrays into a tensor block are
unwrapped and its outputs wrapped (grad mode on only inside
`autograd.record()`), tensors into an NDArray block wrapped and its
outputs unwrapped; a call in the block's own kind is torch's call,
untouched, so `parallel.TrainStep` and the serving engine run exactly
as before. Forward hooks are torch's (`hook(block, args, out)`; the
handle also has the reference's `detach()`).

`collect_params(select)` keys parameters by structure path in
registration order (`backbone.encoder.layer0.attn.query.weight`), the
tied ones once. Deferred shapes: a block whose parameters have an
unknown (0) dimension fills them at its first call through
`infer_shape(*inputs)`, then initialises them if `initialize()` was
called. `hybridize()` records its flags and stays eager (a CUDA graph of
a hybridized block is later work). `save_parameters` /
`load_parameters` write and read the reference's `.npz` format
(serialization.py), keyed by structure path as in the reference, so a
file crosses between the packages; `export` and `SymbolBlock` are not
ported yet.
"""
from __future__ import annotations

import math
import re

import torch
from torch import nn

from .. import autograd
from .. import initializer as _init
from ..base import MXNetError, not_ported
from ..ndarray.ndarray import NDArray
from .parameter import Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "SymbolBlock"]


def _map(x, fn, kind):
    if isinstance(x, kind):
        return fn(x)
    if isinstance(x, tuple):
        return tuple(_map(v, fn, kind) for v in x)
    if isinstance(x, list):
        return [_map(v, fn, kind) for v in x]
    return x


def _unwrap(x):
    return _map(x, lambda a: a._data, NDArray)


def _wrap(x):
    return _map(x, NDArray, torch.Tensor)


def _has(args, kwargs, kind):
    for a in args:
        if isinstance(a, kind) or isinstance(a, (tuple, list)) and any(
                isinstance(e, kind) for e in a):
            return True
    return any(isinstance(v, kind) for v in kwargs.values())


class Block(nn.Module):
    """Base class for layers and models (parity: gluon.Block)."""

    _forward_kind = "ndarray"
    _deferred = False

    def __init__(self, *args, prefix=None, params=None, **kwargs):
        super().__init__(*args, **kwargs)
        if self._forward_kind == "ndarray":
            # a user's block follows autograd's training flag alone
            self.training = False

    # -- registration --------------------------------------------------------
    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            self.register_parameter(name, value._var)
            value._add_owner(self, name)
            if value._name in ("weight", "const"):
                value._name = name
            if value._var.is_meta:
                object.__setattr__(self, "_deferred", True)
            object.__setattr__(self, name, value)
            return
        if name in self.__dict__ and isinstance(self.__dict__[name],
                                                Parameter):
            del self.__dict__[name]
            self._parameters.pop(name, None)
        super().__setattr__(name, value)

    def register_child(self, block, name=None):
        self.add_module(str(len(self._modules)) if name is None else name,
                        block)
        return block

    @property
    def params(self):
        """This block's own parameters (parity: Block.params)."""
        return {n: Parameter._of(v) for n, v in self._parameters.items()
                if v is not None}

    def collect_params(self, select=None):
        """Every parameter of the tree keyed by structure path (select: a
        regex over the names)."""
        out, seen = ParameterDict(), set()
        for mname, mod in self.named_modules():
            for pname, var in mod._parameters.items():
                if var is None:
                    continue
                p = Parameter._of(var)
                p._add_owner(mod, pname)
                if id(var) in seen:
                    continue
                seen.add(id(var))
                full = f"{mname}.{pname}" if mname else pname
                p._structure_name = full
                out[full] = p
        if select is not None:
            pat = re.compile(select)
            out = ParameterDict((k, v) for k, v in out.items()
                                if pat.search(k))
        return out

    # -- lifecycle -------------------------------------------------------------
    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        self.collect_params().initialize(
            init=init if init is not None else _init.Uniform(), ctx=ctx,
            force_reinit=force_reinit)

    def cast(self, dtype):
        for p in self.collect_params().values():
            p.cast(dtype)
        return self

    def zero_grad(self, set_to_none=None):
        """The gluon form (no argument) zeroes every gradient in place, as
        the reference's; torch's `zero_grad(set_to_none=...)` is kept."""
        if set_to_none is not None:
            return super().zero_grad(set_to_none=set_to_none)
        self.collect_params().zero_grad()

    def reset_ctx(self, ctx):
        self.collect_params().reset_ctx(ctx)

    def save_parameters(self, filename, deduplicate=False):
        from ..serialization import save_parameter_dict
        save_parameter_dict(filename, self.collect_params())

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):
        """Parameters land on `ctx`, else where each already lives, else
        on the default device (deferred or uninitialised ones too)."""
        from ..serialization import load_parameter_dict
        load_parameter_dict(filename, self.collect_params(), ctx=ctx,
                            allow_missing=allow_missing,
                            ignore_extra=ignore_extra, cast_dtype=cast_dtype)

    # -- hooks -----------------------------------------------------------------
    def register_forward_hook(self, hook, *args, **kwargs):
        h = super().register_forward_hook(hook, *args, **kwargs)
        h.detach = h.remove
        return h

    def register_forward_pre_hook(self, hook, *args, **kwargs):
        h = super().register_forward_pre_hook(hook, *args, **kwargs)
        h.detach = h.remove
        return h

    # -- call ------------------------------------------------------------------
    def infer_shape(self, *args, **kwargs):
        """Fill deferred parameter shapes from the inputs; layers with
        deferred parameters implement it."""
        raise MXNetError(f"{type(self).__name__} has deferred-shape "
                         "parameters but does not implement infer_shape()")

    def _finish_deferred(self, args, kwargs):
        own = [Parameter._of(v) for v in self._parameters.values()
               if v is not None]
        if any(not p._shape_is_known for p in own):
            self.infer_shape(*args, **kwargs)
        for p in own:
            if p._var.is_meta:
                p._finish_deferred_init()
        object.__setattr__(self, "_deferred", False)

    def __call__(self, *args, **kwargs):
        if self._deferred:
            self._finish_deferred(args, kwargs)
        kind = self._forward_kind
        if kind == "tensor":
            if _has(args, kwargs, NDArray):
                with torch.set_grad_enabled(autograd.is_recording()):
                    out = super().__call__(*_unwrap(args),
                                           **{k: _unwrap(v)
                                              for k, v in kwargs.items()})
                return _wrap(out)
        elif kind == "ndarray":
            if _has(args, kwargs, torch.Tensor):
                out = super().__call__(*_wrap(args),
                                       **{k: _wrap(v)
                                          for k, v in kwargs.items()})
                return _unwrap(out)
        return super().__call__(*args, **kwargs)

    # -- introspection -----------------------------------------------------------
    def summary(self, *inputs):
        """Print each block's output shape and parameter count."""
        rows, handles = [], []

        def hook_factory(name):
            def hook(blk, args, out):
                o = out[0] if isinstance(out, (tuple, list)) else out
                n = sum(math.prod(v.shape) for v in blk._parameters.values()
                        if v is not None and not v.is_meta)
                rows.append((name, type(blk).__name__,
                             tuple(getattr(o, "shape", ())), n))
            return hook

        for name, mod in self.named_modules():
            handles.append(nn.Module.register_forward_hook(
                mod, hook_factory(name or "(root)")))
        try:
            self(*inputs)
        finally:
            for h in handles:
                h.remove()
        header = f"{'Layer':<40}{'Type':<20}{'Output':<24}{'Params':<12}"
        lines = [header, "-" * len(header)]
        for name, typ, shape, n in rows:
            lines.append(f"{name:<40}{typ:<20}{str(shape):<24}{n:<12}")
        total = sum(p.var.numel() for p in self.collect_params().values())
        lines += ["-" * len(header), f"Total params: {total}"]
        print("\n".join(lines))


class HybridBlock(Block):
    """A block that the reference can trace into one program. Here
    `hybridize()` records its flags and the block stays eager, with the
    same values."""

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  inline_limit=None, backend=None, **kwargs):
        object.__setattr__(self, "_hybrid_active", bool(active))
        object.__setattr__(self, "_hybrid_config", dict(
            static_alloc=static_alloc, static_shape=static_shape, **kwargs))
        for child in self.children():
            if isinstance(child, HybridBlock):
                child.hybridize(active, static_alloc, static_shape)
        return self

    def optimize_for(self, x, *args, backend=None, **kwargs):
        self.hybridize()
        return self(x, *args)

    def export(self, path, epoch=0, remove_amp_cast=True):
        raise not_ported("HybridBlock.export (serialization)")


class SymbolBlock(Block):
    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        raise not_ported("SymbolBlock.imports (serialization)")
