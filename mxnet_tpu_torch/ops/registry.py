"""Operator registry and the NDArray funnel.

Counterpart of mxnet_tpu/ops/registry.py. `@op(name)` turns a function
over tensors into an op that also takes NDArrays. `apply_op` is the one
funnel: it unwraps NDArrays (positional, keyword, and one level of
lists or tuples), runs the torch function, and wraps the results as
NDArrays (int64 / float64 results narrowed to int32 / float32, as the
reference's JAX runs without 64-bit types). Grad mode is on only when
`autograd.is_recording()` and an input is tracked, so outside `record()`
no graph is built. A call with no NDArray argument runs the function as
it is: a call with tensors returns tensors (the port's own modules call
these functions that way), and a creation op (no array input at all)
returns NDArrays.

The registry lists every op by lower-cased name, as the reference's
does, and `mx.nd.<name>` is generated from it (ndarray/__init__.py). An
op of the reference that the port lacks is registered by `not_ported_op`
and raises `not_ported` by its name.
"""
from __future__ import annotations

import functools

import torch

from .. import autograd as _ag
from ..base import MXNetError, not_ported

__all__ = ["OPS", "op", "apply_op", "get_op", "not_ported_op", "Registry"]


class Registry:
    """name -> object, keys lower-cased (parity: mxnet_tpu.base.Registry)."""

    def __init__(self, kind):
        self.kind = kind
        self._map = {}

    def register(self, name=None, *, aliases=()):
        def _do(obj, name=name):
            if name is None:
                name = obj.__name__.lower()
            key = name.lower()
            if key in self._map and self._map[key] is not obj:
                raise MXNetError(f"duplicate {self.kind} registration: "
                                 f"{name}")
            self._map[key] = obj
            for a in aliases:
                self._map[a.lower()] = obj
            return obj

        if callable(name) and not isinstance(name, str):
            return _do(name, None)
        return _do

    def get(self, name):
        try:
            return self._map[name.lower()]
        except KeyError:
            raise MXNetError(f"unknown {self.kind} '{name}'; registered: "
                             f"{sorted(self._map)}") from None

    def create(self, name, *args, **kwargs):
        return self.get(name)(*args, **kwargs)

    def __contains__(self, name):
        return name.lower() in self._map

    def keys(self):
        return sorted(self._map)


OPS = Registry("operator")

_NARROW = {torch.int64: torch.int32, torch.float64: torch.float32,
           torch.complex128: torch.complex64}


def _nd():
    from ..ndarray.ndarray import NDArray
    return NDArray


def _wrap(res, NDArray):
    if isinstance(res, (tuple, list)):
        return tuple(_wrap(r, NDArray) for r in res)
    if isinstance(res, torch.Tensor):
        d = _NARROW.get(res.dtype)
        return NDArray(res if d is None else res.to(d))
    return res


def apply_op(name, fn, arrays, out=None, nodiff=False):
    """fn(*tensors) on the NDArrays `arrays`, inside the funnel."""
    NDArray = _nd()
    datas = [a._data for a in arrays]
    rec = (not nodiff and _ag.is_recording()
           and any(d.requires_grad for d in datas))
    with torch.set_grad_enabled(rec):
        res = fn(*datas)
    if nodiff and isinstance(res, torch.Tensor):
        res = res.detach()
    res = _wrap(res, NDArray)
    if out is not None:
        _write_out(out, res)
        return out
    return res


def _write_out(out, result):
    NDArray = _nd()
    if isinstance(out, NDArray) and isinstance(result, NDArray):
        out._assign_from(result)
    elif isinstance(out, (tuple, list)) and isinstance(result, tuple):
        for o, r in zip(out, result):
            o._assign_from(r)
    else:
        raise MXNetError("mismatched out= structure")


def _has_nd(args, kwargs, NDArray):
    for a in args:
        if isinstance(a, NDArray):
            return True
        if isinstance(a, (list, tuple)):
            for e in a:
                if isinstance(e, NDArray):
                    return True
    for v in kwargs.values():
        if isinstance(v, NDArray):
            return True
    return False


def _has_tensor(args, kwargs):
    for a in args:
        if isinstance(a, torch.Tensor):
            return True
        if isinstance(a, (list, tuple)) and any(
                isinstance(e, torch.Tensor) for e in a):
            return True
    return any(isinstance(v, torch.Tensor) for v in kwargs.values())


def op(name=None, nodiff=False, register=True):
    """Decorator: fn over tensors becomes an op over NDArrays (see the
    module docstring). Non-array arguments are static parameters."""

    def deco(fn, name=name):
        if name is None:
            name = fn.__name__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            NDArray = _nd()
            out = kwargs.pop("out", None)
            if not _has_nd(args, kwargs, NDArray):
                if _has_tensor(args, kwargs):
                    return fn(*args, **kwargs)
                # a creation op: nothing to tape
                with torch.no_grad():
                    res = _wrap(fn(*args, **kwargs), NDArray)
                if out is not None:
                    _write_out(out, res)
                    return out
                return res
            arrays, slots = [], []
            for i, a in enumerate(args):
                if isinstance(a, NDArray):
                    slots.append(("arg", i, None))
                    arrays.append(a)
                elif isinstance(a, (list, tuple)) and any(
                        isinstance(e, NDArray) for e in a):
                    for j, e in enumerate(a):
                        if isinstance(e, NDArray):
                            slots.append(("seq", i, j))
                            arrays.append(e)
            for k, v in kwargs.items():
                if isinstance(v, NDArray):
                    slots.append(("kw", k, None))
                    arrays.append(v)

            def closed(*datas):
                full = list(args)
                kw = dict(kwargs)
                seqs = {}
                for (kind, i, j), d in zip(slots, datas):
                    if kind == "arg":
                        full[i] = d
                    elif kind == "kw":
                        kw[i] = d
                    else:
                        seqs.setdefault(i, list(args[i]))[j] = d
                for i, elems in seqs.items():
                    full[i] = type(args[i])(elems) \
                        if isinstance(args[i], tuple) else elems
                return fn(*full, **kw)

            return apply_op(name, closed, arrays, out=out, nodiff=nodiff)

        wrapper.op_name = name
        wrapper.raw_fn = fn
        if register:
            OPS.register(name)(wrapper)
        return wrapper

    return deco


def not_ported_op(name):
    """Register reference op `name` as one the port does not have yet:
    calling it raises `not_ported`."""

    def fn(*args, **kwargs):
        raise not_ported(f"op {name}")

    fn.__name__ = name
    fn.op_name = name
    fn.not_ported = True
    OPS.register(name)(fn)
    return fn


def get_op(name):
    return OPS.get(name)
