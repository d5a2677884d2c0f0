"""mx.functional: function transforms over NDArray functions.

Counterpart of mxnet_tpu/functional.py, over torch.func where the
reference uses jax's transforms: `grad`, `value_and_grad`, `jacfwd`,
`jacrev` (`jacobian`), `hessian` and `vmap` take a Python function of
NDArrays (or lists / tuples of them) and return one that takes and
returns NDArrays, and they compose (grad(grad(f))). Inside a transform
the NDArray funnel records, so every op of the function is
differentiated; the training flag stays the caller's.

`jit` returns the function unchanged: the port runs eagerly, as
`hybridize()` does. `eval_shape` runs the function on the meta device
and returns ShapeDtypeStruct(shape, dtype) leaves.
"""
from __future__ import annotations

import collections
import functools

import torch
import torch.func

from . import autograd as _ag
from .base import MXNetError

__all__ = ["grad", "value_and_grad", "jacobian", "jacfwd", "jacrev",
           "hessian", "jit", "vmap", "eval_shape", "ShapeDtypeStruct"]

ShapeDtypeStruct = collections.namedtuple("ShapeDtypeStruct",
                                          ["shape", "dtype"])


def _nd_cls():
    from .ndarray.ndarray import NDArray
    return NDArray


def _map(tree, fn, kind):
    if isinstance(tree, kind):
        return fn(tree)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn, kind) for v in tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn, kind) for k, v in tree.items()}
    return tree


def _unwrap(tree):
    return _map(tree, lambda a: a._data, _nd_cls())


def _wrap(tree):
    return _map(tree, _nd_cls(), torch.Tensor)


def _functionalize(fn):
    """An NDArray function as a tensor function whose NDArray ops are
    recorded (so torch.func can differentiate them)."""

    @functools.wraps(fn)
    def tfn(*args, **kwargs):
        with _ag.record(train_mode=_ag.is_training()):
            return _unwrap(fn(*_wrap(args), **_wrap(kwargs)))

    return tfn


def _transform(make_tfn):
    def make(fn, *targs, **tkwargs):
        if not callable(fn):
            raise MXNetError("first argument must be a callable")
        tfn = make_tfn(_functionalize(fn), *targs, **tkwargs)

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            return _wrap(tfn(*_unwrap(args), **_unwrap(kwargs)))

        return wrapped

    return make


def grad(fn, argnums=0, has_aux=False):
    """d fn / d args[argnums]; fn returns a scalar NDArray (and aux with
    has_aux, returned as (grads, aux))."""
    return _transform(torch.func.grad)(fn, argnums=argnums, has_aux=has_aux)


def _value_and_grad(tfn, argnums=0, has_aux=False):
    gv = torch.func.grad_and_value(tfn, argnums=argnums, has_aux=has_aux)

    def vg(*args, **kwargs):
        g, v = gv(*args, **kwargs)
        return v, g   # the reference's (value, grads) order

    return vg


def value_and_grad(fn, argnums=0, has_aux=False):
    return _transform(_value_and_grad)(fn, argnums=argnums, has_aux=has_aux)


def jacfwd(fn, argnums=0):
    return _transform(torch.func.jacfwd)(fn, argnums=argnums)


def jacrev(fn, argnums=0):
    return _transform(torch.func.jacrev)(fn, argnums=argnums)


jacobian = jacrev


def hessian(fn, argnums=0):
    return _transform(torch.func.hessian)(fn, argnums=argnums)


def vmap(fn, in_axes=0, out_axes=0):
    return _transform(torch.func.vmap)(fn, in_dims=in_axes,
                                       out_dims=out_axes)


def jit(fn, static_argnums=()):
    """The function itself: the port runs eagerly (as hybridize())."""
    if not callable(fn):
        raise MXNetError("first argument must be a callable")
    return fn


def eval_shape(fn, *args, **kwargs):
    """Run fn on the meta device: ShapeDtypeStruct leaves, no compute."""
    from .ndarray.ndarray import np_dtype

    def meta(a):
        return a._data.to("meta") if not a._data.is_meta else a._data

    with torch.no_grad():
        out = _unwrap(fn(*_wrap(_map(args, meta, _nd_cls())),
                         **_wrap(_map(kwargs, meta, _nd_cls()))))
    return _map(out, lambda t: ShapeDtypeStruct(tuple(t.shape),
                                                np_dtype(t.dtype)),
                torch.Tensor)
