"""Shared helpers of the gluon.nn layers: the reference's constructor
arguments on the port's layers, whose parameters start on the meta
device until `initialize()` (or the first call, for deferred shapes).
A gluon layer starts in eval() mode, so that, as in the reference, only
autograd's training flag turns its dropout and batch statistics on."""
from __future__ import annotations

from ...ndarray.ndarray import to_torch_dtype
from ..parameter import Parameter

META = "meta"


def dtype_of(dtype):
    return to_torch_dtype(dtype or "float32")


def gluon_mode(block):
    """eval() mode: autograd.training_active then follows autograd's
    training flag alone."""
    block.train(False)
    return block


def configure(block, **inits):
    """Each named parameter of `block` takes its initializer and may
    defer its shape; the block fills them at its first call."""
    for name, init in inits.items():
        var = getattr(block, name, None)
        if var is None:
            continue
        p = Parameter._of(var)
        p._name = name
        p.init = init
        p.allow_deferred_init = True
    object.__setattr__(block, "_deferred", True)
    gluon_mode(block)


def fill_shape(block, name, shape):
    Parameter._of(getattr(block, name)).shape = shape
