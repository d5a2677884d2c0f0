"""Imperative autograd: record / pause scopes, backward, grad.

Counterpart of mxnet_tpu/autograd.py on torch's autograd. An op of the
NDArray funnel (ops/registry.py) runs with grad mode on only inside
`record()` and only when an input is tracked, so outside `record()` no
graph is built, as the reference records nothing there. A tracked leaf
is a tensor that requires grad: an NDArray after `attach_grad`, or a
gluon Parameter's torch parameter. Its grad_req ('write', 'add' or
'null') is the tensor's `_mx_grad_req` attribute ('write' by default
for a tensor that requires grad).

`backward` finds the leaves its heads reach by walking the autograd
graph, takes their gradients with `torch.autograd.grad` and writes them
itself: 'write' replaces a leaf's gradient at each call (in place, so
an NDArray holding it sees the new values), 'add' sums across calls,
'null' leaves are not tracked at all. torch's own accumulation into
`.grad` is never relied on. `backward(create_graph=True)` and
`grad(create_graph=True)` keep the gradients on the graph, so a second
`backward` gives second-order derivatives.

`Function` is the reference's custom differentiable function, over a
`torch.autograd.Function`: its forward and backward take and return
NDArrays.

Training mode: `is_training()` is the reference's flag (set by
`record(train_mode=True)` and `train_mode()`). The port's layers apply
dropout and batch statistics when `training_active(module)` holds: the
module is in train() mode (as `parallel.TrainStep` sets it) or the
autograd scope says training.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "backward",
           "grad", "mark_variables", "Function", "training_active",
           "grad_req_of", "get_symbol"]


class _State(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False


_state = _State()


def is_recording():
    return _state.recording


def is_training():
    return _state.training


def set_recording(flag):
    prev, _state.recording = _state.recording, bool(flag)
    return prev


def set_training(flag):
    prev, _state.training = _state.training, bool(flag)
    return prev


def training_active(module):
    """Whether `module` applies dropout and batch statistics: it is in
    train() mode, or the autograd scope is training."""
    return module.training or _state.training


class _Scope:
    def __init__(self, recording, training):
        self._rec = recording
        self._train = training

    def __enter__(self):
        self._prev = (_state.recording, _state.training)
        if self._rec is not None:
            _state.recording = self._rec
        if self._train is not None:
            _state.training = self._train
        return self

    def __exit__(self, *exc):
        _state.recording, _state.training = self._prev


def record(train_mode=True):
    """Scope in which NDArray ops build the autograd graph (parity:
    autograd.record)."""
    return _Scope(True, train_mode)


def pause(train_mode=False):
    return _Scope(False, train_mode)


def train_mode():
    return _Scope(None, True)


def predict_mode():
    return _Scope(None, False)


def grad_req_of(t):
    """The grad_req of a tensor: its `_mx_grad_req`, else 'write' if it
    requires grad and 'null' if not."""
    if not t.requires_grad:
        return "null"
    return getattr(t, "_mx_grad_req", "write")


def _as_list(heads, head_grads):
    from .ndarray.ndarray import NDArray
    if isinstance(heads, NDArray):
        heads = [heads]
        if isinstance(head_grads, NDArray):
            head_grads = [head_grads]
    heads = list(heads)
    if head_grads is None:
        head_grads = [None] * len(heads)
    head_grads = list(head_grads)
    if len(head_grads) != len(heads):
        raise MXNetError("head_grads length mismatch")
    outs, grads = [], []
    for h, hg in zip(heads, head_grads):
        t = h._data
        if not t.requires_grad:
            raise MXNetError("cannot differentiate: head is not on the graph "
                             "(was it computed under autograd.record()?)")
        outs.append(t)
        grads.append(torch.ones_like(t) if hg is None
                     else hg._data.to(t.dtype))
    return outs, grads


def _leaves(outs):
    """The leaf tensors that require grad and that `outs` reach, each
    once, in the order the walk meets them."""
    found, seen_t = [], set()
    stack, seen = [], set()
    for t in outs:
        if t.grad_fn is None:
            if id(t) not in seen_t:
                seen_t.add(id(t))
                found.append(t)
        else:
            stack.append(t.grad_fn)
    while stack:
        fn = stack.pop()
        if fn in seen:
            continue
        seen.add(fn)
        var = getattr(fn, "variable", None)
        if var is not None:
            if id(var) not in seen_t:
                seen_t.add(id(var))
                found.append(var)
            continue
        for nxt, _ in fn.next_functions:
            if nxt is not None and nxt not in seen:
                stack.append(nxt)
    return found


def _write_grad(leaf, g, req, create_graph):
    old = leaf.grad
    if not create_graph:
        g = g.detach()
    if req == "add" and old is not None:
        if create_graph or old.requires_grad:
            leaf.grad = old + g
        else:
            old.add_(g)
    elif old is not None and not create_graph and not old.requires_grad \
            and old.shape == g.shape and old.dtype == g.dtype:
        old.copy_(g)
    else:
        leaf.grad = g


def _run_grad(outs, inputs, grads, retain_graph, create_graph):
    try:
        return torch.autograd.grad(outs, inputs, grads,
                                   retain_graph=retain_graph,
                                   create_graph=create_graph,
                                   allow_unused=True)
    except RuntimeError as e:
        if "second time" in str(e) or "already been freed" in str(e):
            raise MXNetError(
                "the graph was already consumed; pass retain_graph=True to "
                "backward() to keep it (parity: MXNet frees the graph "
                "after backward)") from e
        raise


def backward(heads, head_grads=None, retain_graph=False, train_mode=True,
             create_graph=False):
    """Gradients of `heads` into every leaf they reach, by its grad_req
    (parity: mx.autograd.backward). head_grads None means ones."""
    outs, grads = _as_list(heads, head_grads)
    leaves = [t for t in _leaves(outs) if grad_req_of(t) != "null"]
    if not leaves:
        return
    with _Scope(None, train_mode):
        gs = _run_grad(outs, leaves, grads, retain_graph or create_graph,
                       create_graph)
    with torch.no_grad() if not create_graph else torch.enable_grad():
        for leaf, g in zip(leaves, gs):
            if g is not None:
                _write_grad(leaf, g, grad_req_of(leaf), create_graph)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of `heads` with respect to `variables`, returned rather
    than written (parity: mx.autograd.grad). create_graph=True keeps
    them on the graph."""
    from .ndarray.ndarray import NDArray
    if retain_graph is None:
        retain_graph = create_graph
    single = isinstance(variables, NDArray)
    variables = [variables] if single else list(variables)
    outs, grads = _as_list(heads, head_grads)
    ins = [v._data for v in variables]
    for t in ins:
        if not t.requires_grad:
            raise MXNetError("grad: a variable is not tracked (attach_grad "
                             "it first)")
    with _Scope(None, train_mode):
        gs = _run_grad(outs, ins, grads, bool(retain_graph), create_graph)
    res = [NDArray(torch.zeros_like(t) if g is None else g)
           for t, g in zip(ins, gs)]
    return res[0] if single else res


def mark_variables(variables, gradients, grad_reqs="write"):
    """Parity: autograd.mark_variables: each variable becomes a tracked
    leaf whose gradient buffer is the given NDArray's tensor."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, r in zip(variables, gradients, grad_reqs):
        t = v._data.detach()
        if r != "null":
            t.requires_grad_(True)
            t.grad = g._data
        t._mx_grad_req = r
        v._data = t


def get_symbol(x):
    raise MXNetError("autograd.get_symbol has no counterpart: the graph is "
                     "torch's autograd graph, not an nnvm symbol")


class _Bridge(torch.autograd.Function):
    """Runs a `Function`'s NDArray forward and backward as one node of
    torch's graph."""

    @staticmethod
    def forward(ctx, func, inputs, nd_pos, *tensors):
        from .ndarray.ndarray import NDArray
        args = list(inputs)
        for i, t in zip(nd_pos, tensors):
            args[i] = NDArray(t)
        with pause():
            out = func.forward(*args)
        single = isinstance(out, NDArray)
        outs = (out,) if single else tuple(out)
        ctx.func, ctx.nd_pos, ctx.n_in = func, nd_pos, len(inputs)
        func._single = single
        return tuple(o._data for o in outs)

    @staticmethod
    def backward(ctx, *out_grads):
        from .ndarray.ndarray import NDArray
        func = ctx.func
        scope = record() if torch.is_grad_enabled() else pause()
        with scope:
            in_grads = func.backward(*[NDArray(g) for g in out_grads])
        if isinstance(in_grads, NDArray):
            in_grads = (in_grads,)
        if len(in_grads) != ctx.n_in:
            raise MXNetError(f"{type(func).__name__}.backward returned "
                             f"{len(in_grads)} grads for {ctx.n_in} inputs")
        return (None, None, None) + tuple(
            None if in_grads[i] is None else in_grads[i]._data
            for i in ctx.nd_pos)


class Function:
    """User-defined differentiable function (parity: mx.autograd.Function):
    subclass it and implement forward(self, *inputs) and
    backward(self, *output_grads) over NDArrays."""

    def __init__(self):
        self._saved = None
        self._single = True

    def save_for_backward(self, *arrays):
        self._saved = arrays

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray
        nd_pos = tuple(i for i, a in enumerate(inputs)
                       if isinstance(a, NDArray))
        tensors = [inputs[i]._data for i in nd_pos]
        rec = _state.recording and any(t.requires_grad for t in tensors)
        with torch.set_grad_enabled(rec):
            outs = _Bridge.apply(self, inputs, nd_pos, *tensors)
        outs = tuple(NDArray(o) for o in outs)
        return outs[0] if self._single else outs
