"""Control-flow ops: foreach, while_loop and cond.

Counterpart of mxnet_tpu/ops/control_flow.py (the reference's
src/operator/control_flow.cc behind mx.nd.contrib). Where the JAX
package lowers a body to lax.scan / lax.while_loop / lax.cond, here
each runs eagerly as a Python loop over NDArray ops, so every op of the
body goes through the funnel and, under `autograd.record()`, into the
graph: gradients reach the data, the states and the parameters the body
captures.

  * `foreach(body, data, init_states)` stacks each step's outputs along
    a new axis 0;
  * `while_loop(cond, func, loop_vars, max_iterations)` needs
    max_iterations (the reference's static-shape contract) and returns
    the outputs of the steps actually run, as the reference does when
    called eagerly;
  * `cond(pred, then_func, else_func)` runs only the taken branch.
"""
from __future__ import annotations

from .. import autograd as _ag
from ..base import MXNetError

__all__ = ["foreach", "while_loop", "cond"]


def _nd():
    from ..ndarray.ndarray import NDArray
    return NDArray


def _stack(steps):
    """Per-step outputs (each an NDArray or a list of them) stacked
    along a new axis 0, in the outputs' structure."""
    from .tensor import stack
    first = steps[0]
    if isinstance(first, (list, tuple)):
        return type(first)(stack([s[i] for s in steps])
                           for i in range(len(first)))
    return stack(steps)


def _empty_like(out, n):
    """The stacked outputs of zero steps, from one step's structure."""
    from .init import zeros
    NDArray = _nd()
    if isinstance(out, (list, tuple)):
        return type(out)(_empty_like(o, n) for o in out)
    return zeros((n,) + out.shape, ctx=_ctx(out), dtype=out.dtype) \
        if isinstance(out, NDArray) else out


def _ctx(a):
    from ..device import from_torch_device
    return from_torch_device(a._data.device)


def foreach(body, data, init_states):
    """Run `body` over the axis-0 slices of `data`, threading the states.

    body(data_slice, states) -> (outputs, new_states); data is an
    NDArray or a list of them (sliced in lockstep); states and outputs
    are NDArrays or lists. Returns (outputs stacked along axis 0, final
    states)."""
    multi = isinstance(data, (list, tuple))
    n = (data[0] if multi else data).shape[0]
    states, outs = init_states, []
    for i in range(n):
        x = [d[i] for d in data] if multi else data[i]
        out, states = body(x, states)
        outs.append(out)
    if not outs:
        raise MXNetError("foreach over an empty data axis")
    if isinstance(outs[0], (list, tuple)) and not outs[0]:
        return type(outs[0])(), states
    return _stack(outs), states


def while_loop(cond, func, loop_vars, max_iterations=None):
    """Call func while cond holds, at most max_iterations times.

    cond(*loop_vars) -> a boolean scalar; func(*loop_vars) ->
    (step_output, new_loop_vars). Returns (the step outputs stacked
    along axis 0, the final loop vars as a list)."""
    if max_iterations is None:
        raise MXNetError("while_loop requires max_iterations (the "
                         "reference's static-shape contract)")
    max_iterations = int(max_iterations)
    loop_vars = list(loop_vars)
    outs = []
    while len(outs) < max_iterations and bool(cond(*loop_vars)):
        out, new_vars = func(*loop_vars)
        outs.append(out)
        loop_vars = list(new_vars)
    if outs:
        return _stack(outs), loop_vars
    # no step ran: one step's outputs, computed and thrown away, give the
    # shapes (the reference traces the body once for them too)
    with _ag.pause(train_mode=_ag.is_training()):
        out, _ = func(*loop_vars)
    return _empty_like(out, 0), loop_vars


def cond(pred, then_func, else_func):
    """then_func() if pred else else_func(); only the taken branch runs
    (and records)."""
    return then_func() if bool(pred) else else_func()
