"""Optimizers: the update the training step applies.

Counterpart of mxnet_tpu/optimizer/optimizer.py `Optimizer` (rescale_grad,
clip_gradient, lr/wd, num_update) and `AdamW` (always bias-corrected),
through the functional interface `parallel.TrainStep` uses:
`init_state_arrays` / `apply_arrays` and the multi-precision layout
`init_state_arrays_mp` / `apply_arrays_mp` (a float32 master copy first
in the state of every bfloat16/float16 weight; float32 weights keep the
plain layout). Unlike the reference's pure functions, the port's
versions update the weight and its states IN PLACE and return them: the
step owns its buffers, as the reference's step donates its own.

Not ported yet: the eager `update()` path of the Trainer, learning-rate
schedulers and every other optimizer (`create` raises for them).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .base import not_ported

__all__ = ["Optimizer", "AdamW", "create"]


def _clip(g, clip_gradient):
    if clip_gradient is not None and clip_gradient > 0:
        return g.clamp(-clip_gradient, clip_gradient)
    return g


@functools.lru_cache(maxsize=64)
def _bias_corrections(beta1, beta2, t):
    """(1 - beta1**t, 1 - beta2**t) in float32, as the reference's traced
    step computes them; once per step, not once per parameter."""
    tf = np.float32(t)
    return (float(1 - np.float32(beta1) ** tf),
            float(1 - np.float32(beta2) ** tf))


class Optimizer:
    """Base optimizer (parity: mx.optimizer.Optimizer)."""

    fused_supported = False
    _MP_DTYPES = (torch.bfloat16, torch.float16)

    def __init__(self, rescale_grad=1.0, wd=0.0, clip_gradient=None,
                 learning_rate=None):
        self.rescale_grad = rescale_grad
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.learning_rate = learning_rate if learning_rate is not None \
            else 0.01
        self.num_update = 0

    def update(self, index, weight, grad, state):
        raise not_ported("the eager optimizer update (Trainer)")

    # -- functional interface -------------------------------------------
    def init_state_arrays(self, w):
        raise not_ported(f"{type(self).__name__}'s functional update")

    def apply_arrays(self, w, g, states, lr, wd, t):
        """Updates w and states in place; returns (w, states)."""
        raise not_ported(f"{type(self).__name__}'s functional update")

    def init_state_arrays_mp(self, w):
        if w.dtype in self._MP_DTYPES:
            master = w.float()
            return (master,) + tuple(self.init_state_arrays(master))
        return tuple(self.init_state_arrays(w))

    def apply_arrays_mp(self, w, g, states, lr, wd, t):
        if w.dtype in self._MP_DTYPES:
            self.apply_arrays(states[0], g.float(), tuple(states[1:]), lr,
                              wd, t)
            return w.copy_(states[0]), states
        return self.apply_arrays(w, g, states, lr, wd, t)

    def __repr__(self):
        return f"{type(self).__name__}(lr={self.learning_rate})"


class AdamW(Optimizer):
    """AdamW with decoupled weight decay scaled by the learning rate
    (parity: the reference's adamw; `eta` is the schedule multiplier)."""

    fused_supported = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.eta = 1.0

    def init_state_arrays(self, w):
        return (torch.zeros_like(w), torch.zeros_like(w))

    def apply_arrays(self, w, g, states, lr, wd, t):
        m, v = states
        b1, b2 = self.beta1, self.beta2
        bc1, bc2 = _bias_corrections(b1, b2, t)
        g = _clip(g * self.rescale_grad, self.clip_gradient).to(w.dtype)
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        denom = v.div(bc2).sqrt_().add_(self.epsilon)
        w.sub_(m.div(bc1).div_(denom).add_(w, alpha=wd)
               .mul_(self.eta * lr))
        return w, (m, v)


def create(name, **kwargs):
    """The optimizer registered under `name` (only "adamw" is ported)."""
    if name.lower() == "adamw":
        return AdamW(**kwargs)
    raise not_ported(f"optimizer {name!r}")
