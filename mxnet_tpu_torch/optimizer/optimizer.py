"""Optimizers.

Counterpart of mxnet_tpu/optimizer/optimizer.py: the `Optimizer` base
(rescale_grad, clip_gradient, lr / wd and their per-parameter
multipliers, an lr_scheduler, per-index update counts, multi_precision)
and its registry (`register` / `create`) with every optimizer of the
reference: SGD, NAG, Adam, AdamW (`correct_bias`), Adagrad, AdaDelta,
RMSProp (plain and centered), Ftrl, Signum, LARS, LAMB, DCASGD and SGLD.

Two interfaces, as in the reference:
  * the eager `update(index, weight, grad, state)` /
    `update_multi_precision(...)` the gluon Trainer calls through an
    Updater, over NDArrays. Each rule is the reference's jitted kernel
    written as plain PyTorch on the weight's tensor, in the same order
    of operations; the weight and its states are written in place.
    Multi-tensor update kernels are later `perf_opt` work.
  * the functional `init_state_arrays` / `apply_arrays` (and the
    multi-precision `*_mp` layout, a float32 master copy first in the
    state of every bfloat16/float16 weight) that `parallel.TrainStep`
    uses: SGD, Adam, AdamW and LAMB (`fused_supported`). Unlike the
    reference's pure functions these update in place and return the
    weight and states: the step owns its buffers, as the reference's
    step donates its own.

SGLD's noise comes from the port's generator of the weight's device,
not the reference's jax.random stream (rng.py).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..base import MXNetError
from ..ops.registry import Registry

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdamW", "Adagrad",
           "AdaDelta", "RMSProp", "Ftrl", "Signum", "LARS", "LAMB",
           "DCASGD", "SGLD", "Test", "create", "register"]

_REG = Registry("optimizer")
register = _REG.register

_BIG = 1e30      # "no clipping": the reference's kernels clip at this


def create(name, **kwargs):
    """The optimizer registered under `name`."""
    return _REG.create(name, **kwargs)


def _om(x):
    """1 - x in float32, as the reference's jitted update kernels take it
    (their hyperparameters arrive as float32 scalars)."""
    return float(np.float32(1) - np.float32(x))


def _clip(g, clip_gradient):
    if clip_gradient is not None and clip_gradient > 0:
        return g.clamp(-clip_gradient, clip_gradient)
    return g


def _t(x):
    """The tensor of an NDArray (or a tensor)."""
    return getattr(x, "_data", x)


def _zeros(weight):
    from ..ndarray.ndarray import NDArray
    return NDArray(torch.zeros_like(_t(weight)))


def _set(dst, value):
    """Write `value` into the array `dst` in place."""
    t = _t(dst)
    t.copy_(value)
    if hasattr(dst, "_version") and not isinstance(dst, torch.Tensor):
        dst._version += 1


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
    # the update reads the whole parameter (LAMB's trust ratio): a mesh
    # step applies it to the whole tensor, never to a stored block
    whole_tensor_update = False
    _MP_DTYPES = (torch.bfloat16, torch.float16)

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=None, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None, aggregate_num=0, use_fused_step=True):
        self.rescale_grad = rescale_grad
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.lr_scheduler = lr_scheduler
        self._learning_rate = learning_rate if learning_rate is not None \
            else 0.01
        if lr_scheduler is not None and learning_rate is not None:
            lr_scheduler.base_lr = learning_rate
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.multi_precision = multi_precision
        self.idx2name = dict(param_idx2name or {})
        self.param_dict = param_dict or {}
        self.lr_mult = {}
        self.wd_mult = {}
        self.aggregate_num = aggregate_num

    @staticmethod
    def create_optimizer(name, **kwargs):
        return create(name, **kwargs)

    # -- lr / wd ---------------------------------------------------------------
    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self._learning_rate

    @learning_rate.setter
    def learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise MXNetError("cannot set learning_rate directly when "
                             "lr_scheduler is set")
        self._learning_rate = lr

    def set_learning_rate(self, lr):
        self.learning_rate = lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = dict(args_wd_mult)

    def _get_lr(self, index):
        lr = self.learning_rate
        p = self.param_dict.get(index)
        if p is not None:
            return lr * p.lr_mult
        return lr * self.lr_mult.get(self.idx2name.get(index, index), 1.0)

    def _get_wd(self, index):
        p = self.param_dict.get(index)
        if p is not None:
            return self.wd * p.wd_mult
        return self.wd * self.wd_mult.get(self.idx2name.get(index, index),
                                          1.0)

    def _update_count(self, index):
        self._index_update_count.setdefault(index, self.begin_num_update)
        self._index_update_count[index] += 1
        self.num_update = max(self.num_update,
                              self._index_update_count[index])

    def _index_t(self, index):
        return self._index_update_count.get(index, self.begin_num_update)

    def _clipval(self):
        return self.clip_gradient if self.clip_gradient else _BIG

    def _grad(self, g, w):
        """The rescaled and clipped gradient in the weight's dtype."""
        c = self._clipval()
        g = g * self.rescale_grad
        # a bound the dtype cannot hold (float16 at _BIG) clips nothing,
        # as the reference's weakly typed bound turns to inf there
        if c <= torch.finfo(g.dtype).max:
            g = g.clamp(-c, c)
        return g.to(w.dtype)

    # -- eager interface ---------------------------------------------------------
    def create_state(self, index, weight):
        return None

    def create_state_multi_precision(self, index, weight):
        from ..ndarray.ndarray import NDArray
        if self.multi_precision and _t(weight).dtype in self._MP_DTYPES:
            master = NDArray(_t(weight).float())
            return (master, self.create_state(index, master))
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def update_multi_precision(self, index, weight, grad, state):
        w = _t(weight)
        if self.multi_precision and isinstance(state, tuple) and state \
                and state[0] is not None and hasattr(state[0], "_data") \
                and state[0]._data.dtype == torch.float32 \
                and w.dtype in self._MP_DTYPES:
            from ..ndarray.ndarray import NDArray
            master, inner = state
            self.update(index, master, NDArray(_t(grad).float()), inner)
            with torch.no_grad():
                _set(weight, master._data.to(w.dtype))
            return
        self.update(index, weight, grad, state)

    def update_multi(self, indices, weights, grads, states):
        for i, w, g, s in zip(indices, weights, grads, states):
            self.update_multi_precision(i, w, g, s)

    # -- functional interface (parallel.TrainStep) -------------------------------
    def init_state_arrays(self, w):
        raise MXNetError(f"{type(self).__name__} has no functional update "
                         "for the training step; use the gluon Trainer or "
                         "SGD / Adam / AdamW / LAMB")

    def apply_arrays(self, w, g, states, lr, wd, t):
        """Updates w and states in place; returns (w, states)."""
        raise MXNetError(f"{type(self).__name__} has no functional update")

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


def _eager(fn):
    """An update rule: count the update, then run under no_grad."""
    @functools.wraps(fn)
    def update(self, index, weight, grad, state):
        self._update_count(index)
        with torch.no_grad():
            fn(self, index, weight, grad, state)
    return update


@register("sgd")
class SGD(Optimizer):
    """SGD with optional momentum: with momentum mu, mom = mu * mom -
    lr * (g + wd * w), then w += mom; without it, w -= lr * (g + wd *
    w)."""

    fused_supported = True

    def __init__(self, learning_rate=0.01, momentum=0.0, lazy_update=False,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return _zeros(weight) if self.momentum != 0.0 else None

    @_eager
    def update(self, index, weight, grad, state):
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = _t(weight)
        g = self._grad(_t(grad), w)
        if self.momentum == 0.0:
            _set(weight, w - lr * (g + wd * w))
            return
        mom = self.momentum * _t(state) - lr * (g + wd * w)
        _set(state, mom)
        _set(weight, w + mom)

    def init_state_arrays(self, w):
        return (torch.zeros_like(w),) if self.momentum != 0.0 else ()

    def apply_arrays(self, w, g, states, lr, wd, t):
        g = _clip(g * self.rescale_grad, self.clip_gradient).to(w.dtype)
        step = w.mul(wd).add_(g).mul_(lr)
        if self.momentum == 0.0:
            return w.sub_(step), ()
        (mom,) = states
        mom.mul_(self.momentum).sub_(step)
        return w.add_(mom), (mom,)


@register("nag")
class NAG(Optimizer):
    """Nesterov accelerated SGD."""

    def __init__(self, learning_rate=0.01, momentum=0.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return _zeros(weight)

    @_eager
    def update(self, index, weight, grad, state):
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = _t(weight)
        g = self._grad(_t(grad), w) + wd * w
        mom = self.momentum * _t(state) - lr * g
        _set(state, mom)
        _set(weight, w + self.momentum * mom - lr * g)


@functools.lru_cache(maxsize=64)
def _adam_step_size(lr, beta1, beta2, t):
    """lr * sqrt(1 - beta2**t) / (1 - beta1**t) in float32, the order the
    reference's traced step evaluates it."""
    f, tf = np.float32, np.float32(t)
    return float(f(lr) * np.sqrt(f(1) - f(beta2) ** tf)
                 / (f(1) - f(beta1) ** tf))


@register("adam")
class Adam(Optimizer):
    """Adam: g += wd * w (L2 decay in the gradient), m = b1*m + (1-b1)*g,
    v = b2*v + (1-b2)*g², w -= lr_t * m / (sqrt(v) + eps) with the bias
    correction in lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t)."""

    fused_supported = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=False, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    @_eager
    def update(self, index, weight, grad, state):
        t = self._index_t(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        b1, b2 = self.beta1, self.beta2
        lr_t = lr * math.sqrt(1 - b2 ** t) / (1 - b1 ** t)
        m, v = state
        w = _t(weight)
        g = self._grad(_t(grad), w) + wd * w
        nm = b1 * _t(m) + _om(b1) * g
        nv = b2 * _t(v) + _om(b2) * torch.square(g)
        _set(m, nm)
        _set(v, nv)
        _set(weight, w - lr_t * nm / (torch.sqrt(nv) + self.epsilon))

    def init_state_arrays(self, w):
        return (torch.zeros_like(w), torch.zeros_like(w))

    def apply_arrays(self, w, g, states, lr, wd, t):
        m, v = states
        b1, b2 = self.beta1, self.beta2
        lr_t = _adam_step_size(float(lr), b1, b2, int(t))
        g = _clip(g * self.rescale_grad, self.clip_gradient).to(w.dtype)
        g = (g + w.float() * wd).to(w.dtype)
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(g.square() * (1 - b2))
        w.sub_(m.float() * lr_t / (v.sqrt() + self.epsilon))
        return w, (m, v)


@register("adamw")
class AdamW(Optimizer):
    """AdamW with decoupled weight decay scaled by the learning rate
    (`eta` is the schedule multiplier); correct_bias=False drops the
    bias correction."""

    fused_supported = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, correct_bias=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.correct_bias = correct_bias
        self.eta = 1.0

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    @_eager
    def update(self, index, weight, grad, state):
        t = self._index_t(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        b1, b2 = self.beta1, self.beta2
        bc1 = 1 - b1 ** t if self.correct_bias else 1.0
        bc2 = 1 - b2 ** t if self.correct_bias else 1.0
        m, v = state
        w = _t(weight)
        g = self._grad(_t(grad), w)
        nm = b1 * _t(m) + _om(b1) * g
        nv = b2 * _t(v) + _om(b2) * torch.square(g)
        _set(m, nm)
        _set(v, nv)
        _set(weight, w - float(np.float32(self.eta) * np.float32(lr)) * (
            (nm / bc1) / (torch.sqrt(nv / bc2) + self.epsilon) + wd * w))

    def init_state_arrays(self, w):
        return (torch.zeros_like(w), torch.zeros_like(w))

    def apply_arrays(self, w, g, states, lr, wd, t):
        m, v = states
        b1, b2 = self.beta1, self.beta2
        bc1, bc2 = _bias_corrections(b1, b2, t) if self.correct_bias \
            else (1.0, 1.0)
        g = _clip(g * self.rescale_grad, self.clip_gradient).to(w.dtype)
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        denom = v.div(bc2).sqrt_().add_(self.epsilon)
        w.sub_(m.div(bc1).div_(denom).add_(w, alpha=wd)
               .mul_(self.eta * lr))
        return w, (m, v)


@register("adagrad")
class Adagrad(Optimizer):
    def __init__(self, learning_rate=0.01, eps=1e-7, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros(weight)

    @_eager
    def update(self, index, weight, grad, state):
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = _t(weight)
        g = self._grad(_t(grad), w) + wd * w
        h = _t(state) + torch.square(g)
        _set(state, h)
        _set(weight, w - lr * g / (torch.sqrt(h) + self.float_stable_eps))


@register("adadelta")
class AdaDelta(Optimizer):
    """AdaDelta (no learning rate, as the reference's)."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    @_eager
    def update(self, index, weight, grad, state):
        wd = self._get_wd(index)
        rho, eps = self.rho, self.epsilon
        acc_g, acc_d = state
        w = _t(weight)
        g = self._grad(_t(grad), w) + wd * w
        ng = rho * _t(acc_g) + _om(rho) * torch.square(g)
        d = torch.sqrt(_t(acc_d) + eps) / torch.sqrt(ng + eps) * g
        _set(acc_g, ng)
        _set(acc_d, rho * _t(acc_d) + _om(rho) * torch.square(d))
        _set(weight, w - d)


@register("rmsprop")
class RMSProp(Optimizer):
    def __init__(self, learning_rate=0.001, rho=0.9, momentum=0.9,
                 epsilon=1e-8, centered=False, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.rho, self.momentum = rho, momentum
        self.epsilon, self.centered = epsilon, centered

    def create_state(self, index, weight):
        if self.centered:
            return (_zeros(weight), _zeros(weight), _zeros(weight))
        return _zeros(weight)

    @_eager
    def update(self, index, weight, grad, state):
        lr, wd = self._get_lr(index), self._get_wd(index)
        rho = self.rho
        w = _t(weight)
        g = self._grad(_t(grad), w) + wd * w
        if not self.centered:
            n = rho * _t(state) + _om(rho) * torch.square(g)
            _set(state, n)
            _set(weight, w - lr * g / (torch.sqrt(n) + self.epsilon))
            return
        n_, gbar_, mom_ = state
        n = rho * _t(n_) + _om(rho) * torch.square(g)
        gbar = rho * _t(gbar_) + _om(rho) * g
        mom = self.momentum * _t(mom_) - lr * g / torch.sqrt(
            n - torch.square(gbar) + self.epsilon)
        _set(n_, n)
        _set(gbar_, gbar)
        _set(mom_, mom)
        _set(weight, w + mom)


@register("ftrl")
class Ftrl(Optimizer):
    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    @_eager
    def update(self, index, weight, grad, state):
        lr, wd = self._get_lr(index), self._get_wd(index)
        z_, n_ = state
        w = _t(weight)
        g = self._grad(_t(grad), w)
        n = _t(n_)
        new_n = n + torch.square(g)
        sigma = (torch.sqrt(new_n) - torch.sqrt(n)) / lr
        z = _t(z_) + g - sigma * w
        new_w = torch.where(
            torch.abs(z) > self.lamda1,
            -(z - torch.sign(z) * self.lamda1)
            / ((self.beta + torch.sqrt(new_n)) / lr + wd),
            torch.zeros((), dtype=w.dtype, device=w.device))
        _set(z_, z)
        _set(n_, new_n)
        _set(weight, new_w)


@register("signum")
class Signum(Optimizer):
    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum, self.wd_lh = momentum, wd_lh

    def create_state(self, index, weight):
        return _zeros(weight) if self.momentum != 0.0 else None

    @_eager
    def update(self, index, weight, grad, state):
        lr, wd = self._get_lr(index), self._get_wd(index)
        mu = self.momentum
        w = _t(weight)
        g = self._grad(_t(grad), w)
        old = _t(state) if state is not None else torch.zeros_like(w)
        mom = mu * old - _om(mu) * (g + wd * w)
        if state is not None:
            _set(state, mom)
        decay = float(np.float32(1) - np.float32(lr) * np.float32(self.wd_lh))
        _set(weight, decay * w + lr * torch.sign(mom))


@register("lars")
class LARS(SGD):
    """Layer-wise adaptive rate scaling: SGD at lr * eta * |w| / (|g| +
    wd * |w| + eps)."""

    def __init__(self, learning_rate=0.01, momentum=0.9, eta=0.001,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, momentum=momentum,
                         **kwargs)
        self.eta, self.epsilon = eta, epsilon

    def update(self, index, weight, grad, state):
        wd = self._get_wd(index)
        with torch.no_grad():
            w = _t(weight)
            g = self._grad(_t(grad), w)
            wn = float(torch.linalg.vector_norm(w.reshape(-1)))
            gn = float(torch.linalg.vector_norm(g.reshape(-1)))
        ratio = self.eta * wn / (gn + wd * wn + self.epsilon) \
            if wn > 0 and gn > 0 else 1.0
        saved_lr = self._learning_rate
        scaled = self._get_lr(index) * ratio
        try:
            if self.lr_scheduler is None:
                self._learning_rate = scaled
                super().update(index, weight, grad, state)
            else:
                name = self.idx2name.get(index, index)
                prev = self.lr_mult.get(name, 1.0)
                self.lr_mult[name] = prev * ratio
                try:
                    super().update(index, weight, grad, state)
                finally:
                    self.lr_mult[name] = prev
        finally:
            self._learning_rate = saved_lr


@register("lamb")
class LAMB(Optimizer):
    """LAMB: the Adam direction r = m̂ / (sqrt(v̂) + eps) + wd * w scaled
    by the trust ratio |w| / |r| (|w| clipped to [lower, upper])."""

    fused_supported = True
    whole_tensor_update = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound = lower_bound if lower_bound is not None else 0.0
        self.upper_bound = upper_bound if upper_bound is not None else _BIG
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def _step(self, w, g, m, v, lr, wd, bc1, bc2, norm_dtype):
        """The LAMB step on tensors, in place; `g` already rescaled,
        clipped and in w's dtype."""
        b1, b2 = self.beta1, self.beta2
        nm = b1 * m + _om(b1) * g
        nv = b2 * v + _om(b2) * torch.square(g)
        m.copy_(nm)
        v.copy_(nv)
        r = (nm / bc1) / (torch.sqrt(nv / bc2) + self.epsilon) + wd * w
        wnorm = torch.linalg.vector_norm(w.reshape(-1).to(norm_dtype))
        rnorm = torch.linalg.vector_norm(r.reshape(-1).to(norm_dtype))
        wnorm = wnorm.clamp(self.lower_bound, self.upper_bound)
        trust = torch.where((wnorm > 0) & (rnorm > 0), wnorm / rnorm,
                            torch.ones_like(wnorm))
        w.copy_(w - lr * trust * r)

    @_eager
    def update(self, index, weight, grad, state):
        t = self._index_t(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        bc1 = 1 - self.beta1 ** t if self.bias_correction else 1.0
        bc2 = 1 - self.beta2 ** t if self.bias_correction else 1.0
        m, v = state
        w = _t(weight)
        self._step(w, self._grad(_t(grad), w), _t(m), _t(v), lr, wd, bc1,
                   bc2, w.dtype)
        for a in (weight, m, v):
            if hasattr(a, "_version"):
                a._version += 1

    def init_state_arrays(self, w):
        return (torch.zeros_like(w), torch.zeros_like(w))

    def apply_arrays(self, w, g, states, lr, wd, t):
        m, v = states
        bc1, bc2 = _bias_corrections(self.beta1, self.beta2, t) \
            if self.bias_correction else (1.0, 1.0)
        g = _clip(g * self.rescale_grad, self.clip_gradient).to(w.dtype)
        self._step(w, g, m, v, lr, wd, bc1, bc2, torch.float32)
        return w, (m, v)


@register("dcasgd")
class DCASGD(Optimizer):
    """Delay-compensated SGD."""

    def __init__(self, learning_rate=0.01, momentum=0.0, lamda=0.04,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum, self.lamda = momentum, lamda

    def create_state(self, index, weight):
        from ..ndarray.ndarray import NDArray
        return (_zeros(weight) if self.momentum != 0 else None,
                NDArray(_t(weight).detach().clone()))

    @_eager
    def update(self, index, weight, grad, state):
        lr, wd = self._get_lr(index), self._get_wd(index)
        mom, prev_w = state
        w = _t(weight)
        g = _clip(_t(grad) * self.rescale_grad,
                  self.clip_gradient).to(w.dtype)
        g = g + wd * w + self.lamda * g * g * (w - _t(prev_w))
        if mom is None:
            new_w = w - lr * g
        else:
            nm = self.momentum * _t(mom) - lr * g
            _set(mom, nm)
            new_w = w + nm
        _set(prev_w, w)
        _set(weight, new_w)


@register("sgld")
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics: w - lr/2 * (g + wd * w) +
    N(0, lr) noise from the port's generator of w's device."""

    def _noise(self, w, lr):
        from .. import rng as _rng
        z = torch.randn(w.shape, dtype=w.dtype, device=w.device,
                        generator=_rng.generator(w.device))
        return z * math.sqrt(lr)

    @_eager
    def update(self, index, weight, grad, state):
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = _t(weight)
        g = _clip(_t(grad) * self.rescale_grad,
                  self.clip_gradient).to(w.dtype)
        _set(weight, w - lr / 2 * (g + wd * w) + self._noise(w, lr))


class Test(Optimizer):
    """Trivial optimizer used by tests (parity: optimizer.Test)."""

    def create_state(self, index, weight):
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        with torch.no_grad():
            _set(weight, _t(weight) - self.learning_rate * _t(grad)
                 * self.rescale_grad)
