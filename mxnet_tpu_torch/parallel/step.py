"""The training step: forward, loss, backward and optimizer update.

Counterpart of mxnet_tpu/parallel/step.py `TrainStep` without a mesh.
Where the reference compiles the whole step into one XLA program over
donated buffers, here it runs eagerly (`_make_core` at step.py:237 is the
model):

  * the forward runs in train() mode (dropout on) inside a generator
    scope seeded from (seed, t) — one torch.Generator per step, the
    counterpart of fold_in(base_key, t) — so each step's dropout masks
    and fused-attention seed words are a function of the step number;
  * batch[:n_net_inputs] goes to the net, its outputs and the rest of
    the batch to the loss, reduced by `loss_reduce` ("mean" or "sum");
  * loss.backward(), then under no_grad the optimizer's multi-precision
    update (`apply_arrays_mp`) with per-parameter `lr_mult`/`wd_mult`
    (attributes of the torch Parameter, default 1), which updates the
    parameters and states IN PLACE — the reference's donated buffers. A
    parameter the forward did not reach gets a zero gradient, as under
    jax.grad;
  * parameters that do not require grad (BatchNorm's running statistics,
    a fixed gamma; the reference's grad_req "null") are the step's
    non-trainable state: the optimizer never sees them, and the layers
    that own them update them inside the train()-mode forward, once a
    step (the reference returns them from the step program as aux
    values and writes them back).

Loss scaling (`loss_scale` a float, or "dynamic" with `scale_window`),
as the reference's step program does it and with no host sync: the
loss is multiplied by the scale before backward, and the gradients are
unscaled in float32 and cast back to their dtype. A dynamic step also
checks the gradients for inf / nan on the device (`ok`) and selects
with torch.where: on overflow every parameter, optimizer state (the
float32 masters among them) and non-trainable state the forward wrote
keeps its incoming value. The scale state (scale, clean steps) lives on
the device, starts at (2^16, 0), doubles after `scale_window` clean
steps (capped at 2^24) and halves on an overflow (floored at 1.0); the
step count advances either way.

The parameters of `net` are the step's own (no copies), so
`sync_params()` has nothing to do. `checkpoint.TrainCheckpoint` saves
and restores a step's whole state; a save asked for inside a call (a
signal handler's) waits for its end through `defer_to_step_end`. Not ported yet: `mesh` and
`compression`. `EvalStep` is the forward alone, in eval() mode.
"""
from __future__ import annotations

import torch

from .. import rng as _rng
from ..amp.loss_scaler import grads_finite
from ..base import MXNetError, not_ported

__all__ = ["TrainStep", "EvalStep"]

_MAX_SCALE = 2.0 ** 24


class TrainStep:
    """One optimizer step per call.

    Usage:
        step = TrainStep(net, loss_fn, optimizer, n_net_inputs=4)
        loss = step(ids, token_types, valid_length, positions, labels)
    """

    def __init__(self, net, loss_fn, optimizer, mesh=None, loss_reduce="mean",
                 n_net_inputs=1, loss_scale=None, scale_window=2000,
                 compression=None):
        if mesh is not None:
            raise not_ported("TrainStep over a device mesh")
        if compression is not None:
            raise not_ported("TrainStep gradient compression")
        if loss_reduce not in ("mean", "sum"):
            raise MXNetError(f"unknown loss_reduce {loss_reduce!r}")
        if not optimizer.fused_supported:
            raise MXNetError(
                f"{type(optimizer).__name__} has no functional update for "
                "the training step")
        self.net = net
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.loss_reduce = loss_reduce
        self.n_net_inputs = n_net_inputs
        self._params = [p for p in net.parameters() if p.requires_grad]
        if not self._params:
            raise MXNetError("TrainStep: the net has no trainable parameter")
        self._fixed = [p for p in net.parameters() if not p.requires_grad]
        dev = self._params[0].device
        self._dynamic_scale = loss_scale == "dynamic"
        self._static_scale = None if loss_scale in (None, "dynamic") \
            else float(loss_scale)
        self._scale_window = int(scale_window)
        # (scale, clean steps in a row) on the device
        self._scale_state = (
            torch.tensor(2.0 ** 16, dtype=torch.float32, device=dev),
            torch.zeros((), dtype=torch.int32, device=dev)) \
            if self._dynamic_scale else None
        self._static_scale_t = None if self._static_scale is None else \
            torch.tensor(self._static_scale, dtype=torch.float32, device=dev)
        with torch.no_grad():
            self._states = [optimizer.init_state_arrays_mp(p.detach())
                            for p in self._params]
        # the base of the per-step dropout generators comes from the
        # process-wide stream (rng.seed), as the reference's base key
        # comes from next_key()
        self._seed = int(torch.randint(0, 2 ** 62, (1,),
                                       generator=_rng.generator("cpu")))
        self._t = 0
        self._in_step = False
        self._at_step_end = None

    @property
    def step_count(self):
        return self._t

    def defer_to_step_end(self, fn):
        """Run fn(completed) once the running call has returned (completed
        True: the state is at a step boundary) or raised (False). A call
        changes the state in place, from the forward to the update, so a
        snapshot taken inside it would hold tensors of two steps; the
        preemption handler defers its save this way. Between calls, fn
        runs at once."""
        if not self._in_step:
            fn(True)
            return
        self._at_step_end = fn

    @property
    def loss_scale(self):
        """The dynamic scale (a host fetch), the static one, or None."""
        if self._scale_state is not None:
            return float(self._scale_state[0])
        return self._static_scale

    def _forward_loss(self, batch, gen):
        net, n = self.net, self.n_net_inputs
        was_training = net.training
        net.train()
        try:
            with _rng.generator_scope(gen):
                out = net(*batch[:n])
                outs = out if isinstance(out, tuple) else (out,)
                loss = self.loss_fn(*outs, *batch[n:])
        finally:
            net.train(was_training)
        loss = loss.mean() if self.loss_reduce == "mean" else loss.sum()
        return loss.float()

    def _update(self, t, ok=None):
        """The optimizer update in place; with `ok` (a device bool) each
        parameter and its states keep their incoming values where it is
        False."""
        opt = self.optimizer
        lr, wd = float(opt.learning_rate), float(opt.wd)
        with torch.no_grad():
            for p, states in zip(self._params, self._states):
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                olds = None if ok is None else \
                    [p.detach().clone()] + [s.clone() for s in states]
                opt.apply_arrays_mp(p, g, states,
                                    lr * getattr(p, "lr_mult", 1.0),
                                    wd * getattr(p, "wd_mult", 1.0), t)
                if olds is not None:
                    for new, old in zip((p, *states), olds):
                        torch.where(ok, new, old, out=new)
                p.grad = None

    def _unscale(self, scale):
        """Gradients times 1 / scale, computed in float32 and rounded to
        their dtype (the multiply's own arithmetic for bfloat16 and
        float16); returns `ok` (no gradient inf / nan) as a device bool."""
        grads = [p.grad for p in self._params if p.grad is not None]
        if not grads:
            return torch.ones((), dtype=torch.bool, device=scale.device)
        with torch.no_grad():
            torch._foreach_mul_(grads, torch.reciprocal(scale))
            return grads_finite(grads)

    def _next_scale_state(self, ok):
        scale, good = self._scale_state
        good = torch.where(ok, good + 1, torch.zeros_like(good))
        grow = good >= self._scale_window
        scale = torch.where(
            ok, torch.where(grow, torch.clamp(scale * 2.0, max=_MAX_SCALE),
                            scale),
            torch.clamp(scale * 0.5, min=1.0))
        return scale, torch.where(grow, torch.zeros_like(good), good)

    def __call__(self, *batch):
        """One step on `batch`; returns the loss (a float32 scalar
        tensor on the parameters' device, not synchronised)."""
        self._in_step = True
        try:
            loss = self._step(batch)
        except BaseException:
            self._end_step(False)
            raise
        self._end_step(True)
        return loss

    def _end_step(self, completed):
        self._in_step = False
        fn, self._at_step_end = self._at_step_end, None
        if fn is not None:
            fn(completed)

    def _step(self, batch):
        t = self._t + 1
        dev = self._params[0].device
        gen = _rng.step_generator(self._seed, t, dev)
        for p in self._params:
            p.grad = None
        if self._dynamic_scale:
            scale = self._scale_state[0]
            fixed = [p.detach().clone() for p in self._fixed]
        else:
            scale = self._static_scale_t
        loss = self._forward_loss(batch, gen)
        (loss if scale is None else loss * scale).backward()
        ok = None if scale is None else self._unscale(scale)
        if not self._dynamic_scale:
            ok = None
        else:
            # an overflowing forward must not poison BatchNorm's running
            # statistics either: they keep their incoming values
            with torch.no_grad():
                for p, old in zip(self._fixed, fixed):
                    torch.where(ok, p, old, out=p)
        self._update(t, ok)
        if ok is not None:
            self._scale_state = self._next_scale_state(ok)
        self._t = t
        self.optimizer.num_update = t
        return loss.detach()

    def run_steps(self, *stacked_batch, steps=None):
        """K steps: each argument carries a leading steps axis, or, with
        steps=K, the same batch is reused K times. Returns the (K,)
        losses."""
        if steps is None:
            if not stacked_batch or any(b.dim() < 1 for b in stacked_batch):
                raise MXNetError("run_steps needs batches with a leading "
                                 "steps axis (or pass steps=K)")
            k = stacked_batch[0].shape[0]
            if any(b.shape[0] != k for b in stacked_batch):
                raise MXNetError("run_steps: inconsistent steps axis")
            batches = [tuple(b[i] for b in stacked_batch) for i in range(k)]
        else:
            if int(steps) <= 0:
                raise MXNetError("run_steps: steps must be positive")
            batches = [stacked_batch] * int(steps)
        return torch.stack([self(*b) for b in batches])

    def sync_params(self):
        """The step updates the net's own parameters in place: nothing to
        write back."""


class EvalStep:
    """The forward alone, in eval() mode and without autograd (parity:
    mxnet_tpu.parallel.EvalStep without a mesh). Tensors in, tensors out;
    NDArrays in, NDArrays out."""

    def __init__(self, net, mesh=None, batch_specs=None):
        if mesh is not None:
            raise not_ported("EvalStep over a device mesh")
        self.net = net

    def __call__(self, *batch):
        from ..ndarray.ndarray import NDArray
        nd = any(isinstance(b, NDArray) for b in batch)
        args = [b._data if isinstance(b, NDArray) else b for b in batch]
        was_training = self.net.training
        self.net.eval()
        try:
            with torch.no_grad():
                out = self.net(*args)
        finally:
            self.net.train(was_training)
        if not nd:
            return out
        return tuple(NDArray(o) for o in out) if isinstance(out, tuple) \
            else NDArray(out)
