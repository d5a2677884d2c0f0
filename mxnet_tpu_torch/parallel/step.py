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
    jax.grad.

The parameters of `net` are the step's own (no copies), so
`sync_params()` has nothing to do. Not ported yet: `mesh`,
`compression` and `loss_scale`.
"""
from __future__ import annotations

import torch

from .. import rng as _rng
from ..base import MXNetError, not_ported

__all__ = ["TrainStep"]


class TrainStep:
    """One optimizer step per call.

    Usage:
        step = TrainStep(net, loss_fn, optimizer, n_net_inputs=4)
        loss = step(ids, token_types, valid_length, positions, labels)
    """

    def __init__(self, net, loss_fn, optimizer, mesh=None, loss_reduce="mean",
                 n_net_inputs=1, loss_scale=None, compression=None):
        if mesh is not None:
            raise not_ported("TrainStep over a device mesh")
        if compression is not None:
            raise not_ported("TrainStep gradient compression")
        if loss_scale is not None:
            raise not_ported("TrainStep loss scaling")
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
        with torch.no_grad():
            self._states = [optimizer.init_state_arrays_mp(p.detach())
                            for p in self._params]
        # the base of the per-step dropout generators comes from the
        # process-wide stream (rng.seed), as the reference's base key
        # comes from next_key()
        self._seed = int(torch.randint(0, 2 ** 62, (1,),
                                       generator=_rng.generator("cpu")))
        self._t = 0

    @property
    def step_count(self):
        return self._t

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

    def _update(self, t):
        opt = self.optimizer
        lr, wd = float(opt.learning_rate), float(opt.wd)
        with torch.no_grad():
            for p, states in zip(self._params, self._states):
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                opt.apply_arrays_mp(p, g, states,
                                    lr * getattr(p, "lr_mult", 1.0),
                                    wd * getattr(p, "wd_mult", 1.0), t)
                p.grad = None

    def __call__(self, *batch):
        """One step on `batch`; returns the loss (a float32 scalar
        tensor on the parameters' device, not synchronised)."""
        t = self._t + 1
        gen = _rng.step_generator(self._seed, t, self._params[0].device)
        for p in self._params:
            p.grad = None
        loss = self._forward_loss(batch, gen)
        loss.backward()
        self._update(t)
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
