"""Trainer: applies an optimizer to a set of Parameters.

Counterpart of mxnet_tpu/gluon/trainer.py: `Trainer(params, optimizer,
optimizer_params, kvstore)` with `step` (allreduce, then the update with
`rescale_grad = scale / batch_size`), `update`, `allreduce_grads`,
`zero_grad`, `learning_rate` / `set_learning_rate` and `save_states` /
`load_states`. A dict of parameters is taken in sorted-name order, and
the updater's state indices follow that order; after its update a
'write' parameter's gradient is zeroed, as the reference does.

kvstore None, "device" or "local" reduce nothing (one process); any
other type is made by `kvstore.create` at the first step (with
`compression_params` set on it), and a store over a worker group
(`dist_sync` and its aliases, kvstore.py) pushpulls every gradient
across the workers before the update; "dist_async" raises there. With `amp.init_trainer`, `step` also
divides by the loss scale (unless `amp.unscale` already did), and for a
scaler that is not a no-op checks the gradients for overflow, adjusts
the scale, and on overflow zeroes the gradients and skips the update.
The telemetry instruments are the reference's: `trainer_step_seconds`,
`trainer_steps_total`, `trainer_amp_skipped_steps_total`,
`trainer_nonfinite_steps_total` (the NaN/Inf sentinel, armed by
`telemetry.flight.install(watch_trainer=True)`), the eager step's host
wall under `cost.note_dispatch("trainer.step", ...)` and the optimizer
state in the HBM ledger.
"""
from __future__ import annotations

import itertools
import math
import time

import torch

from .. import optimizer as _opt
from .. import telemetry
from ..base import MXNetError
from ..telemetry import cost as _cost
from ..telemetry import flight as _flight
from ..telemetry import ledger as _ledger
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]

# host wall of the eager step (the update kernels are queued, not
# waited for): the signal of a host-bound training loop
_step_seconds = telemetry.histogram(
    "trainer_step_seconds", "eager Trainer.step host wall time")
_steps_total = telemetry.counter(
    "trainer_steps_total", "eager Trainer.step calls")
_updates_skipped = telemetry.counter(
    "trainer_amp_skipped_steps_total",
    "steps skipped by dynamic loss scaling on gradient overflow")
_nonfinite_steps = telemetry.counter(
    "trainer_nonfinite_steps_total",
    "steps whose global gradient norm was NaN/Inf (flight-recorder "
    "sentinel; the update still applies)")

_trainer_ids = itertools.count()


def _grad_norm_sq(params):
    total = None
    for p in params:
        g = p.var.grad
        if p.grad_req == "null" or g is None:
            continue
        n = torch.sum(torch.square(g.float()))
        total = n if total is None else total + n
    return 0.0 if total is None else float(total)


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = [params[k] for k in sorted(params.keys())]
        if not isinstance(params, (list, tuple)):
            raise MXNetError("first argument must be a list/dict of "
                             f"Parameters, got {type(params)}")
        self._params = []
        self._param2idx = {}
        for i, p in enumerate(params):
            if not isinstance(p, Parameter):
                raise MXNetError(f"invalid parameter {p!r}")
            self._params.append(p)
            self._param2idx[p.name] = i
        self._scale = 1.0
        self._kvstore_type = kvstore
        self._compression_params = compression_params
        self._kvstore = None
        self._kv_initialized = False
        self._kv_inited_keys = set()
        self._update_on_kvstore = update_on_kvstore
        self._init_optimizer(optimizer, optimizer_params or {})
        _ledger.register(f"trainer/{next(_trainer_ids)}", self._hbm_ledger)

    def _hbm_ledger(self):
        def leaves(s, out):
            if isinstance(s, (tuple, list)):
                for x in s:
                    leaves(x, out)
            elif s is not None and hasattr(s, "_data"):
                out.append(s._data)
            return out

        arrays = []
        for state in self._updaters.states.values():
            leaves(state, arrays)
        return {"optimizer_state": arrays}

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, _opt.Optimizer):
            if optimizer_params:
                raise MXNetError("optimizer_params must be empty when "
                                 "optimizer is an Optimizer instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = _opt.create(optimizer, param_dict=param_dict,
                                          **optimizer_params)
        self._updaters = _opt.get_updater(self._optimizer)

    @property
    def optimizer(self):
        return self._optimizer

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr):
        self._optimizer.learning_rate = lr

    # -- the step ------------------------------------------------------------
    def step(self, batch_size, ignore_stale_grad=False):
        """allreduce (nothing on one device) and the update with the
        gradients scaled by 1 / batch_size (and 1 / the amp loss scale)."""
        t0 = time.perf_counter()
        scaler = getattr(self, "_amp_loss_scaler", None)
        scale = self._scale / batch_size
        if scaler is not None:
            if not getattr(scaler, "_unscaled", False):
                scale /= scaler.loss_scale
            scaler._unscaled = False
        self._optimizer.rescale_grad = scale
        try:
            self.allreduce_grads()
            if scaler is not None and not scaler.is_noop:
                overflow = scaler.has_overflow(
                    [p for p in self._params if p.grad_req != "null"])
                scaler.update_scale(overflow)
                if overflow:
                    self.zero_grad()
                    _updates_skipped.inc()
                    return
            # the NaN/Inf sentinel runs after the amp check: loss scaling
            # expects overflows, a non-finite norm here is an anomaly
            if _flight.trainer_sentinel_enabled():
                norm_sq = _grad_norm_sq(self._params)
                if not math.isfinite(norm_sq):
                    _nonfinite_steps.inc()
                    _flight.trigger("trainer_nonfinite",
                                    {"grad_norm_sq": norm_sq,
                                     "step": int(_steps_total.value) + 1,
                                     "num_params": len(self._params)})
            self._update(ignore_stale_grad)
        finally:
            _steps_total.inc()
            dt = time.perf_counter() - t0
            _step_seconds.observe(dt)
            _cost.note_dispatch("trainer.step", dt)

    def allreduce_grads(self):
        """Sum every gradient across the kvstore's workers (in place), when
        the Trainer has a worker-group store; nothing otherwise."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._kvstore is None:
            return
        for i, p in enumerate(self._params):
            if p.grad_req == "null":
                continue
            if i not in self._kv_inited_keys:
                # the reference's Trainer init()s each key before its
                # first pushpull
                self._kvstore.init(i, p.data())
                self._kv_inited_keys.add(i)
            self._kvstore.pushpull(i, p.grad(), out=p.grad())

    def _init_kvstore(self):
        """The reference's `_init_kvstore`: a store for any type but None /
        "device" / "local", kept when it spans a worker group (a group of
        one worker too: its all_reduce is the identity, on the group's
        backend)."""
        from .. import kvstore as kv
        self._kvstore = None
        self._kv_inited_keys = set()
        kvt = self._kvstore_type
        if kvt not in (None, "device", "local"):
            store = kvt if isinstance(kvt, kv.KVStore) else kv.create(kvt)
            if self._compression_params:
                store.set_gradient_compression(self._compression_params)
            if store.num_workers > 1 or getattr(store, "_group", False):
                self._kvstore = store
        self._kv_initialized = True

    def update(self, batch_size, ignore_stale_grad=False):
        """The update without allreduce."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        for i, p in enumerate(self._params):
            if p.grad_req == "null":
                continue
            if p.var.is_meta:
                if ignore_stale_grad:
                    continue
                raise MXNetError(f"parameter {p.name} has not been "
                                 "initialized")
            self._updaters(i, p.grad(), p.data())
            if p.grad_req == "write":
                p.zero_grad()

    def zero_grad(self):
        for p in self._params:
            p.zero_grad()

    # -- state persistence -----------------------------------------------------
    def save_states(self, fname):
        with open(fname, "wb") as f:
            f.write(self._updaters.get_states(dump_optimizer=True))

    def load_states(self, fname):
        with open(fname, "rb") as f:
            self._updaters.set_states(f.read())
        self._optimizer = self._updaters.optimizer
        self._optimizer.param_dict = dict(enumerate(self._params))
