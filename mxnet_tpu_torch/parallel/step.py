"""The training step: forward, loss, backward and optimizer update.

Counterpart of mxnet_tpu/parallel/step.py `TrainStep` and `EvalStep`,
on one device or over a mesh (below). Where the reference compiles the whole step into one XLA program over
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
`sync_params()` has nothing to do but copy home the blocks a mesh step
keeps on other devices. `checkpoint.TrainCheckpoint` saves
and restores a step's whole state; a save asked for inside a call (a
signal handler's) waits for its end through `defer_to_step_end`.
`EvalStep` is the forward alone, in eval() mode.

Over a mesh (`mesh=`, parallel/mesh.py; `_MeshRun` below) the step keeps
the reference's results without GSPMD, placing the collectives itself:

  * the batch splits on dim 0 over the axes its specs name there ("dp",
    by default); each batch shard runs the net on its slice in a thread
    of its own, on a replica module (a copy of the net's structure whose
    tensors are passed in with torch.func.functional_call), and the
    threads meet at the collectives an op needs inside the forward
    (collectives.Rendezvous: BatchNorm's batch statistics, MoE gating).
    The loss is the global batch's: a "mean" is the sum over shards over
    the global count;
  * a parameter whose `sharding` spec splits a dimension (tp, fsdp, ep)
    is STORED in blocks over the mesh devices, with its optimizer state
    (`step.mesh_params[i].devices` has one entry per mesh position). On
    a device that holds the net's parameter a block is a view of it and
    of the full optimizer states, so a repeated device list keeps one
    copy. Each shard all_gathers the blocks for its compute, and the
    shards' gradients are reduce-scattered back into the blocks; a
    replicated parameter's gradients are psum'd over the shards. Each
    block then takes the optimizer update (LAMB, whose trust ratio needs
    the whole parameter, updates the whole tensor);
  * sequence parallelism is where the reference writes it: the
    attention's ring / Ulysses route over the "sp" axis
    (parallel/sp.py, chosen by ops.nn.dot_product_attention);
  * dropout masks are drawn for the global batch and sliced per shard,
    so the step draws the single-device step's masks; the fused
    attention kernel's keep mask hashes the row inside a shard, so with
    attention dropout on a shard's masks are its own (seed words folded
    with the shard's rank), not the single device's;
  * compression="2bit" (a pure-dp mesh): each shard keeps its own
    gradient and error-feedback residual; the exchange is
    compression.compressed_psum_mean (packed words all_gathered), the
    overflow check runs on the raw local gradients and is pmin'd, loss
    and BatchNorm statistics are per shard and pmean'd, dropout streams
    per shard, as the reference's shard_map step.

Every collective of a call is recorded (`last_collectives`), and
parallel.comm prices them.
"""
from __future__ import annotations

import copy
import math
import threading

import numpy as np
import torch

from .. import autograd as _ag
from .. import rng as _rng
from ..amp.loss_scaler import grads_finite
from ..base import MXNetError
from . import collectives as _coll
from .mesh import Mesh, PartitionSpec, _shard_scope, current_mesh, place

__all__ = ["TrainStep", "EvalStep"]

_MAX_SCALE = 2.0 ** 24


class TrainStep:
    """One optimizer step per call.

    Usage:
        step = TrainStep(net, loss_fn, optimizer, n_net_inputs=4)
        loss = step(ids, token_types, valid_length, positions, labels)
    """

    def __init__(self, net, loss_fn, optimizer, mesh=None, batch_specs=None,
                 donate=True, loss_reduce="mean", n_net_inputs=1,
                 loss_scale=None, scale_window=2000, compression=None,
                 compression_threshold=0.5):
        """mesh: a parallel.Mesh (default: the active one) runs the step
        over it with `batch_specs` (one PartitionSpec an input; default
        P("dp") each). compression="2bit" exchanges the dp gradients
        through the 2-bit wire with error feedback (a mesh whose only
        axis of size > 1 is dp; loss_reduce "mean"). `donate` is the
        reference's buffer donation: the step always updates in place."""
        mesh = _check_mesh(mesh if mesh is not None else current_mesh())
        if compression not in (None, "2bit"):
            raise MXNetError(f"unknown compression {compression!r}")
        if compression is not None:
            if mesh is None or "dp" not in mesh.axis_names \
                    or mesh.shape["dp"] < 2:
                raise MXNetError(
                    "compression='2bit' needs a mesh with a dp axis of "
                    "size >= 2 (it compresses the dp gradient exchange)")
            if any(ax != "dp" and n > 1 for ax, n in mesh.shape.items()):
                raise MXNetError(
                    "compression='2bit' supports pure data parallelism "
                    "(params replicated); drop tp/sp/pp/fsdp axes")
            if loss_reduce != "mean":
                raise MXNetError(
                    "compression='2bit' requires loss_reduce='mean' "
                    "(the compressed collective mean-reduces over dp)")
        self.mesh = mesh
        self.batch_specs = batch_specs
        self._compression = compression
        self._compression_threshold = float(compression_threshold)
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
        self.last_collectives = []
        self._residuals = []
        if mesh is not None:
            self._init_mesh()

    def _init_mesh(self):
        names = {id(v): n for n, v in self.net.named_parameters()}
        mesh = self.mesh
        self._mesh_run = _MeshRun(self.net, mesh, self.batch_specs)
        self.mesh_params = [
            MeshParam(names[id(p)], p, getattr(p, "sharding", None), mesh,
                      st) for p, st in zip(self._params, self._states)]
        self._mesh_fixed = [
            MeshParam(names[id(p)], p, getattr(p, "sharding", None), mesh,
                      ()) for p in self._fixed]
        if self._compression is not None:
            n = self._mesh_run.n
            self._residuals = [
                torch.zeros((n,) + tuple(p.shape), dtype=torch.float32,
                            device=p.device) for p in self._params]

    def param_sharding_specs(self):
        """Each trainable parameter's PartitionSpec (P() replicated)."""
        return [PartitionSpec(*p.sharding) if getattr(p, "sharding", None)
                is not None else PartitionSpec() for p in self._params]

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
            # recording and training, so a user's NDArray block inside the
            # net builds its graph (the reference traces it under
            # _Scope(False, True) and differentiates the trace)
            with _rng.generator_scope(gen), _ag._Scope(True, True):
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
                _apply_update(opt, p, g, states,
                              lr * getattr(p, "lr_mult", 1.0),
                              wd * getattr(p, "wd_mult", 1.0), t, ok)
                p.grad = None

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
        if self.mesh is not None:
            return self._mesh_step(batch)
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
        ok = None if scale is None else _unscale_(
            [p.grad for p in self._params if p.grad is not None], scale)
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
        write back, but for blocks of a mesh step held only on devices
        other than the net's, copied here (with their optimizer state)."""
        for mp in getattr(self, "mesh_params", ()):
            mp.pull_home()
        for mp in getattr(self, "_mesh_fixed", ()):
            mp.pull_home()

    def _after_restore(self):
        """A checkpoint restore wrote the net-device tensors: copy them
        into the blocks of other devices."""
        for mp in getattr(self, "mesh_params", ()):
            mp.push_home()
        for mp in getattr(self, "_mesh_fixed", ()):
            mp.push_home()

    # -- the mesh step ---------------------------------------------------------
    def _mesh_step(self, batch):
        run, opt = self._mesh_run, self.optimizer
        t = self._t + 1
        n, nin = run.n, self.n_net_inputs
        comp = self._compression is not None
        dyn = self._dynamic_scale
        scale = self._scale_state[0] if dyn else self._static_scale_t
        mparams, mfixed = self.mesh_params, self._mesh_fixed
        shards = run.shard_batch(batch)
        leaves = [None] * n
        fixed_out = [None] * n

        def shard(r):
            dev = run.devices[r]
            # per-shard dropout streams under compression (the
            # reference folds the dp index into the step key); else one
            # stream, each mask drawn for the global batch and sliced
            seed = self._seed if not comp else \
                _rng._splitmix64(self._seed ^ (r + 1))
            gen = _rng.step_generator(seed, t, dev)
            tensors, mine = {}, []
            for mp in mparams:
                x = mp.gather(dev).detach().requires_grad_(True)
                mine.append(x)
                tensors[mp.name] = x
            fx = {mp.name: mp.gather(dev).detach().clone() for mp in mfixed}
            tensors.update(fx)
            leaves[r], fixed_out[r] = mine, fx
            rep = run.replicas[r]
            rep.train()
            with _device_scope(dev), _shard_scope(run.context(r, comp)), \
                    _rng.generator_scope(gen), _ag._Scope(True, True):
                out = run.call(r, tensors, shards[r][:nin])
                outs = out if isinstance(out, tuple) else (out,)
                return self.loss_fn(*outs, *shards[r][nin:])

        with _coll.recording() as rec:
            losses = _run_shards(n, run.rendezvous, shard)
            if comp:
                means = [lo.float().mean() for lo in losses]
                objective = means[0]
                for m in means[1:]:
                    objective = objective + place(m, run.devices[0])
                loss = _coll.pmean([m.detach() for m in means],
                                   run.devices)[0]
            else:
                sums = [lo.float().sum() for lo in losses]
                total = _coll.psum(sums, run.devices)[0]
                loss = total / sum(lo.numel() for lo in losses) \
                    if self.loss_reduce == "mean" else total
                objective = loss
            (objective if scale is None else objective * scale).backward()
            grads = [[x.grad if x.grad is not None else torch.zeros_like(x)
                      for x in leaves[r]] for r in range(n)]
            if comp:
                totals, ok = self._compressed_exchange(grads, scale, dyn)
            else:
                totals = [mp.reduce([grads[r][i] for r in range(n)],
                                    run.devices)
                          for i, mp in enumerate(mparams)]
                ok = None if scale is None else _unscale_(totals, scale)
            if not dyn:
                ok = None
            self._write_fixed(fixed_out, comp, ok)
            lr, wd = float(opt.learning_rate), float(opt.wd)
            with torch.no_grad():
                for mp, g in zip(mparams, totals):
                    mp.update(opt, g, lr * getattr(mp.var, "lr_mult", 1.0),
                              wd * getattr(mp.var, "wd_mult", 1.0), t, ok)
        if dyn:
            self._scale_state = self._next_scale_state(ok)
        self.last_collectives = list(rec)
        self._t = t
        opt.num_update = t
        return loss.detach()

    def _compressed_exchange(self, grads, scale, dyn):
        """The dp gradient exchange through the 2-bit wire: unscaled
        local gradients (checked for overflow there, pmin over dp), then
        compressed_psum_mean with each shard's residual; on overflow the
        residuals keep their values."""
        from .compression import compressed_psum_mean
        run = self._mesh_run
        n = run.n
        ok = None
        if scale is not None:
            oks = [_unscale_(gs, scale).to(torch.int32) for gs in grads]
            if dyn:
                ok = _coll.pmin(oks, run.devices)[0] > 0
        totals = []
        with torch.no_grad():
            for i, res in enumerate(self._residuals):
                red, new = compressed_psum_mean(
                    [grads[r][i] for r in range(n)],
                    [res[r] for r in range(n)],
                    self._compression_threshold, run.devices)
                new = torch.stack([place(x, res.device) for x in new])
                if ok is not None:
                    new = torch.where(ok, new, res)
                res.copy_(new)
                totals.append(red[0].to(grads[0][i].dtype))
        return totals, ok

    def _write_fixed(self, fixed_out, comp, ok):
        """The non-trainable state the shards' forwards wrote (BatchNorm's
        running statistics) back into the storage: shard 0's (every
        shard computed the global batch's), or their pmean under
        compression (per-shard statistics)."""
        run = self._mesh_run
        with torch.no_grad():
            for mp in self._mesh_fixed:
                vals = [fixed_out[r][mp.name] for r in range(run.n)]
                if comp and run.n > 1:
                    new = _coll.pmean([v.float() for v in vals],
                                      run.devices)[0].to(vals[0].dtype)
                else:
                    new = vals[0]
                for (dev, b), (w, _) in mp.blocks.items():
                    v = place(mp.block_of(new, b), dev)
                    if ok is not None:
                        v = torch.where(place(ok, dev), v, w)
                    w.copy_(v)


class EvalStep:
    """The forward alone, in eval() mode and without autograd (parity:
    mxnet_tpu.parallel.EvalStep without a mesh). Tensors in, tensors out;
    NDArrays in, NDArrays out."""

    def __init__(self, net, mesh=None, batch_specs=None):
        self.net = net
        self.mesh = _check_mesh(mesh if mesh is not None
                                else current_mesh())
        self.batch_specs = batch_specs
        self._run = None if self.mesh is None else \
            _MeshRun(net, self.mesh, batch_specs)

    def _mesh_forward(self, args):
        """Each batch shard's forward on its replica (the parameters
        gathered to its device), the outputs concatenated on dim 0 on
        the first shard's device."""
        run = self._run
        names = dict(self.net.named_parameters())
        specs = {n: getattr(v, "sharding", None) for n, v in names.items()}
        shards = run.shard_batch(args)

        def shard(r):
            dev = run.devices[r]
            with torch.no_grad():
                tensors = {}
                for n, v in names.items():
                    mp = MeshParam(n, v, specs[n], self.mesh, ()) \
                        if specs[n] is not None else None
                    tensors[n] = place(v.detach(), dev) if mp is None \
                        else mp.gather(dev)
                rep = run.replicas[r]
                rep.eval()
                with _device_scope(dev), _shard_scope(run.context(r)), \
                        _ag._Scope(False, False):
                    return run.call(r, tensors, shards[r])

        outs = _run_shards(run.n, run.rendezvous, shard)
        d0 = run.devices[0]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat([place(o[j], d0) for o in outs], 0)
                         for j in range(len(outs[0])))
        return torch.cat([place(o, d0) for o in outs], 0)

    def __call__(self, *batch):
        from ..ndarray.ndarray import NDArray
        nd = any(isinstance(b, NDArray) for b in batch)
        args = [b._data if isinstance(b, NDArray) else b for b in batch]
        if self._run is not None:
            out = self._mesh_forward(args)
        else:
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


# ---------------------------------------------------------------------------
# the step over a mesh
# ---------------------------------------------------------------------------

class _device_scope:
    """torch.cuda.device(dev) for a CUDA device (the shard threads start
    on the default one), nothing for the CPU."""

    def __init__(self, dev):
        self._ctx = torch.cuda.device(dev) if dev.type == "cuda" else None

    def __enter__(self):
        if self._ctx is not None:
            self._ctx.__enter__()

    def __exit__(self, *exc):
        if self._ctx is not None:
            self._ctx.__exit__(*exc)


def _check_mesh(mesh):
    if mesh is not None and not isinstance(mesh, Mesh):
        raise MXNetError(f"mesh must be a parallel.Mesh (make_mesh), got "
                         f"{type(mesh).__name__}")
    return mesh


def _axes_of(entry):
    """The mesh axes of one PartitionSpec entry, as a tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _axes_index(axes, coords, mesh):
    """Row-major index of a position's coordinates over `axes`."""
    i = 0
    for a in axes:
        i = i * mesh.axis_size(a) + int(coords.get(a, 0))
    return i


def _nbytes(t):
    return int(t.numel() * t.element_size())


def _meta_replica(net):
    """A copy of `net`'s module tree whose parameters and buffers are meta
    tensors (no storage): the forward of one shard runs on it through
    torch.func.functional_call, which swaps the shard's tensors in."""
    memo = {}
    for t in list(net.parameters()) + list(net.buffers()):
        m = torch.empty_like(t, device="meta")
        memo[id(t)] = torch.nn.Parameter(m, requires_grad=t.requires_grad) \
            if isinstance(t, torch.nn.Parameter) else m
    return copy.deepcopy(net, memo)


def _apply_update(opt, w, g, states, lr, wd, t, ok=None):
    """opt's multi-precision update of `w` and its states in place; with
    `ok` (a device bool) they keep their incoming values where False."""
    olds = None if ok is None else [w.clone()] + [s.clone() for s in states]
    opt.apply_arrays_mp(w, g, states, lr, wd, t)
    if olds is not None:
        for new, old in zip((w, *states), olds):
            torch.where(ok, new, old, out=new)


def _unscale_(grads, scale):
    """The gradients times 1 / scale in place, computed in float32 and
    rounded to their dtype (the multiply's own arithmetic for bfloat16
    and float16); returns `ok` (no gradient inf / nan) as a device bool
    on the first gradient's device."""
    if not grads:
        return torch.ones((), dtype=torch.bool, device=scale.device)
    by_device = {}
    for g in grads:
        by_device.setdefault(g.device, []).append(g)
    oks = []
    with torch.no_grad():
        for dev, gs in by_device.items():
            torch._foreach_mul_(gs, torch.reciprocal(place(scale, dev)))
            oks.append(place(grads_finite(gs), grads[0].device))
    return oks[0] if len(oks) == 1 else torch.stack(oks).all()


def _run_shards(n, rendezvous, fn):
    """fn(rank) for every batch shard, rank 0 on the calling thread and
    the others on threads of their own; a failure on any shard releases
    the others and is raised here (the rendezvous is reset for the next
    call)."""
    if n == 1:
        return [fn(0)]
    rendezvous.reset()
    results, errors = [None] * n, [None] * n

    def body(r):
        try:
            results[r] = fn(r)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors[r] = e
            rendezvous.abort()

    threads = [threading.Thread(target=body, args=(r,), daemon=True,
                                name=f"mesh-shard-{r}")
               for r in range(1, n)]
    for th in threads:
        th.start()
    body(0)
    for th in threads:
        th.join()
    first = [e for e in errors if e is not None
             and not isinstance(e, threading.BrokenBarrierError)]
    if first:
        raise first[0]
    if any(e is not None for e in errors):
        raise next(e for e in errors if e is not None)
    return results


class MeshParam:
    """One parameter's storage over a mesh: blocks of its `sharding` spec,
    one per (device, block) of the mesh positions, each with its
    optimizer state. `devices` lists every position's device (one entry
    a mesh position, as the reference's sharded array has)."""

    def __init__(self, name, var, spec, mesh, states):
        self.name = name
        self.var = var
        self.spec = PartitionSpec(*spec) if spec is not None else None
        self.states = tuple(states)   # full states on the net's device
        parts = tuple(spec) if spec is not None else ()
        if len(parts) > var.dim():
            raise MXNetError(f"sharding spec {spec} longer than rank of "
                             f"{name} {tuple(var.shape)}")
        self.dims = []
        for i in range(var.dim()):
            axes = _axes_of(parts[i] if i < len(parts) else None)
            for a in axes:
                if a not in mesh.axis_names:
                    raise MXNetError(f"{name}: spec axis {a!r} is not an "
                                     f"axis of {mesh}")
            n = mesh.axis_size(axes)
            if var.shape[i] % n:
                raise MXNetError(f"{name}: dim {i} of size {var.shape[i]} "
                                 f"does not split over {axes} ({n})")
            self.dims.append((axes, n))
        self.grid = tuple(n for _, n in self.dims)
        self.n_blocks = math.prod(self.grid) if self.grid else 1
        self.sharded = self.n_blocks > 1
        self.positions = []
        for coords in np.ndindex(*mesh.devices.shape):
            c = dict(zip(mesh.axis_names, coords))
            b = tuple(_axes_index(axes, c, mesh) for axes, _ in self.dims)
            self.positions.append((mesh.devices[coords], b))
        home = var.device
        self.blocks = {}
        for dev, b in self.positions:
            if (dev, b) in self.blocks:
                continue
            w = self.block_of(var.detach(), b)
            st = tuple(self.block_of(s, b) for s in self.states)
            if dev != home:
                w = w.to(dev, copy=True)
                st = tuple(x.to(dev, copy=True) for x in st)
            self.blocks[(dev, b)] = (w, st)

    @property
    def devices(self):
        return [d for d, _ in self.positions]

    def block_of(self, t, b):
        """Block `b` of a tensor shaped like the parameter (a view)."""
        for i, ((_, n), bi) in enumerate(zip(self.dims, b)):
            if n > 1:
                size = t.shape[i] // n
                t = t.narrow(i, bi * size, size)
        return t

    def _holder(self, b, dev):
        x = self.blocks.get((dev, b))
        if x is None:
            x = next(v for (_, bb), v in self.blocks.items() if bb == b)
        return x[0]

    def gather(self, dev):
        """The whole parameter on `dev`: the block itself when it is not
        sharded, else the all_gather of its blocks (a copy)."""
        if not self.sharded:
            return place(self._holder(tuple(0 for _ in self.grid), dev),
                         dev)
        _coll.record("all_gather", _nbytes(self.var), self.n_blocks)
        nd = len(self.grid)

        def build(i, prefix):
            if i == nd:
                return place(self._holder(prefix, dev), dev)
            parts = [build(i + 1, prefix + (j,)) for j in
                     range(self.grid[i])]
            return torch.cat(parts, i) if len(parts) > 1 else parts[0]

        return build(0, ())

    def reduce(self, grads, devices):
        """The shards' whole-parameter gradients reduced: psum'd for a
        replicated parameter, reduce-scattered into the blocks for a
        sharded one. Returns the whole sum on devices[0]."""
        if not self.sharded:
            return _coll.psum(grads, devices)[0] if len(grads) > 1 \
                else grads[0]
        _coll.record("reduce_scatter", _nbytes(grads[0]),
                     len(grads) * self.n_blocks)
        d0 = devices[0]
        total = place(grads[0], d0)
        for g in grads[1:]:
            total = total + place(g, d0)
        return total

    def update(self, opt, total, lr, wd, t, ok=None):
        """The optimizer update of every block with its slice of `total`
        (the whole tensor for an optimizer whose `whole_tensor_update`
        is set: LAMB's trust ratio); with `ok` a device bool, every
        block keeps its incoming values where False."""
        home = self.var.device
        whole = opt.whole_tensor_update and self.sharded
        if whole:
            items = [(self.var.detach(), self.states, place(total, home))]
        else:
            items = [(w, st, place(self.block_of(total, b), dev))
                     for (dev, b), (w, st) in self.blocks.items()]
        for w, st, g in items:
            _apply_update(opt, w, g.to(w.dtype), st, lr, wd, t,
                          None if ok is None else place(ok, w.device))
        if whole:
            self.push_home()

    def push_home(self):
        """Copy the net-device values into the blocks of other devices."""
        home = self.var.device
        with torch.no_grad():
            for (dev, b), (w, st) in self.blocks.items():
                if dev == home:
                    continue
                w.copy_(self.block_of(self.var.detach(), b))
                for s, full in zip(st, self.states):
                    s.copy_(self.block_of(full, b))

    def pull_home(self):
        """Copy blocks held only on other devices into the net-device
        tensors (the parameter and its full states)."""
        home = self.var.device
        have = {b for (dev, b) in self.blocks if dev == home}
        with torch.no_grad():
            for (dev, b), (w, st) in self.blocks.items():
                if dev == home or b in have:
                    continue
                self.block_of(self.var.detach(), b).copy_(w)
                for s, full in zip(st, self.states):
                    self.block_of(full, b).copy_(s)
                have.add(b)


class _MeshRun:
    """The mesh side of a TrainStep or EvalStep: the batch split, the
    shard threads and their replicas, the parameters' storage."""

    def __init__(self, net, mesh, batch_specs):
        self.net = net
        self.mesh = mesh
        self.batch_specs = batch_specs
        specs = list(batch_specs) if batch_specs else []
        first = [tuple(s)[0] if s is not None and len(s) else None
                 for s in specs]
        axes = {_axes_of(f) for f in first if f is not None}
        if len(axes) > 1:
            raise MXNetError(f"batch specs split dim 0 over different axes "
                             f"{sorted(axes)}")
        self.batch_axes = axes.pop() if axes else ("dp",)
        for a in self.batch_axes:
            if a not in mesh.axis_names:
                self.batch_axes = tuple(x for x in self.batch_axes
                                        if x in mesh.axis_names)
        self.n = mesh.axis_size(self.batch_axes)
        self.devices, self.coords = [], []
        for r in range(self.n):
            coords, rest = {}, r
            for a in reversed(self.batch_axes):
                coords[a] = rest % mesh.axis_size(a)
                rest //= mesh.axis_size(a)
            self.coords.append(coords)
            self.devices.append(mesh.device_at(**coords))
        self.split = None if not specs else [f is not None for f in first]
        self.replicas = [_meta_replica(net) for _ in range(self.n)]
        self.rendezvous = _coll.Rendezvous(self.n)
        self.buffers = dict(net.named_buffers())

    def shard_batch(self, batch):
        """Each batch shard's inputs (dim 0 split where its spec splits)."""
        out = [[] for _ in range(self.n)]
        for i, b in enumerate(batch):
            split = self.split[i] if self.split is not None \
                and i < len(self.split) else True
            if split and self.n > 1:
                if b.shape[0] % self.n:
                    raise MXNetError(f"batch dim {b.shape[0]} of input {i} "
                                     f"does not split over {self.n} shards")
                parts = b.chunk(self.n, 0)
            else:
                parts = [b] * self.n
            for r in range(self.n):
                out[r].append(place(parts[r], self.devices[r]))
        return out

    def context(self, r, per_shard=False):
        return _coll.ShardContext(self.mesh, r, self.n, self.devices[r],
                                  self.rendezvous, self.devices,
                                  per_shard=per_shard,
                                  coords=self.coords[r])

    def call(self, r, tensors, args):
        """The replica of shard r on `tensors` (name -> tensor)."""
        dev = self.devices[r]
        full = {n: place(b, dev) for n, b in self.buffers.items()}
        full.update(tensors)
        return torch.func.functional_call(self.replicas[r], full,
                                          tuple(args), strict=False,
                                          tie_weights=True)
