"""Pipeline parallelism: microbatched stages over the "pp" axis.

Counterpart of mxnet_tpu/parallel/pp.py (`stack_stage_params`, `gpipe`,
`pipeline_loss`, `pipeline_loss_and_grads`, `pipeline_grads`,
`PPTrainStep`). The reference stacks structurally identical stages'
parameters on a leading stage axis sharded over "pp" and runs the
schedule per device in a shard_map, activations moving stage to stage by
ppermute. Here one process runs the same schedule over the stages as a
list: stage p's parameters live on the device of the position pp = p,
each schedule step every active stage applies its function to its
microbatch, and the activations (and, in 1F1B, the cotangents) move by
collectives.ppermute (recorded, a copy where the devices differ). A
stage with no microbatch in a step does no work (the reference computes
a value there and discards it); the results are the same.

Parameter pytrees are torch.utils._pytree trees (dicts, lists, tensors).
Schedules:
  * gpipe / pipeline_loss: the forward pipeline, differentiated by
    autograd (every microbatch's activations live until the backward);
  * pipeline_grads: 1F1B with per-stage recompute: stage p forwards
    microbatch m at step m + p and backwards it at step m + 2(P-1) - p,
    recomputing its stage from the saved input, so a stage holds at
    most P saved inputs (the reference's O(P) activation residency);
    gradients accumulate in float32.
With a "dp" axis the batch splits over the dp shards (each runs the
pipeline on its slice) and loss and gradients are mean-reduced over dp.
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from ..base import MXNetError
from . import collectives as _coll
from .mesh import AXIS_PP, current_mesh, place

__all__ = ["gpipe", "stack_stage_params", "pipeline_loss",
           "pipeline_loss_and_grads", "pipeline_grads", "PPTrainStep"]


def stack_stage_params(stage_param_trees):
    """Stack structurally identical per-stage trees along a new leading
    stage axis."""
    leaves0, spec = pytree.tree_flatten(stage_param_trees[0])
    flat = [pytree.tree_flatten(t)[0] for t in stage_param_trees]
    return pytree.tree_unflatten(
        [torch.stack([f[i] for f in flat], 0) for i in range(len(leaves0))],
        spec)


def _stage(tree, p, dev):
    return pytree.tree_map(lambda a: place(a[p], dev), tree)


def _mesh_of(mesh, axis, what):
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None or axis not in mesh.axis_names:
        raise MXNetError(f"{what} needs an active mesh with a {axis!r} axis")
    return mesh


def _stage_devices(mesh, axis, dp_rank=0):
    base = {"dp": dp_rank} if "dp" in mesh.axis_names else {}
    return [mesh.device_at(**{**base, axis: p})
            for p in range(mesh.shape[axis])]


def gpipe(stage_fn, stacked_params, x, n_microbatches, mesh=None,
          axis=AXIS_PP):
    """`x` through the P stages over the mesh's pp axis (GPipe schedule):
    stage_fn(stage_params, mb) -> mb_out keeps the shape. Returns (B,
    ...) on x's device, equal to applying the stages in turn."""
    mesh = _mesh_of(mesh, axis, "gpipe")
    P = mesh.shape[axis]
    n = pytree.tree_flatten(stacked_params)[0][0].shape[0]
    if n != P:
        raise MXNetError(f"{n} stacked stages != pp axis size {P}")
    B, M = x.shape[0], int(n_microbatches)
    if B % M:
        raise MXNetError(f"batch {B} not divisible into {M} microbatches")
    devs = _stage_devices(mesh, axis)
    params = [_stage(stacked_params, p, devs[p]) for p in range(P)]
    xs = x.chunk(M, 0)
    state, ys = [None] * P, [None] * M
    perm = [(i, i + 1) for i in range(P - 1)]
    for t in range(M + P - 1):
        outs = [None] * P
        for p in range(P):
            m = t - p
            if 0 <= m < M:
                inp = place(xs[m], devs[p]) if p == 0 else state[p]
                outs[p] = stage_fn(params[p], inp)
                if p == P - 1:
                    ys[m] = outs[p]
        state = _shift(outs, perm, devs)
    return torch.cat([place(y, x.device) for y in ys], 0)


def _shift(outs, perm, devs):
    """Activations (or cotangents) to the next stage along `perm`
    (ppermute of the stages that produced one)."""
    if any(o is not None for o in outs):
        live = next(o for o in outs if o is not None)
        _coll.record("collective_permute", live.numel()
                     * live.element_size(), len(outs))
    new = [None] * len(outs)
    for src, dst in perm:
        if outs[src] is not None:
            new[dst] = place(outs[src], devs[dst])
    return new


def _check_batch(mesh, x, M):
    n_dp = mesh.shape["dp"] if "dp" in mesh.axis_names else 1
    B = x.shape[0]
    if B % n_dp:
        raise MXNetError(f"batch {B} not divisible over dp={n_dp}")
    if (B // n_dp) % M or M < 1:
        raise MXNetError(f"per-dp-shard batch {B // n_dp} not divisible "
                         f"into {M} microbatches")
    return n_dp


def _pipeline_shard_loss(embed_fn, stage_fn, head_loss_fn, e, stages, h, x,
                         y, M, devs):
    """One dp shard's GPipe forward: the mean of the microbatch losses
    (a float32 scalar on the last stage's device)."""
    P = len(devs)
    xs, ys = x.chunk(M, 0), y.chunk(M, 0)
    perm = [(i, i + 1) for i in range(P - 1)]
    state, total = [None] * P, None
    for t in range(M + P - 1):
        outs = [None] * P
        for p in range(P):
            m = t - p
            if not 0 <= m < M:
                continue
            inp = embed_fn(e, place(xs[m], devs[0])) if p == 0 else state[p]
            outs[p] = stage_fn(stages[p], inp)
            if p == P - 1:
                mb = head_loss_fn(h, outs[p], place(ys[m], devs[-1])).float()
                total = mb if total is None else total + mb
        state = _shift(outs, perm, devs)
    return total / M


def pipeline_loss(embed_fn, stage_fn, head_loss_fn, embed_params,
                  stacked_params, head_params, x, y, n_microbatches,
                  mesh=None, axis=AXIS_PP):
    """Mean loss of embed -> P stacked body stages -> head under the GPipe
    schedule (differentiable by autograd). embed_fn(embed_params, x_mb)
    -> h; stage_fn(body_params, h) -> h; head_loss_fn(head_params, h,
    y_mb) -> the microbatch's mean loss."""
    mesh = _mesh_of(mesh, axis, "pipeline")
    M = int(n_microbatches)
    n_dp = _check_batch(mesh, x, M)
    losses = []
    for d, (xd, yd) in enumerate(zip(x.chunk(n_dp, 0), y.chunk(n_dp, 0))):
        devs = _stage_devices(mesh, axis, d)
        e = pytree.tree_map(lambda a: place(a, devs[0]), embed_params)
        h = pytree.tree_map(lambda a: place(a, devs[-1]), head_params)
        stages = [_stage(stacked_params, p, devs[p])
                  for p in range(len(devs))]
        losses.append(_pipeline_shard_loss(embed_fn, stage_fn,
                                           head_loss_fn, e, stages, h, xd,
                                           yd, M, devs))
    if n_dp == 1:
        return losses[0]
    return _coll.pmean(losses)[0]


def _leaves_like(tree):
    return pytree.tree_map(
        lambda a: a.detach().requires_grad_(True), tree)


def pipeline_loss_and_grads(embed_fn, stage_fn, head_loss_fn,
                            embed_params, stacked_params, head_params,
                            x, y, n_microbatches, mesh=None,
                            axis=AXIS_PP):
    """GPipe training step: (mean_loss, embed_grads, stacked_body_grads,
    head_grads) by autograd through the forward pipeline."""
    e = _leaves_like(embed_params)
    b = _leaves_like(stacked_params)
    h = _leaves_like(head_params)
    loss = pipeline_loss(embed_fn, stage_fn, head_loss_fn, e, b, h, x, y,
                         n_microbatches, mesh=mesh, axis=axis)
    leaves = [pytree.tree_flatten(t)[0] for t in (e, b, h)]
    flat = leaves[0] + leaves[1] + leaves[2]
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(a) if g is None else g
             for a, g in zip(flat, grads)]
    n0, n1 = len(leaves[0]), len(leaves[1])
    out = []
    for tree, gs in zip((e, b, h), (grads[:n0], grads[n0:n0 + n1],
                                    grads[n0 + n1:])):
        out.append(pytree.tree_unflatten(list(gs),
                                         pytree.tree_flatten(tree)[1]))
    return (loss.detach(),) + tuple(out)


def _zeros32(tree):
    return pytree.tree_map(
        lambda a: torch.zeros(a.shape, dtype=torch.float32,
                              device=a.device), tree)


def _add(acc, grads):
    return pytree.tree_map(lambda a, g: a + g.float(), acc, grads)


def _pipeline_grads_shard(embed_fn, stage_fn, head_loss_fn, e, stages, h,
                          x, y, M, devs):
    """One dp shard's 1F1B schedule: (loss, ge, [gb per stage], gh),
    float32 sums over the microbatches (not yet divided by M)."""
    P = len(devs)
    xs, ys = x.chunk(M, 0), y.chunk(M, 0)
    fwd_perm = [(i, i + 1) for i in range(P - 1)]
    bwd_perm = [(i + 1, i) for i in range(P - 1)]
    saved = [dict() for _ in range(P)]
    state_f, state_b = [None] * P, [None] * P
    ge, gh = _zeros32(e), _zeros32(h)
    gb = [_zeros32(s) for s in stages]
    loss = torch.zeros((), dtype=torch.float32, device=devs[-1])
    for t in range(M + 2 * P - 2):
        outs_f, outs_b = [None] * P, [None] * P
        for p in range(P):
            m = t - p
            if 0 <= m < M:   # forward, no graph kept
                with torch.no_grad():
                    h_in = embed_fn(e, place(xs[m], devs[0])) if p == 0 \
                        else state_f[p]
                    outs_f[p] = stage_fn(stages[p], h_in)
                saved[p][m] = h_in
            mb = t - 2 * (P - 1) + p
            if 0 <= mb < M:  # backward of microbatch mb, recomputed
                h_saved = saved[p].pop(mb)
                sp = _leaves_like(stages[p])
                ep = _leaves_like(e) if p == 0 else None
                hp = _leaves_like(h) if p == P - 1 else None
                with torch.enable_grad():
                    h_leaf = None
                    if p == 0:
                        h_in = embed_fn(ep, place(xs[mb], devs[0]))
                    else:
                        h_leaf = h_saved.detach().requires_grad_(True)
                        h_in = h_leaf
                    out = stage_fn(sp, h_in)
                    if p == P - 1:
                        lo = head_loss_fn(hp, out,
                                          place(ys[mb], devs[-1])).float()
                    else:
                        lo = (out.float() * state_b[p].float()).sum()
                    wrt = pytree.tree_flatten(sp)[0]
                    if ep is not None:
                        wrt += pytree.tree_flatten(ep)[0]
                    if hp is not None:
                        wrt += pytree.tree_flatten(hp)[0]
                    if h_leaf is not None:
                        wrt.append(h_leaf)
                    grads = list(torch.autograd.grad(lo, wrt,
                                                     allow_unused=True))
                grads = [torch.zeros_like(a) if g is None else g
                         for a, g in zip(wrt, grads)]
                ns = len(pytree.tree_flatten(sp)[0])
                gb[p] = _add(gb[p], pytree.tree_unflatten(
                    grads[:ns], pytree.tree_flatten(sp)[1]))
                k = ns
                if ep is not None:
                    ne = len(pytree.tree_flatten(ep)[0])
                    ge = _add(ge, pytree.tree_unflatten(
                        grads[k:k + ne], pytree.tree_flatten(ep)[1]))
                    k += ne
                if hp is not None:
                    nh = len(pytree.tree_flatten(hp)[0])
                    gh = _add(gh, pytree.tree_unflatten(
                        grads[k:k + nh], pytree.tree_flatten(hp)[1]))
                    k += nh
                    loss = loss + lo.detach()
                if h_leaf is not None:
                    outs_b[p] = grads[-1].to(h_saved.dtype)
        state_f = _shift(outs_f, fwd_perm, devs)
        state_b = _shift(outs_b, bwd_perm, devs)
    return loss, ge, gb, gh


def pipeline_grads(embed_fn, stage_fn, head_loss_fn, embed_params,
                   stacked_params, head_params, x, y, n_microbatches,
                   mesh=None, axis=AXIS_PP):
    """Interleaved forward / backward (1F1B) pipeline step with per-stage
    recompute: (mean_loss, embed_grads, stacked_body_grads, head_grads),
    float32 gradients."""
    mesh = _mesh_of(mesh, axis, "pipeline")
    M = int(n_microbatches)
    n_dp = _check_batch(mesh, x, M)
    results = []
    for d, (xd, yd) in enumerate(zip(x.chunk(n_dp, 0), y.chunk(n_dp, 0))):
        devs = _stage_devices(mesh, axis, d)
        e = pytree.tree_map(lambda a: place(a.detach(), devs[0]),
                            embed_params)
        h = pytree.tree_map(lambda a: place(a.detach(), devs[-1]),
                            head_params)
        stages = [_stage(pytree.tree_map(lambda a: a.detach(),
                                         stacked_params), p, devs[p])
                  for p in range(len(devs))]
        results.append(_pipeline_grads_shard(
            embed_fn, stage_fn, head_loss_fn, e, stages, h, xd, yd, M,
            devs))
    home = pytree.tree_flatten(embed_params)[0][0].device

    def mean_over(vals):
        vals = [place(v, home) / M for v in vals]
        return vals[0] if n_dp == 1 else _coll.pmean(vals)[0]

    loss = mean_over([r[0] for r in results])
    ge = pytree.tree_map(lambda *g: mean_over(list(g)),
                         *[r[1] for r in results])
    gh = pytree.tree_map(lambda *g: mean_over(list(g)),
                         *[r[3] for r in results])
    gb = stack_stage_params([
        pytree.tree_map(lambda *g: mean_over(list(g)),
                        *[r[2][p] for r in results])
        for p in range(len(results[0][2]))])
    return loss, ge, gb, gh


class PPTrainStep:
    """Pipeline-parallel training step: pipeline_grads (1F1B, the
    default) or autograd through the GPipe forward, then the optimizer's
    update of every leaf in place.

    The model is (embed_fn, stage_fn, head_loss_fn) over parameter trees
    (models.gpt2.gpt2_pp_functions builds them for GPT-2). The step keeps
    its own copies: embed and head parameters, and each stage's slice of
    the stacked body on the device of its pp position. tied: a list of
    (embed_key, head_key) pairs of dict keys whose gradients are summed
    and applied once to the embed copy, the head copy mirrored (GPT-2's
    tied LM head)."""

    def __init__(self, embed_fn, stage_fn, head_loss_fn, embed_params,
                 stacked_params, head_params, optimizer, n_microbatches,
                 mesh=None, schedule="1f1b", tied=None):
        self.mesh = _mesh_of(mesh, AXIS_PP, "PPTrainStep")
        if schedule not in ("1f1b", "gpipe"):
            raise MXNetError(f"unknown schedule {schedule!r}")
        if not optimizer.fused_supported:
            raise MXNetError(
                f"{type(optimizer).__name__} has no functional update")
        self._fns = (embed_fn, stage_fn, head_loss_fn)
        self.optimizer = optimizer
        self.M = int(n_microbatches)
        self.schedule = schedule
        self.tied = list(tied or [])
        self._tied_h = {hk for _, hk in self.tied}
        copy = lambda t: pytree.tree_map(  # noqa: E731
            lambda a: a.detach().clone(), t)
        self._e = copy(embed_params)
        self._b = copy(stacked_params)
        self._h = copy(head_params)
        mk = lambda t: pytree.tree_map(  # noqa: E731
            lambda a: tuple(optimizer.init_state_arrays_mp(a)), t)
        with torch.no_grad():
            self._es = mk(self._e)
            self._bs = mk(self._b)
            self._hs = {k: v for k, v in mk(self._h).items()
                        if k not in self._tied_h} \
                if isinstance(self._h, dict) else mk(self._h)
        self._t = 0
        self.last_collectives = []

    @property
    def params(self):
        return self._e, self._b, self._h

    def __call__(self, x, y):
        embed_fn, stage_fn, head_loss_fn = self._fns
        with _coll.recording() as rec:
            if self.schedule == "1f1b":
                loss, ge, gb, gh = pipeline_grads(
                    embed_fn, stage_fn, head_loss_fn, self._e, self._b,
                    self._h, x, y, self.M, mesh=self.mesh)
            else:
                loss, ge, gb, gh = pipeline_loss_and_grads(
                    embed_fn, stage_fn, head_loss_fn, self._e, self._b,
                    self._h, x, y, self.M, mesh=self.mesh)
        self.last_collectives = list(rec)
        self._t += 1
        t, opt = self._t, self.optimizer
        lr, wd = float(opt.learning_rate), float(opt.wd)
        for ek, hk in self.tied:
            ge[ek] = ge[ek] + place(gh[hk], ge[ek].device).to(ge[ek].dtype)
        with torch.no_grad():
            for params, grads, states in (
                    (self._e, ge, self._es), (self._b, gb, self._bs),
                    (self._h, gh, self._hs)):
                self._apply(params, grads, states, lr, wd, t)
            for ek, hk in self.tied:
                self._h[hk].copy_(self._e[ek].to(self._h[hk].dtype))
        opt.num_update = t
        return loss

    def _apply(self, params, grads, states, lr, wd, t):
        if isinstance(params, dict):
            for k, p in params.items():
                if k in self._tied_h and params is self._h:
                    continue
                self._apply(p, grads[k], states[k], lr, wd, t)
            return
        if isinstance(params, (list, tuple)):
            for p, g, s in zip(params, grads, states):
                self._apply(p, g, s, lr, wd, t)
            return
        g = place(grads, params.device)
        self.optimizer.apply_arrays_mp(
            params, g.to(params.dtype) if g.dtype != params.dtype else g,
            states, lr, wd, t)
