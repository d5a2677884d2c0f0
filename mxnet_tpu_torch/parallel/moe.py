"""Mixture-of-Experts math: top-k gating with capacity, the dispatch /
expert / combine FFN, and the token all_to_all over the "ep" axis.

Counterpart of mxnet_tpu/parallel/moe.py (`top_k_gating`,
`moe_dispatch_combine`, `all_to_all_tokens`), the GShard / Switch
formulation with static shapes: a (S, E, Cap) one-hot dispatch, the
expert FFNs as (E, Cap, C) products over the stacked expert weights, and
the gate-weighted combine back to tokens; tokens past an expert's
capacity are dropped (combine weight 0).

Expert parallelism in the reference is a sharding of the stacked expert
weights over "ep" that XLA partitions. In a mesh TrainStep the port
stores those weights in ep blocks and gathers them for compute
(parallel/step.py), so the expert products run whole on each batch
shard (splitting ep's compute is later work). Inside a mesh step's batch
shard, `moe_dispatch_combine` gates over the GLOBAL batch: the gate
logits are all_gathered over the shards, so capacities, slot positions
and drops are the single-device run's; each shard then computes its own
tokens' outputs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError
from . import collectives as _coll
from .mesh import AXIS_EP, current_mesh, place, shard_context

__all__ = ["top_k_gating", "moe_dispatch_combine", "all_to_all_tokens"]


def top_k_gating(logits, top_k, capacity):
    """GShard-style gating. logits: (S, E). Returns (dispatch (S, E, Cap)
    bool, combine (S, E, Cap) float32, aux_loss float32 scalar), the
    Switch load-balancing loss E * sum_e mean(prob_e) * mean(routed_e)."""
    S, E = logits.shape
    dev = logits.device
    # jax.nn.softmax's arithmetic: exp, then a true division by the sum
    # (XLA's exp itself may differ from torch's in the last bit)
    x32 = logits.float()
    unnorm = torch.exp(x32 - x32.amax(dim=-1, keepdim=True))
    probs = unnorm / unnorm.sum(dim=-1, keepdim=True)
    gate_vals, gate_idx = torch.topk(probs, top_k, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    dispatch = torch.zeros((S, E, capacity), dtype=torch.bool, device=dev)
    combine = torch.zeros((S, E, capacity), dtype=torch.float32, device=dev)
    fill = torch.zeros((E,), dtype=torch.int64, device=dev)
    rows = torch.arange(S, device=dev)
    for j in range(top_k):
        e_j = gate_idx[:, j]
        onehot = F.one_hot(e_j, E)
        pos = fill[e_j] + torch.cumsum(onehot, dim=0)[rows, e_j] - 1
        keep = pos < capacity
        slot = F.one_hot(torch.where(keep, pos, torch.zeros_like(pos)),
                         capacity).bool()
        disp_j = (onehot.bool()[:, :, None] & slot[:, None, :]
                  & keep[:, None, None])
        dispatch = dispatch | disp_j
        combine = combine + disp_j * gate_vals[:, j][:, None, None]
        fill = fill + onehot.sum(dim=0)
    me = probs.mean(dim=0)
    ce = dispatch.any(dim=-1).float().mean(dim=0)
    aux = E * torch.sum(me * ce)
    return dispatch, combine, aux


_ACTS = {"gelu": lambda x: F.gelu(x, approximate="tanh"),
         "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
         "relu": F.relu, "silu": F.silu}


def moe_dispatch_combine(x, gate_logits, w1, b1, w2, b2, top_k=2,
                         capacity_factor=1.25, activation="gelu"):
    """The MoE FFN on flat tokens. x: (S, C); gate_logits: (S, E);
    stacked expert weights w1 (E, C, H), b1 (E, H), w2 (E, H, C),
    b2 (E, C). activation: a name ("gelu" is jax.nn.gelu's default, the
    tanh form) or a function. Returns (y (S, C) in x's dtype, aux_loss
    in x's dtype)."""
    act = _ACTS[activation] if isinstance(activation, str) else activation
    S, C = x.shape
    E = w1.shape[0]
    ctx = shard_context()
    if ctx is not None and ctx.spans_batch:
        # gate over the global batch: the shards' logits in shard order
        glob = ctx.all_gather(gate_logits, 0)
        capacity = max(1, int(glob.shape[0] * top_k * capacity_factor / E))
        dispatch, combine, aux = top_k_gating(glob, top_k, capacity)
        lo = ctx.rank * S
        dispatch, combine = dispatch[lo:lo + S], combine[lo:lo + S]
    else:
        capacity = max(1, int(S * top_k * capacity_factor / E))
        dispatch, combine, aux = top_k_gating(gate_logits, top_k, capacity)
    xin = x.float()
    expert_in = torch.einsum("sec,sm->ecm", dispatch.float(), xin)
    h = act(torch.einsum("ecm,emh->ech", expert_in, w1.float())
            + b1[:, None, :].float())
    expert_out = torch.einsum("ech,ehm->ecm", h, w2.float()) \
        + b2[:, None, :].float()
    y = torch.einsum("sec,ecm->sm", combine, expert_out)
    return y.to(x.dtype), aux.to(x.dtype)


def all_to_all_tokens(x, mesh=None, axis=AXIS_EP, split_dim=1,
                      concat_dim=0):
    """Token redistribution over the ep axis: x is the global tensor, its
    `concat_dim` split over `axis` going in (one block a shard, on the
    shard's device) and its `split_dim` split over `axis` coming out;
    returns the global result on x's device (collectives.all_to_all
    over the blocks)."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None or axis not in mesh.axis_names:
        raise MXNetError(f"all_to_all_tokens needs a mesh with {axis!r}")
    n = mesh.shape[axis]
    if x.shape[concat_dim] % n or x.shape[split_dim] % n:
        raise MXNetError(f"all_to_all_tokens: dims {concat_dim} / "
                         f"{split_dim} of {tuple(x.shape)} over {n} shards")
    devices = [mesh.device_at(**{axis: s}) for s in range(n)]
    parts = [place(c, d) for c, d in zip(x.chunk(n, concat_dim), devices)]
    out = _coll.all_to_all(parts, split_dim, concat_dim, devices)
    return torch.cat([place(o, x.device) for o in out], split_dim)
