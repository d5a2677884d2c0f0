"""Sequence parallelism: ring and Ulysses attention over the "sp" axis.

Counterpart of mxnet_tpu/parallel/sp.py (`sp_enabled`, `ring_attention`,
`ulysses_attention`). The reference enters (B, H, T, D) operands
sharded along T over "sp" and runs a shard_map; here the operands are
the whole tensors of the calling shard (inside a mesh TrainStep: one
batch shard's), split along T into one block per sp shard on that
shard's device (the positions of the calling batch shard with sp = s),
and the collectives run over the blocks as lists
(parallel/collectives.py):

  * ring: ops.attention.ring_attention_data, the K/V blocks rotating by
    ppermute with an online softmax (O(T_local) scores a shard);
  * Ulysses: an all_to_all re-shards each block head-wise (shard s gets
    H/sp heads over the whole sequence), the port's
    dot_product_attention runs there (the fused kernel on a CUDA
    tensor, its plain version on the CPU), and a second all_to_all
    restores the T split.

The outputs are concatenated back along T on the operands' device.
Unlike the reference, heads are not split over "tp" (a mesh step does
not split tp's compute), so Ulysses' per-shard head count is H / sp;
the reference's check that H / tp divides by sp is kept so both
packages route and refuse the same calls.
"""
from __future__ import annotations

from ..base import MXNetError
from . import collectives as _coll
from .mesh import AXIS_SP, axis_enabled, current_mesh, place, shard_context

__all__ = ["ring_attention", "ulysses_attention", "sp_enabled"]


def sp_enabled(mesh=None, sp_axis=AXIS_SP):
    """True iff an active mesh has a real (size > 1) sp axis."""
    return axis_enabled(mesh, sp_axis)


def _sp_devices(mesh, sp_axis, n_sp):
    """The devices of the sp shards of the calling batch shard."""
    ctx = shard_context()
    base = dict(ctx.coords) if ctx is not None and ctx.mesh is mesh else {}
    return [mesh.device_at(**{**base, sp_axis: s}) for s in range(n_sp)]


def _sp_operands(q, k, v, mask, mesh, sp_axis, kind):
    if mesh is None or sp_axis not in mesh.axis_names:
        raise MXNetError(
            f"{kind} attention needs an active mesh with a {sp_axis!r} "
            "axis (make_mesh(sp=...) + mesh_scope/set_default_mesh)")
    n_sp = mesh.shape[sp_axis]
    B, H, T, D = q.shape
    if T % n_sp or k.shape[-2] % n_sp:
        raise MXNetError(
            f"sequence length {T}/{k.shape[-2]} not divisible by sp axis "
            f"size {n_sp}")
    mask2 = None
    if mask is not None:
        mask2 = mask.reshape(mask.shape[0], mask.shape[-1])
        if mask2.shape[0] != B:
            mask2 = mask2.expand(B, mask2.shape[-1])
    devices = _sp_devices(mesh, sp_axis, n_sp)

    def split(x, dim):
        return [place(c, d) for c, d in zip(x.chunk(n_sp, dim), devices)]

    return (n_sp, devices, split(q, 2), split(k, 2), split(v, 2),
            None if mask2 is None else split(mask2, 1))


def ring_attention(q, k, v, mask=None, causal=False, scale=None, mesh=None,
                   sp_axis=AXIS_SP, batch_axis="dp", heads_axis="tp"):
    """Sequence-parallel attention on (B, H, T, D) tensors by the ring.
    mask: optional key padding, (B, Tk) or (B, 1, 1, Tk), True = attend.
    batch_axis / heads_axis are the reference's (the activation layout
    of its shard_map); a batch shard already holds its rows here."""
    from ..ops.attention import ring_attention_data
    mesh = mesh if mesh is not None else current_mesh()
    n_sp, devices, qs, ks, vs, ms = _sp_operands(q, k, v, mask, mesh,
                                                 sp_axis, "ring")
    outs = ring_attention_data(qs, ks, vs, causal=causal, scale=scale,
                               masks=ms, devices=devices)
    import torch
    return torch.cat([place(o, q.device) for o in outs], 2)


def ulysses_attention(q, k, v, mask=None, causal=False, scale=None,
                      mesh=None, sp_axis=AXIS_SP, batch_axis="dp",
                      heads_axis="tp"):
    """Ulysses sequence parallelism (head all_to_all) on (B, H, T, D)
    tensors; the per-shard attention is ops.nn.dot_product_attention's
    own route (the fused kernel on the card)."""
    import torch

    from ..ops import nn as _opnn
    mesh = mesh if mesh is not None else current_mesh()
    n_sp, devices, qs, ks, vs, ms = _sp_operands(q, k, v, mask, mesh,
                                                 sp_axis, "ulysses")
    H = q.shape[1]
    n_ha = mesh.shape[heads_axis] if heads_axis in mesh.axis_names else 1
    if H % n_ha or (H // n_ha) % n_sp:
        raise MXNetError(
            f"ulysses needs per-device heads {H}/{n_ha} divisible by sp "
            f"axis size {n_sp}; use ring_attention otherwise")
    # (B, H, T/n, D) -> all_to_all -> (B, H/n, T, D)
    qf = _coll.all_to_all([x.contiguous() for x in qs], 1, 2, devices)
    kf = _coll.all_to_all([x.contiguous() for x in ks], 1, 2, devices)
    vf = _coll.all_to_all([x.contiguous() for x in vs], 1, 2, devices)
    full = None if ms is None else _coll.all_gather(ms, 1, devices)
    outs = [_opnn.local_attention(
        qf[s], kf[s], vf[s],
        None if full is None else full[s][:, None, None, :],
        scale=scale, causal=causal) for s in range(n_sp)]
    back = _coll.all_to_all(outs, 2, 1, devices)
    return torch.cat([place(o, q.device) for o in back], 2)
