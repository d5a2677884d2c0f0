"""Tensor-parallel serving in one process: a shard group and the head-wise
split of a GPT-2 model.

Counterpart of the reference engine's `shard_map` over its {tp: N} mesh
and the `lax.psum` that ends each row-parallel projection. The reference
is single-controller: one ServingEngine owns the mesh and runs the same
program body on every shard. The port keeps that design without a mesh:
one process holds a list of shard devices (parallel/mesh.py), one shard
module per device (`shard_gpt2`), and runs the shards one after another
in lockstep (models/gpt2.py `tp_forward`), meeting at `TPGroup.all_reduce`
where the reference meets at its psum. The devices may repeat, so N
shards run on one card or on the CPU; then every copy below is a no-op.
A design with one process per shard (torch.distributed) would need a
scheduler broadcasting each dispatch's grid, and NCCL refuses two ranks
on one device.
"""
from __future__ import annotations

import torch
from torch import nn

from ..base import MXNetError
from ..models.gpt2 import GPT2Model
from ..nn import Dense
from . import collectives as _coll
from .mesh import place
from .rules import split_kind

__all__ = ["TPGroup", "shard_gpt2", "place"]


class TPGroup:
    """The shard devices of one tensor-parallel engine, in shard order."""

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise MXNetError("a TPGroup needs at least one device")
        self.size = len(self.devices)

    def all_reduce(self, parts):
        """The sum of one partial per shard, on every shard's device
        (collectives.psum): summed on shard 0's device in shard order
        (parts[0] + parts[1] + ...), in the partials' dtype, as psum
        does. Shards on shard 0's device get the one sum tensor itself
        (no copy)."""
        if len(parts) != self.size:
            raise MXNetError(f"all_reduce got {len(parts)} partials for "
                             f"{self.size} shards")
        return _coll.psum(parts, self.devices)

    def broadcast(self, t):
        """`t` placed on every shard's device (a replicated operand)."""
        return [place(t, d) for d in self.devices]


def _slice(t, kind, rank, size):
    """Shard `rank`'s contiguous slice of `t` under split `kind`: the
    tensor itself when replicated, a view for an out-axis ("col") slice
    of a contiguous tensor, a copy for an in-axis ("row") one."""
    if kind == "replicated":
        return t
    axis = 0 if kind == "col" else 1
    n = t.shape[axis] // size
    return t.narrow(axis, rank * n, n).contiguous()


def _set(module, name, tensor):
    if name in module._parameters:
        module._parameters[name] = nn.Parameter(tensor, requires_grad=False)
    else:
        module._buffers[name] = tensor


def shard_gpt2(model, group):
    """One shard backbone (a GPT2Model built for (rank, size)) per device
    of `group`, from the full model's tensors:

      * column-parallel weights and biases (query/key/value, fc1) sliced
        on the out axis at head offsets;
      * row-parallel weights (proj, fc2) sliced on the in axis, their
        biases kept whole for after the reduction;
      * w8 layers (int8 codes and scales) sliced as
        serving.weight_quant.shard_quantized says;
      * everything else (embeddings, the tied LM head, LayerNorms) whole.

    A slice is made once, here: a shard on the model's device shares the
    model's storage wherever a slice is contiguous (an out-axis slice, a
    replicated tensor) and copies the rest; a shard on another device
    copies everything it holds."""
    # serving imports this module: the quantizer's slicer comes late
    from ..serving.weight_quant import shard_quantized
    cfg, size = model.config, group.size
    full = model.backbone
    shards = []
    for rank, dev in enumerate(group.devices):
        with torch.device("meta"):
            shard = GPT2Model(cfg, device="meta", dtype=model.dtype,
                              tp=(rank, size))
        mods = dict(shard.named_modules())
        for name, src in full.named_modules():
            dst = mods[name]
            if isinstance(src, Dense):
                kind = split_kind(f"{name}.weight")
                if kind == "replicated":
                    raise MXNetError(f"{name} is a dense layer outside the "
                                     "megatron split")
                if src.codes is not None:
                    codes, scale = shard_quantized(src.codes, src.scale,
                                                   kind, rank, size)
                    del dst.weight
                    dst.weight = None
                    _set(dst, "codes", place(codes.contiguous(), dev))
                    _set(dst, "scale", place(scale.contiguous(), dev))
                else:
                    _set(dst, "weight",
                         place(_slice(src.weight.detach(), kind, rank,
                                      size), dev))
                if src.bias is not None:
                    _set(dst, "bias", place(_slice(
                        src.bias.detach(), split_kind(f"{name}.bias"),
                        rank, size), dev))
                continue
            for pname, p in src.named_parameters(recurse=False):
                _set(dst, pname, place(p.detach(), dev))
        shard.eval()
        shards.append(shard)
    return shards
