"""Collectives over the shards of one mesh axis, in one process.

The port's counterpart of the collectives XLA emits for the reference
(lax.psum / pmean / pmin, all_gather, psum_scatter, ppermute,
all_to_all). The reference runs one program per device and XLA moves the
bytes; here one process holds the per-shard tensors of an axis as a list
(one per shard, in axis order) and a collective is peer copies plus a
sum on the reduce device, as `TPGroup.all_reduce` does for serving:

  * psum / pmean / pmin: the partials summed (or min'd) on the first
    shard's device in shard order, in their dtype, then placed on every
    shard's device. A shard on the reduce device gets the result tensor
    itself (no copy), so on a repeated device list every copy is a no-op;
  * all_gather / reduce_scatter along a dimension (tiled, as the
    reference calls them);
  * ppermute over (source, destination) pairs (a shard that receives
    nothing gets zeros, as lax.ppermute gives);
  * all_to_all: shard j receives chunk j of every shard's split
    dimension, concatenated along the concat dimension in shard order.

Each is built of differentiable torch ops (copies, cat, sum, chunk), so
autograd carries a gradient through it the way the reference
differentiates through its collective: psum's is a psum, all_gather's a
reduce_scatter, all_to_all's the reverse all_to_all.

Every call is recorded as (kind, payload bytes, axis size) in the active
`recording()` lists, read by parallel/comm.py; the kinds are the
reference's HLO names (all_reduce, all_gather, reduce_scatter,
all_to_all, collective_permute). The payload is the bytes one shard
contributes (a gathered or scattered collective: the whole tensor), the
number the ring model of comm.ring_cost_bytes prices.

`Rendezvous` meets the threads of a mesh step's batch shards
(parallel/step.py) at a collective: each deposits its tensor, the first
shard's thread runs the collective over all of them once (one autograd
node set spanning every shard's graph), and each thread takes its own
result.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

import torch

from ..base import MXNetError
from .mesh import place

__all__ = ["psum", "pmean", "pmin", "all_gather", "reduce_scatter",
           "ppermute", "all_to_all", "record", "recording", "Rendezvous",
           "ShardContext"]

_lock = threading.Lock()
_active = []


def _nbytes(t):
    return int(t.numel() * t.element_size())


def record(kind, payload_bytes, axis_size, op=None):
    """Append one collective to every active recording."""
    if not _active:
        return
    row = {"kind": kind, "bytes": int(payload_bytes),
           "group": int(axis_size)}
    if op is not None:
        row["op"] = op
    with _lock:
        for lst in _active:
            lst.append(row)


@contextmanager
def recording():
    """Collect the collectives run inside the scope (every thread):
    yields the list of {kind, bytes, group[, op]} rows."""
    lst = []
    with _lock:
        _active.append(lst)
    try:
        yield lst
    finally:
        with _lock:
            _active.remove(lst)


def _devices(parts, devices):
    if devices is None:
        return [p.device for p in parts]
    devices = [torch.device(d) for d in devices]
    if len(devices) != len(parts):
        raise MXNetError(f"{len(parts)} shards for {len(devices)} devices")
    return devices


def _check(parts):
    if not parts:
        raise MXNetError("a collective needs at least one shard")
    shape = parts[0].shape
    for p in parts[1:]:
        if p.shape != shape:
            raise MXNetError(f"collective over unequal shards {shape} vs "
                             f"{p.shape}")


def _reduce(parts, devices, op):
    d0 = devices[0]
    acc = place(parts[0], d0)
    for p in parts[1:]:
        q = place(p, d0)
        acc = torch.minimum(acc, q) if op == "min" else acc + q
    return acc


def psum(parts, devices=None):
    """The sum of one partial per shard, on every shard's device."""
    _check(parts)
    devices = _devices(parts, devices)
    record("all_reduce", _nbytes(parts[0]), len(parts), "sum")
    acc = _reduce(parts, devices, "sum")
    return [place(acc, d) for d in devices]


def pmean(parts, devices=None):
    """psum / number of shards (float division in the partials' dtype)."""
    _check(parts)
    devices = _devices(parts, devices)
    record("all_reduce", _nbytes(parts[0]), len(parts), "mean")
    acc = _reduce(parts, devices, "sum") / len(parts)
    return [place(acc, d) for d in devices]


def pmin(parts, devices=None):
    _check(parts)
    devices = _devices(parts, devices)
    record("all_reduce", _nbytes(parts[0]), len(parts), "min")
    acc = _reduce(parts, devices, "min")
    return [place(acc, d) for d in devices]


def all_gather(parts, dim=0, devices=None, tiled=True):
    """Every shard's tensor concatenated along `dim` (tiled) or stacked
    on a new leading axis (tiled=False), on every shard's device."""
    _check(parts)
    devices = _devices(parts, devices)
    d0 = devices[0]
    full = torch.cat([place(p, d0) for p in parts], dim) if tiled else \
        torch.stack([place(p, d0) for p in parts], 0)
    record("all_gather", _nbytes(full), len(parts))
    return [place(full, d) for d in devices]


def reduce_scatter(parts, dim=0, devices=None):
    """The sum of the shards' tensors, split along `dim` into one chunk
    per shard (chunk i on shard i's device)."""
    _check(parts)
    devices = _devices(parts, devices)
    n = len(parts)
    if parts[0].shape[dim] % n:
        raise MXNetError(f"reduce_scatter: dim {dim} of size "
                         f"{parts[0].shape[dim]} over {n} shards")
    record("reduce_scatter", _nbytes(parts[0]), n)
    acc = _reduce(parts, devices, "sum")
    return [place(c, d) for c, d in zip(acc.chunk(n, dim), devices)]


def ppermute(parts, perm, devices=None):
    """out[dst] = parts[src] for each (src, dst) pair of `perm`; a shard
    that receives nothing gets zeros."""
    _check(parts)
    devices = _devices(parts, devices)
    record("collective_permute", _nbytes(parts[0]), len(parts))
    out = [None] * len(parts)
    for src, dst in perm:
        out[dst] = place(parts[src], devices[dst])
    return [o if o is not None else torch.zeros_like(parts[i],
                                                     device=devices[i])
            for i, o in enumerate(out)]


def all_to_all(parts, split_dim, concat_dim, devices=None):
    """Shard j gets chunk j (along `split_dim`) of every shard's tensor,
    concatenated along `concat_dim` in shard order (tiled)."""
    _check(parts)
    devices = _devices(parts, devices)
    n = len(parts)
    if parts[0].shape[split_dim] % n:
        raise MXNetError(f"all_to_all: dim {split_dim} of size "
                         f"{parts[0].shape[split_dim]} over {n} shards")
    record("all_to_all", _nbytes(parts[0]), n)
    chunks = [p.chunk(n, split_dim) for p in parts]
    return [torch.cat([place(chunks[i][j], devices[j]) for i in range(n)],
                      concat_dim) for j in range(n)]


class Rendezvous:
    """The meeting point of `n` shard threads (see the module doc)."""

    def __init__(self, n):
        self.n = int(n)
        self._barrier = threading.Barrier(self.n)
        self._slots = [None] * self.n
        self._out = None

    def exchange(self, rank, value, fn):
        """Deposit `value`; the thread of rank 0 runs fn(values) (a list
        with one result per rank); return this rank's result."""
        if self.n == 1:
            return fn([value])[0]
        self._slots[rank] = value
        self._barrier.wait()
        if rank == 0:
            try:
                self._out = fn(list(self._slots))
            except BaseException as e:  # every peer raises it
                self._out = e
        self._barrier.wait()
        out = self._out
        if isinstance(out, BaseException):
            raise MXNetError(f"collective failed on shard 0: {out!r}")
        return out[rank]

    def abort(self):
        """Release every thread waiting here (a peer failed)."""
        self._barrier.abort()

    def reset(self):
        """Make the meeting point usable again after an abort (called
        before each run of the shard threads, while none waits here)."""
        self._barrier.reset()
        self._slots = [None] * self.n
        self._out = None


class ShardContext:
    """One batch shard of a running mesh step (see mesh.shard_context):
    `rank` of `size` along the batch axes, its device, the mesh, and
    whether the step keeps per-shard semantics (`per_shard`: the 2-bit
    step, whose BatchNorm statistics, dropout streams and gating stay on
    the shard, as the reference's shard_map does)."""

    def __init__(self, mesh, rank, size, device, rendezvous, devices,
                 per_shard=False, coords=None):
        self.mesh = mesh
        self.coords = dict(coords or {})
        self.rank = rank
        self.size = size
        self.device = device
        self.devices = devices
        self.per_shard = per_shard
        self._rv = rendezvous

    @property
    def spans_batch(self):
        """True when the ops must see the global batch across shards."""
        return self.size > 1 and not self.per_shard

    def psum(self, t):
        """psum over the batch shards (differentiable)."""
        return self._rv.exchange(self.rank, t,
                                 lambda ts: psum(ts, self.devices))

    def all_gather(self, t, dim=0):
        """all_gather over the batch shards along `dim` (differentiable)."""
        return self._rv.exchange(
            self.rank, t, lambda ts: all_gather(ts, dim, self.devices))
