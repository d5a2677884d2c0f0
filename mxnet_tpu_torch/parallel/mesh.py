"""The device mesh, its axis names and partition specs, and the serving
engine's tensor-parallel device list.

Counterpart of mxnet_tpu/parallel/mesh.py. The reference's mesh is a
jax.sharding.Mesh over named axes, and XLA's partitioner places the
collectives a PartitionSpec implies. Here a `Mesh` is a named grid of
torch.device that the port's parallel code reads itself
(parallel/step.py places shards and runs collectives,
parallel/collectives.py). A device may repeat: ["cpu"] * 8 or
["cuda:0"] * N runs N shards on one device, the counterpart of the
reference's forced virtual device count
(XLA_FLAGS=--xla_force_host_platform_device_count=N).

Axis names: "dp" data parallel, "fsdp" sharded-parameter data parallel,
"tp" tensor parallel, "sp" sequence parallel, "pp" pipeline stages,
"ep" expert parallel. An absent axis has size 1.

`shard_context()` is the running shard of a mesh step: the thread of one
batch shard (parallel/step.py), with its coordinates and the rendezvous
of its peers, read by the ops that need the other shards (BatchNorm's
batch statistics, MoE gating, dropout masks of the global batch).
"""
from __future__ import annotations

import math
import threading
from contextlib import contextmanager

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["Mesh", "PartitionSpec", "NamedSharding", "make_mesh",
           "current_mesh", "mesh_scope", "set_default_mesh",
           "named_sharding", "axis_enabled", "shard_context",
           "serving_tp_devices", "place",
           "AXIS_DP", "AXIS_TP", "AXIS_PP", "AXIS_SP", "AXIS_EP",
           "AXIS_FSDP"]

AXIS_DP, AXIS_FSDP, AXIS_TP = "dp", "fsdp", "tp"
AXIS_SP, AXIS_PP, AXIS_EP = "sp", "pp", "ep"


def place(t, device):
    """`t` on `device`: the tensor itself when it is there already."""
    return t if t.device == device else t.to(device)


def _canon(d):
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class PartitionSpec(tuple):
    """Per-dimension mesh axes of a tensor: an axis name, a tuple of
    names, or None (that dimension is not split). P("tp", None) splits
    dimension 0 over "tp"; P() is replicated."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return "PartitionSpec" + super().__repr__()


class Mesh:
    """A named grid of torch.device: `devices` is a numpy object array
    whose dimensions are `axis_names` in order."""

    def __init__(self, devices, axis_names):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise MXNetError(f"mesh grid of rank {self.devices.ndim} for "
                             f"axes {self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return int(self.devices.size)

    @property
    def device_list(self):
        """Every position's device, in row-major order (repeats kept)."""
        return list(self.devices.reshape(-1))

    def axis_size(self, axis):
        """The size of `axis` (1 when absent), or the product of a tuple
        of axes."""
        if axis is None:
            return 1
        if isinstance(axis, (tuple, list)):
            return math.prod(self.axis_size(a) for a in axis)
        return self.shape.get(axis, 1)

    def device_at(self, **coords):
        """The device of the position with `coords` (absent axes 0)."""
        idx = tuple(int(coords.get(a, 0)) for a in self.axis_names)
        return self.devices[idx]

    def __repr__(self):
        return f"Mesh({self.shape})"


class NamedSharding:
    """A spec over a mesh (parity: jax.sharding.NamedSharding)."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = spec if spec is not None else PartitionSpec()

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


class _MeshState(threading.local):
    def __init__(self):
        self.stack = []
        self.default = None
        self.shard = None


_state = _MeshState()


def make_mesh(axes=None, devices=None, **axis_sizes):
    """A named-axis mesh: make_mesh({"dp": 4, "tp": 2}) or make_mesh(dp=4,
    tp=2). A size of -1 (one axis at most) takes the remaining devices.

    devices: None takes the first CUDA devices the axes need and raises
    when there are fewer (it never drops to the CPU); else any sequence
    of torch.device or device strings, all of which the mesh covers, as
    the reference's does. A device may repeat (["cuda:0"] * 8,
    ["cpu"] * 8)."""
    if axes is None:
        axes = axis_sizes
    elif axis_sizes:
        raise MXNetError("pass axes either as a dict or as kwargs, not both")
    if not axes:
        raise MXNetError("mesh needs at least one named axis")
    names = list(axes.keys())
    sizes = [int(s) for s in axes.values()]
    if sizes.count(-1) > 1:
        raise MXNetError("at most one mesh axis may be -1")
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        want = n if -1 in sizes else math.prod(sizes)
        if want > n or n == 0:
            raise MXNetError(
                f"mesh {axes} wants {want or 'some'} devices, have {n} "
                f"CUDA devices (one card, or the CPU, takes a repeated "
                f"device list: devices=['cuda:0'] * N or ['cpu'] * N)")
        devices = [torch.device("cuda", i) for i in range(want)]
    devices = [_canon(d) for d in devices]
    n_dev = len(devices)
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        if n_dev % known:
            raise MXNetError(
                f"{n_dev} devices not divisible by fixed axes {axes}")
        sizes[sizes.index(-1)] = n_dev // known
    total = math.prod(sizes)
    if total != n_dev:
        raise MXNetError(
            f"mesh {dict(zip(names, sizes))} wants {total} devices, "
            f"have {n_dev}")
    arr = np.empty(total, dtype=object)
    for i, d in enumerate(devices):
        arr[i] = d
    return Mesh(arr.reshape(sizes), names)


def set_default_mesh(mesh):
    _state.default = mesh


def current_mesh():
    if _state.stack:
        return _state.stack[-1]
    if _state.shard is not None:
        return _state.shard.mesh
    return _state.default


@contextmanager
def mesh_scope(mesh):
    _state.stack.append(mesh)
    try:
        yield mesh
    finally:
        _state.stack.pop()


def axis_enabled(mesh=None, axis=AXIS_TP):
    """True iff an active (or given) mesh has a real (size > 1) named
    axis."""
    mesh = mesh if mesh is not None else current_mesh()
    return (mesh is not None and axis in mesh.axis_names
            and mesh.shape[axis] > 1)


def named_sharding(spec, mesh=None):
    mesh = mesh or current_mesh()
    if mesh is None:
        raise MXNetError("no active mesh; call make_mesh + mesh_scope / "
                         "set_default_mesh first")
    return NamedSharding(mesh, spec)


def shard_context():
    """The running mesh-step shard of this thread (parallel/step.py
    `ShardContext`), or None."""
    return _state.shard


@contextmanager
def _shard_scope(ctx):
    prev = _state.shard
    _state.shard = ctx
    try:
        yield ctx
    finally:
        _state.shard = prev


def serving_tp_devices(tp, devices=None):
    """The shard devices of a tp-way serving engine: None at tp == 1 (the
    unsharded engine takes no device list), else a list of `tp`
    torch.device.

    devices: None takes the first `tp` CUDA devices; else any sequence of
    torch.device or device strings (a fleet spec carries them through
    JSON), of which the first `tp` are used. Too few raise. A device may
    repeat: ["cpu"] * N or ["cuda:0"] * N runs N shards on one device."""
    tp = int(tp)
    if tp < 1:
        raise MXNetError(f"tp must be >= 1, got {tp}")
    if tp == 1:
        return None
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [torch.device(d) for d in devices]
    if tp > len(devices):
        raise MXNetError(
            f"serving tp={tp} needs {tp} devices, have {len(devices)} "
            f"(one card, or the CPU, takes a repeated device list: "
            f"tp_devices=['cuda:0'] * {tp} or ['cpu'] * {tp})")
    return [_canon(d) for d in devices[:tp]]
