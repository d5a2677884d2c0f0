"""mx.kvstore: the KVStore over torch.distributed.

Counterpart of mxnet_tpu/kvstore.py (`init_distributed`, `KVStore`,
`_DistSyncKVStore`, `create`, `set_gradient_compression`):
KVStore::Create("local" / "device" / "nccl" / "dist_sync" /
"dist_sync_device" / "dist") with init / push / pull / pushpull /
broadcast and an optional updater.

  * "local", "device", "nccl" (and the reference's aliases): one
    process; values pushed for a key are summed (a list is one value a
    device), and without an updater the sum replaces the stored value;
  * "dist_sync", "dist_sync_device", "dist": one process a worker over a
    torch.distributed group, the sum all_reduced across the workers.
    The group is `init_distributed`'s: gloo serves CPU tensors and NCCL
    CUDA tensors (backend "cpu:gloo,cuda:nccl" where the process has a
    card, "gloo" where it has none). A group whose NCCL side cannot form
    raises; nothing falls back to gloo for a CUDA tensor;
  * "dist_async" and `row_sparse_pull` raise, as the reference does.

The env contract is the reference's launcher's (tools/launch.py):
DMLC_PS_ROOT_URI / DMLC_PS_ROOT_PORT (rank 0's address, the group's
tcp:// rendezvous), DMLC_NUM_WORKER (world size), DMLC_WORKER_ID (rank).
With the address set a group forms even of one worker.

A pull writes the value into its `out` in place (an NDArray's tensor, a
parameter's gradient), cast to its dtype. Gradient compression
(`set_gradient_compression({'type': '2bit', 'threshold': t})` or
`{'type': 'int8', 'block': n}`) applies on the cross-worker reduce: each
worker compresses (with its per-key residual), the payloads are
all_gathered and each is decompressed and summed; the bytes metered are
the compressor's `wire_bytes`.
"""
from __future__ import annotations

import atexit
import os
import time as _time
import warnings

import torch

from . import telemetry as _telemetry
from .base import MXNetError

_allreduce_bytes = _telemetry.counter(
    "kvstore_allreduce_bytes_total",
    "payload bytes through the cross-worker kvstore allreduce",
    labelnames=("store",))
_allreduce_seconds = _telemetry.histogram(
    "kvstore_allreduce_seconds",
    "wall time of one cross-worker kvstore allreduce",
    labelnames=("store",))
_bcast_bytes = _telemetry.counter(
    "kvstore_broadcast_bytes_total",
    "payload bytes through kvstore root broadcast", labelnames=("store",))
_pushpull_total = _telemetry.counter(
    "kvstore_pushpull_total", "kvstore pushpull key-operations",
    labelnames=("store",))

__all__ = ["KVStore", "create", "init_distributed", "KVStoreBase"]

_DESCOPE_ASYNC = (
    "kvstore type 'dist_async' is not supported: the reference's "
    "parameter-server HogWild mode has no counterpart here and "
    "synchronous data parallelism is strictly dominant on dedicated "
    "devices; use 'dist_sync'")


def _backend():
    return "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"


def init_distributed(coordinator=None, num_processes=None, process_id=None,
                     backend=None):
    """Form the worker group (idempotent): returns (rank, size).

    Reads the reference launcher's env where the arguments are omitted:
    DMLC_PS_ROOT_URI / DMLC_PS_ROOT_PORT (coordinator "host:port"),
    DMLC_NUM_WORKER, DMLC_WORKER_ID. Without a coordinator there is no
    group: (0, 1). backend: default gloo for CPU tensors plus NCCL for
    CUDA tensors where the process has a card; a failure to form the
    group raises."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if coordinator is None:
        uri = os.environ.get("DMLC_PS_ROOT_URI")
        port = os.environ.get("DMLC_PS_ROOT_PORT")
        if uri and port:
            coordinator = f"{uri}:{port}"
    if num_processes is None:
        num_processes = int(os.environ.get("DMLC_NUM_WORKER", "1"))
    if process_id is None:
        process_id = int(os.environ.get("DMLC_WORKER_ID", "0"))
    if coordinator is None:
        return 0, 1
    if not dist.is_available():
        raise MXNetError("torch.distributed is not available in this build")
    backend = backend or _backend()
    if "nccl" in backend and torch.cuda.is_available():
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    try:
        dist.init_process_group(backend=backend,
                                init_method=f"tcp://{coordinator}",
                                world_size=int(num_processes),
                                rank=int(process_id))
    except Exception as e:
        raise MXNetError(f"kvstore: the {backend} worker group at "
                         f"{coordinator} did not form: {e}") from e
    # a group still alive at interpreter exit can abort the process from
    # its backend's threads (gloo's "terminate called"), so the group
    # this call formed is torn down first
    atexit.register(_destroy_group)
    return dist.get_rank(), dist.get_world_size()


def _destroy_group():
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


class KVStoreBase:
    """Backend registry (parity: the reference's kvstore/base.py)."""

    _backends = {}

    @classmethod
    def register(cls, klass):
        cls._backends[klass.__name__.lower()] = klass
        return klass


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


def _tensor(v):
    from .ndarray.ndarray import NDArray
    if isinstance(v, NDArray):
        return v._data
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(v)


def _write(out, value):
    """The value into `out` (an NDArray or a tensor), in place."""
    dst = _tensor(out)
    with torch.no_grad():
        dst.copy_(value.to(dst.device, dst.dtype))
    if hasattr(out, "_version"):
        out._version += 1


@KVStoreBase.register
class KVStore:
    """The single-process store ("local" / "device" / "nccl") and the base
    of the worker-group store. Pushed values for a key are summed; with
    no updater the sum replaces the stored value, with one
    `updater(key, merged, stored)` runs on the stored value."""

    def __init__(self, type_name="local"):
        self._type = type_name
        self._store = {}
        self._updater = None
        self._updater_obj = None
        self._optimizer = None
        self._compression = None
        self._compressor = None

    @property
    def type(self):
        return self._type

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    # -- reduction core (the worker-group store overrides) ---------------
    def _allreduce(self, t, key=None):
        return t

    def _bcast_from_root(self, t):
        return t

    def _merge(self, value, key=None):
        ts = [_tensor(v) for v in _as_list(value)]
        merged = ts[0].detach().clone()
        for t in ts[1:]:
            merged = merged + t.to(merged.device)
        return self._allreduce(merged, key)

    @staticmethod
    def _pairs(key, value):
        keys = _as_list(key)
        if len(keys) == 1:
            return [(keys[0], value)]
        return list(zip(keys, value))

    # -- API -----------------------------------------------------------------
    def init(self, key, value):
        for k, v in self._pairs(key, value):
            v0 = _tensor(_as_list(v)[0])
            self._store[k] = self._bcast_from_root(v0.detach().clone())

    def push(self, key, value, priority=0):
        from .ndarray.ndarray import NDArray
        for k, v in self._pairs(key, value):
            if k not in self._store:
                raise MXNetError(f"key {k!r} not initialized; call init()")
            merged = self._merge(v, k)
            if self._updater is not None:
                stored = NDArray(self._store[k])
                self._updater(k, NDArray(merged), stored)
                self._store[k] = stored._data
            else:
                self._store[k] = merged

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        if out is None:
            raise MXNetError("pull requires out= (an NDArray or list to "
                             "receive the value)")
        results = []
        for k, o in self._pairs(key, out):
            if k not in self._store:
                raise MXNetError(f"key {k!r} not initialized; call init()")
            for oo in _as_list(o):
                _write(oo, self._store[k])
            results.append(o)
        return results[0] if len(results) == 1 else results

    def pushpull(self, key, value, out=None, priority=0):
        """Fused push + pull: with no updater the reduced sum replaces the
        stored value and lands in `out` (default: `value` itself)."""
        if out is None:
            out = value
        if self._updater is None:
            vp = dict(self._pairs(key, value))
            for k, o in self._pairs(key, out):
                if k not in self._store:
                    raise MXNetError(
                        f"key {k!r} not initialized; call init()")
                merged = self._merge(vp[k], k)
                self._store[k] = merged
                for oo in _as_list(o):
                    _write(oo, merged)
                _pushpull_total.labels(self._type).inc()
            return out
        self.push(key, value, priority)
        return self.pull(key, out=out, priority=priority)

    def broadcast(self, key, value, out=None, priority=0):
        """Rank 0's value to every worker."""
        self.init(key, value)
        if out is not None:
            return self.pull(key, out=out, priority=priority)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        raise MXNetError("row_sparse_pull: sparse storage is not ported "
                         "(dense only)")

    # -- updater / optimizer ---------------------------------------------------
    def set_updater(self, updater):
        self._updater = updater

    def set_optimizer(self, optimizer):
        """update_on_kvstore: the optimizer runs where the values live."""
        from . import optimizer as _opt
        self._optimizer = optimizer
        self._updater_obj = _opt.get_updater(optimizer)
        self._updater = self._updater_obj

    def set_gradient_compression(self, compression_params):
        """{'type': '2bit', 'threshold': t} or {'type': 'int8', 'block':
        n}; applied on the cross-worker reduce (a one-worker store has
        no wire: it records the setting and warns)."""
        self._compression = dict(compression_params or {})
        if not self._compression:
            self._compressor = None
            return
        if "type" not in self._compression:
            raise MXNetError(
                "compression_params requires a 'type' key (the reference "
                "rejects it too); use {'type': '2bit', 'threshold': t}")
        ctype = self._compression["type"]
        if ctype == "2bit":
            from .gradient_compression import TwoBitCompressor
            self._compressor = TwoBitCompressor(
                float(self._compression.get("threshold", 0.5)))
        elif ctype == "int8":
            from .gradient_compression import Int8BlockCompressor
            self._compressor = Int8BlockCompressor(
                int(self._compression.get("block", 256)))
        else:
            raise MXNetError(
                f"unsupported gradient compression type {ctype!r} "
                "('2bit' or 'int8')")
        if self.num_workers == 1:
            warnings.warn(
                "gradient compression set on a single-process kvstore: "
                "nothing to compress (no cross-process wire)", stacklevel=2)

    def save_optimizer_states(self, fname, dump_optimizer=False):
        if self._optimizer is None:
            raise MXNetError("no optimizer installed on this kvstore")
        with open(fname, "wb") as f:
            f.write(self._updater_obj.get_states(
                dump_optimizer=dump_optimizer))

    def load_optimizer_states(self, fname):
        if self._optimizer is None:
            raise MXNetError("no optimizer installed on this kvstore")
        with open(fname, "rb") as f:
            self._updater_obj.set_states(f.read())


class _DistSyncKVStore(KVStore):
    """The synchronous worker-group store over torch.distributed."""

    def __init__(self, type_name="dist_sync"):
        super().__init__(type_name)
        self._rank, self._size = init_distributed()
        import torch.distributed as dist
        self._group = dist.is_initialized()

    @property
    def rank(self):
        return self._rank

    @property
    def num_workers(self):
        return self._size

    def _allreduce(self, t, key=None):
        if not self._group:
            return t
        import torch.distributed as dist
        t0 = _time.perf_counter()
        comp = self._compressor
        if comp is not None and key is not None and t.numel() >= 16:
            payload = comp.compress(key, t)
            wire = payload.view(torch.uint8) if payload.dtype != \
                torch.uint8 else payload
            parts = [torch.empty_like(wire) for _ in range(self._size)]
            dist.all_gather(parts, wire.contiguous())
            total = None
            for part in parts:
                d = comp.decompress(part.view(payload.dtype), t.shape)
                total = d if total is None else total + d
            _allreduce_bytes.labels(self._type).inc(
                int(comp.wire_bytes(t.shape)))
            _allreduce_seconds.labels(self._type).observe(
                _time.perf_counter() - t0)
            return total.to(t.dtype)
        out = t.contiguous().clone()
        dist.all_reduce(out)
        _allreduce_bytes.labels(self._type).inc(
            int(t.numel() * t.element_size()))
        _allreduce_seconds.labels(self._type).observe(
            _time.perf_counter() - t0)
        return out

    def _bcast_from_root(self, t):
        if not self._group:
            return t
        import torch.distributed as dist
        out = t.contiguous().clone()
        dist.broadcast(out, 0)
        _bcast_bytes.labels(self._type).inc(
            int(t.numel() * t.element_size()))
        return out

    def barrier(self):
        if self._group:
            import torch.distributed as dist
            dist.barrier()


def create(name="local"):
    """Parity: mx.kv.create. Types: local | device | nccl (one process),
    dist_sync | dist_sync_device | dist (a worker group), dist_async
    (raises)."""
    if not isinstance(name, str):
        raise MXNetError("kvstore name must be a string")
    name = name.lower()
    if name in ("local", "device", "nccl", "local_allreduce_cpu",
                "local_allreduce_device"):
        return KVStore(name)
    if name in ("dist_sync", "dist_sync_device", "dist"):
        return _DistSyncKVStore(name)
    if name == "dist_async":
        raise MXNetError(_DESCOPE_ASYNC)
    if name in KVStoreBase._backends:
        return KVStoreBase._backends[name]()
    raise MXNetError(f"unknown kvstore type {name!r}")
