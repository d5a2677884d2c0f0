"""Device / Context layer.

Counterpart of mxnet_tpu/device.py: `Device` (alias `Context`), `cpu()`,
`gpu(i)`, `num_gpus()`, `default_device()` and the `with ctx:` scope.
A Device names a torch device: `cpu()` is the host, `gpu(i)` the i-th
CUDA card. The default device is the card, as `base.resolve_device`
makes it: without a card, resolving it raises instead of continuing on
the CPU. `tpu()` has no counterpart on this stack and raises.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError, resolve_device

__all__ = ["Device", "Context", "cpu", "cpu_pinned", "cpu_shared", "gpu",
           "tpu", "num_gpus", "num_tpus", "default_device", "current_device",
           "current_context", "from_torch_device", "gpu_memory_info"]


class _Scopes(threading.local):
    def __init__(self):
        self.stack = []


_scopes = _Scopes()


class Device:
    """A compute device (parity: mxnet.context.Context). device_type is
    'cpu' or 'gpu'; 'cpu_pinned' and 'cpu_shared' are accepted as 'cpu'."""

    _ALIASES = {"cpu_pinned": "cpu", "cpu_shared": "cpu"}

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Device):
            device_type, device_id = device_type.device_type, \
                device_type.device_id
        device_type = self._ALIASES.get(device_type, device_type)
        if device_type == "tpu":
            raise MXNetError("tpu() has no device on this stack; use gpu()")
        if device_type not in ("cpu", "gpu"):
            raise MXNetError(f"unknown device type {device_type!r}")
        self.device_type = device_type
        self.device_id = int(device_id)

    @property
    def device_typeid(self):
        return {"cpu": 1, "gpu": 2}[self.device_type]

    @property
    def torch_device(self):
        """The torch.device; a card that is absent raises."""
        if self.device_type == "cpu":
            return torch.device("cpu")
        if self.device_id >= max(num_gpus(), 1):
            raise MXNetError(f"gpu({self.device_id}) out of range: "
                             f"{num_gpus()} card(s) present")
        return resolve_device(f"cuda:{self.device_id}")

    def __eq__(self, other):
        return (isinstance(other, Device)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"

    def __enter__(self):
        _scopes.stack.append(self)
        return self

    def __exit__(self, *exc):
        _scopes.stack.pop()

    def empty_cache(self):
        if self.device_type == "gpu" and torch.cuda.is_available():
            torch.cuda.empty_cache()

    def memory_info(self):
        """(free_bytes, total_bytes) of a card; (None, None) for the CPU."""
        if self.device_type == "cpu":
            return (None, None)
        return torch.cuda.mem_get_info(self.torch_device)


Context = Device


def cpu(device_id=0):
    return Device("cpu", device_id)


cpu_pinned = cpu
cpu_shared = cpu


def gpu(device_id=0):
    return Device("gpu", device_id)


def tpu(device_id=0):
    raise MXNetError("tpu() has no device on this stack; use gpu()")


def num_gpus():
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def num_tpus():
    return 0


def default_device():
    """The innermost `with device:` scope's device, else gpu(0). The
    reference defaults to cpu(0); the port's default is the card."""
    return _scopes.stack[-1] if _scopes.stack else gpu(0)


current_device = default_device
current_context = default_device


def from_torch_device(dev):
    dev = torch.device(dev)
    if dev.type == "cpu":
        return cpu(0)
    if dev.type == "cuda":
        return gpu(dev.index if dev.index is not None
                   else torch.cuda.current_device())
    raise MXNetError(f"no Device for torch device {dev}")


def to_torch(ctx):
    """ctx (a Device, a torch.device or string, or None for the default
    device) as a torch.device."""
    if ctx is None:
        ctx = default_device()
    if isinstance(ctx, (list, tuple)):
        ctx = ctx[0] if ctx else default_device()
    if isinstance(ctx, Device):
        return ctx.torch_device
    return resolve_device(ctx)


def gpu_memory_info(device_id=0):
    return gpu(device_id).memory_info()
