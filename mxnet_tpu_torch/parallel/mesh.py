"""The serving engine's tensor-parallel device list.

Counterpart of mxnet_tpu/parallel/mesh.py `serving_tp_mesh`. The
reference builds a one-axis {tp: N} mesh over the first N local devices
and runs the dispatch under `shard_map`; the port runs the same split in
one process over a plain list of shard devices (parallel/tp.py), so the
"mesh" here is that list.
"""
from __future__ import annotations

import torch

from ..base import MXNetError

__all__ = ["serving_tp_devices", "place"]


def place(t, device):
    """`t` on `device`: the tensor itself when it is there already."""
    return t if t.device == device else t.to(device)


def serving_tp_devices(tp, devices=None):
    """The shard devices of a tp-way serving engine: None at tp == 1 (the
    unsharded engine takes no device list), else a list of `tp`
    torch.device.

    devices: None takes the first `tp` CUDA devices; else any sequence of
    torch.device or device strings (a fleet spec carries them through
    JSON), of which the first `tp` are used. Too few raise. A device may
    repeat: ["cpu"] * N or ["cuda:0"] * N runs N shards on one device,
    the port's counterpart of the reference's forced virtual device
    count (XLA_FLAGS=--xla_force_host_platform_device_count=N)."""
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
    out = []
    for d in devices[:tp]:
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        out.append(d)
    return out
