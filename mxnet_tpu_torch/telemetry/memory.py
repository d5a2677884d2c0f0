"""Device-memory watermark sampling.

Counterpart of mxnet_tpu/telemetry/memory.py, under the same gauge
names, read on demand (a collect hook, never a hot path) from torch's
CUDA caching allocator:

  * `torch.cuda.memory_stats(dev)` — `allocated_bytes.all.current`
    (bytes in use) and `allocated_bytes.all.peak`; the device's
    capacity comes from `torch.cuda.mem_get_info(dev)`.
  * The live-bytes gauges (`memory_live_array_bytes`, its count and its
    process-lifetime peak). The reference walks `jax.live_arrays()`;
    torch has no cheap walk over its live tensors, so the port reads
    `torch.cuda.memory_allocated(dev)` — the bytes of every live tensor
    the caching allocator holds for this process — summed over devices,
    and the count is the number of devices read.

Nothing is sampled in a process that never initialized CUDA: a read
must never be what starts the card. `install()` registers sampling as a
registry collect hook so every snapshot()/render_prometheus() carries
fresh values; `sample()` takes one reading immediately and returns it.
"""
from __future__ import annotations

import sys

__all__ = ["sample", "install", "cuda_live"]

_live_peak = 0.0


def _gauges(registry):
    g = registry.gauge
    return {
        "in_use": g("memory_device_bytes_in_use",
                    "CUDA caching allocator bytes in use",
                    labelnames=("device",)),
        "peak": g("memory_device_peak_bytes",
                  "CUDA caching allocator peak bytes in use",
                  labelnames=("device",)),
        "limit": g("memory_device_bytes_limit",
                   "device memory capacity", labelnames=("device",)),
        "live_bytes": g("memory_live_array_bytes",
                        "bytes of live tensors on the CUDA devices "
                        "(torch.cuda.memory_allocated)"),
        "live_count": g("memory_live_array_count",
                        "CUDA devices whose live bytes were read"),
        "live_peak": g("memory_live_array_bytes_peak",
                       "process-lifetime max of the live tensor bytes"),
    }


def cuda_live():
    """The initialized `torch` module when this process already runs
    CUDA, else None (reads go through this so that no read starts the
    card)."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    try:
        return torch if torch.cuda.is_initialized() else None
    except Exception:
        return None


def sample(registry=None):
    """One reading: update the memory gauges, return them as a dict
    ({} when CUDA is not initialized)."""
    global _live_peak
    from . import default_registry
    torch = cuda_live()
    if torch is None:
        return {}
    gs = _gauges(registry or default_registry)
    out = {}
    n_bytes = 0
    n = 0
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        label = str(i)
        vals = {"bytes_in_use": stats.get("allocated_bytes.all.current"),
                "peak_bytes_in_use": stats.get("allocated_bytes.all.peak")}
        try:
            vals["bytes_limit"] = torch.cuda.mem_get_info(i)[1]
        except Exception:
            pass
        for key, stat in (("in_use", "bytes_in_use"),
                          ("peak", "peak_bytes_in_use"),
                          ("limit", "bytes_limit")):
            if vals.get(stat) is not None:
                gs[key].labels(label).set(vals[stat])
                out[f"{stat}[{label}]"] = vals[stat]
        n_bytes += torch.cuda.memory_allocated(i)
        n += 1
    _live_peak = max(_live_peak, float(n_bytes))
    gs["live_bytes"].set(n_bytes)
    gs["live_count"].set(n)
    gs["live_peak"].set(_live_peak)
    out.update(live_array_bytes=n_bytes, live_array_count=n,
               live_array_bytes_peak=_live_peak)
    return out


def install(registry=None):
    """Sample on every snapshot/render of the registry."""
    from . import default_registry
    reg = registry or default_registry
    reg.add_collect_hook(lambda: sample(reg))
