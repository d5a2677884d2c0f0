"""Cross-process serving fleet (counterpart of mxnet_tpu.serving.fleet):
worker processes behind a versioned wire protocol, with optional
disaggregated prefill/decode roles.

* `wire`     — the versioned migration blob (the in-process export/adopt
               contract, serialised byte for byte)
* `worker`   — `FleetWorker`: one ServingEngine behind the serving HTTP
               frontend plus the /fleet/* control plane; runnable as
               `python -m mxnet_tpu_torch.serving.fleet.worker`
* `client`   — `WorkerClient` RPC stubs and the WorkerGone /
               WorkerRejected failure taxonomy
* `router`   — `FleetRouter`: rendezvous placement, hedging, health
               watchdog, SIGKILL failover, prefill->decode handoff
* `launch`   — subprocess supervision (`spawn_worker`/`spawn_fleet`)
* `observe`  — `FleetCollector`: scrape and merge every worker's
               metrics (counters summed, gauges per worker, histograms
               bucket-wise), one clock-aligned Perfetto trace across
               processes, fleet-global SLOs, correlated fleet flight
               dumps, /fleetz
"""
from .wire import WIRE_VERSION, WireVersionError, encode_request, \
    decode_request
from .client import WorkerClient, WorkerGone, WorkerRejected
from .router import FleetRouter
from .launch import WorkerProc, FleetProcs, spawn_worker, spawn_fleet
from .observe import FleetCollector, fleet_chrome_trace

# the worker module is imported on first use, so that `python -m
# mxnet_tpu_torch.serving.fleet.worker` runs the one copy of it
_FROM_WORKER = ("FleetWorker", "build_engine", "warm_engine")


def __getattr__(name):
    if name in _FROM_WORKER:
        from . import worker
        return getattr(worker, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = [
    "WIRE_VERSION", "WireVersionError", "encode_request",
    "decode_request", "WorkerClient", "WorkerGone", "WorkerRejected",
    "FleetWorker", "build_engine", "warm_engine", "FleetRouter",
    "WorkerProc", "FleetProcs", "spawn_worker", "spawn_fleet",
    "FleetCollector", "fleet_chrome_trace",
]
