"""The port's metrics + tracing subsystem (counterpart of
mxnet_tpu.telemetry, its whole surface).

A process-global registry of named Counter/Gauge/Histogram instruments
(exponential-bucket histograms for latencies, prometheus-style labeled
children), `span(name)` tracing that nests, logs JSONL and, while a
torch.profiler session records, appears in its trace, and on-demand
device-memory sampling from the CUDA allocator. The serving engine
registers its counters, gauges and histograms here as per-engine
labeled children, under the reference's metric names; its `stats`
reads this engine's children.

Live introspection:
  * `serve(port)` — stdlib HTTP server on a daemon thread exposing
    /metrics, /healthz, /readyz, /statusz, /requests, /trace,
    /compilez, /memz, /sloz (and /fleetz, 404 without a collector);
  * `request_log` — per-request lifecycle timelines (bounded ring),
    `chrome_trace()` exports them (plus spans) as Chrome/Perfetto
    trace_event JSON;
  * `flight` — anomaly-triggered flight recorder: event ring +
    stall/queue-full/NaN/rebuild watchdog, atomic once-per-trigger
    dumps;
  * `cost` — device-cost accounting: model-formula FLOPs and bytes
    per dispatch timed with CUDA events, live MFU/roofline gauges,
    kernel-build attribution (`/compilez`);
  * `ledger` — HBM ledger: per-subsystem byte accounting reconciled
    against the allocator's live bytes (`/memz`);
  * `slo` — declarative SLOs on multi-window burn rates (`/sloz`).

Zero dependencies at import: this package touches only the stdlib —
torch is read only inside the calls that sample the card, and only
once the process runs CUDA.
"""
from __future__ import annotations

from .instruments import (  # noqa: F401
    Counter, Gauge, Histogram, Registry,
    DEFAULT_LATENCY_BUCKETS, exponential_buckets,
)
from .tracing import (  # noqa: F401
    span, events, clear_events, enable_jsonl, disable_jsonl,
    add_event_hook, remove_event_hook,
)
from .request_trace import (  # noqa: F401
    RequestTrace, RequestTraceLog, request_log, chrome_trace,
    PHASES, new_trace_id, new_span_id, parse_traceparent,
    format_traceparent, now,
)
from .server import (  # noqa: F401
    IntrospectionServer, serve, stop_server, get_server,
    register_status_provider, unregister_status_provider,
    collect_status, register_ready_probe, unregister_ready_probe,
    readiness, component_ready,
)
from . import cost  # noqa: F401
from . import flight  # noqa: F401
from . import ledger  # noqa: F401
from . import memory  # noqa: F401
from . import slo  # noqa: F401
from .slo import SLO, slo_engine  # noqa: F401

__all__ = ["Counter", "Gauge", "Histogram", "Registry",
           "DEFAULT_LATENCY_BUCKETS", "exponential_buckets",
           "default_registry", "counter", "gauge", "histogram", "get",
           "snapshot", "render_prometheus", "dump", "reset",
           "span", "events", "clear_events", "enable_jsonl",
           "disable_jsonl", "add_event_hook", "remove_event_hook",
           "RequestTrace", "RequestTraceLog", "request_log",
           "chrome_trace", "PHASES", "new_trace_id", "new_span_id",
           "parse_traceparent", "format_traceparent", "now",
           "SLO", "slo_engine", "slo",
           "IntrospectionServer", "serve",
           "stop_server", "get_server", "register_status_provider",
           "unregister_status_provider", "collect_status",
           "register_ready_probe", "unregister_ready_probe",
           "readiness", "component_ready",
           "cost", "flight", "ledger", "memory"]

#: The process-global registry every instrument of the port lives in.
default_registry = Registry()


def counter(name, help="", labelnames=()):
    """Get-or-create a Counter in the default registry."""
    return default_registry.counter(name, help, labelnames)


def gauge(name, help="", labelnames=()):
    """Get-or-create a Gauge in the default registry."""
    return default_registry.gauge(name, help, labelnames)


def histogram(name, help="", labelnames=(), buckets=None):
    """Get-or-create a Histogram in the default registry."""
    return default_registry.histogram(name, help, labelnames, buckets)


def get(name):
    """Look up an instrument by name (None when absent)."""
    return default_registry.get(name)


def snapshot():
    """Nested dict of every instrument's current state."""
    return default_registry.snapshot()


def render_prometheus():
    """Prometheus text exposition of the default registry."""
    return default_registry.render_prometheus()


def dump(path):
    """Write snapshot() as JSON to `path`; returns the path."""
    return default_registry.dump(path)


def reset():
    """Zero every instrument in place and clear the span + request
    rings (instrument/child identities survive — safe with live
    engines)."""
    default_registry.reset()
    clear_events()
    request_log.clear()
    slo.slo_engine.clear()
