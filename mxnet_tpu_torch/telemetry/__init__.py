"""Metric instruments (counterpart of mxnet_tpu.telemetry, instruments
only).

The serving engine registers its counters, gauges and histograms here
as per-engine labeled children of process-global instruments, under the
reference's metric names; `ServingEngine.stats` reads this engine's
children. Spans, request timelines, the flight recorder, SLOs and the
introspection server are not ported yet.
"""
from .instruments import (DEFAULT_LATENCY_BUCKETS, Counter, Gauge,
                          Histogram, Registry, exponential_buckets)

__all__ = ["Counter", "Gauge", "Histogram", "Registry",
           "DEFAULT_LATENCY_BUCKETS", "exponential_buckets",
           "default_registry", "counter", "gauge", "histogram", "get",
           "snapshot"]

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
    """JSON-able view of every instrument in the default registry."""
    return default_registry.snapshot()
