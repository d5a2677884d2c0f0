"""The port's metric instruments against the JAX package's.

mxnet_tpu_torch/telemetry/instruments.py is a copy of the JAX package's
(pure Python). The same operations on a fresh Registry of each must give
the same values: counter and gauge semantics (inc, set, dec, labeled
children, in-place reset), and Histogram.count / sum / percentile over
the same observations (latency-shaped, custom buckets, weighted counts,
overflow and the empty histogram), plus the registry's snapshot and
prometheus text.
"""
import math

import numpy as np
import pytest

from mxnet_tpu.telemetry import instruments as jax_inst
from mxnet_tpu_torch import telemetry as port_telemetry
from mxnet_tpu_torch.telemetry import instruments as port_inst


def _counter_gauge_trace(mod):
    reg = mod.Registry()
    c = reg.counter("requests_total", "requests", ("engine",))
    g = reg.gauge("queue_depth", "queued", ("engine",))
    out = []
    a, b = c.labels("0"), c.labels("1")
    a.inc()
    a.inc(4)
    b.inc(2.5)
    out.append((a.value, b.value))
    with pytest.raises(mod.MXNetError):
        a.inc(-1)                      # counters only go up
    qa = g.labels(engine="0")
    qa.set(7)
    qa.inc(3)
    qa.dec(4)
    out.append(qa.value)
    assert c.labels("0") is a          # children are interned
    reg.reset()
    out.append((a.value, b.value, qa.value))
    a.inc(2)
    out.append(a.value)
    return out, reg


def test_counter_and_gauge_semantics_equal_jax():
    jax_trace, jreg = _counter_gauge_trace(jax_inst)
    port_trace, preg = _counter_gauge_trace(port_inst)
    assert port_trace == jax_trace
    assert preg.snapshot() == jreg.snapshot()
    assert preg.render_prometheus() == jreg.render_prometheus()


def _observations(kind):
    rng = np.random.default_rng(5)
    if kind == "latency":
        return [float(x) for x in rng.lognormal(-4.0, 1.2, 400)], None
    if kind == "custom_buckets":
        return [float(x) for x in rng.uniform(0, 12, 300)], (1, 2, 4, 8)
    if kind == "overflow":
        return [1e-5, 3e-3, 200.0, 500.0, 0.5], None
    if kind == "single":
        return [0.0123], None
    return [], None


@pytest.mark.parametrize("kind", ["latency", "custom_buckets", "overflow",
                                  "single", "empty"])
def test_histogram_count_sum_and_percentiles_equal_jax(kind):
    obs, buckets = _observations(kind)
    hists = []
    for mod in (jax_inst, port_inst):
        h = mod.Registry().histogram("ttft_seconds", "ttft", ("engine",),
                                     buckets=buckets).labels("0")
        for i, x in enumerate(obs):
            h.observe(x, count=1 + i % 3)
        hists.append(h)
    jh, ph = hists
    assert ph.count == jh.count
    assert ph.sum == jh.sum
    for q in (0, 1, 10, 50, 90, 99, 99.9, 100):
        want, got = jh.percentile(q), ph.percentile(q)
        assert (math.isnan(want) and math.isnan(got)) or got == want, q
    assert ph.snapshot() == jh.snapshot()


def test_histogram_merge_and_reset_equal_jax():
    obs, _ = _observations("latency")
    out = []
    for mod in (jax_inst, port_inst):
        reg = mod.Registry()
        a = reg.histogram("a", "", ())
        b = reg.histogram("b", "", ())
        for x in obs[:150]:
            a.observe(x)
        for x in obs[150:]:
            b.observe(x)
        a.merge(b)
        row = [a.count, a.sum, a.percentile(50), a.percentile(99)]
        reg.reset()
        row += [a.count, a.sum, b.count]
        out.append(row)
    assert out[1] == out[0]


def test_default_registry_helpers_get_or_create():
    c = port_telemetry.counter("port_test_helpers_total", "x", ("engine",))
    assert port_telemetry.counter("port_test_helpers_total", "x",
                                  ("engine",)) is c
    assert port_telemetry.get("port_test_helpers_total") is c
    h = port_telemetry.histogram("port_test_helpers_seconds", "y")
    h.observe(0.5)
    assert port_telemetry.snapshot()["port_test_helpers_seconds"][
        "count"] == 1
    with pytest.raises(port_inst.MXNetError):
        port_telemetry.gauge("port_test_helpers_total")   # kind clash
