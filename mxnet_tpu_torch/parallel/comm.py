"""Per-collective accounting of a step's communication.

Counterpart of mxnet_tpu/parallel/comm.py (`collective_summary`,
`ring_cost_bytes`, `comm_report`). The reference reads the collectives
out of a compiled program's HLO text; the port's mesh steps run their
collectives themselves and record each (parallel/collectives.py), so
`collective_summary` aggregates those records (a step's
`last_collectives`, the rows of its last call) and `comm_report` prices
them with the same ring byte model.

Usage:
    from mxnet_tpu_torch.parallel import comm_report
    print(comm_report(step))          # a TrainStep / PPTrainStep
"""
from __future__ import annotations

from .. import telemetry as _telemetry

__all__ = ["collective_summary", "comm_report", "ring_cost_bytes",
           "bytes_by_kind"]

_wire_bytes = _telemetry.gauge(
    "comm_wire_bytes_per_step",
    "ring-model wire bytes per link of the last analyzed step")
_wire_us = _telemetry.gauge(
    "comm_wire_us_per_step",
    "ring-model wire time (us) of the last analyzed step at the priced "
    "link bandwidth")
_collective_count = _telemetry.gauge(
    "comm_collectives_per_step",
    "collective ops in the last analyzed step", labelnames=("kind",))


def collective_summary(records):
    """Aggregate collective records ({kind, bytes, group} rows, as a
    step's `last_collectives`) by (kind, payload, group): a list of
    {kind, count, bytes, group}, the largest total first."""
    agg = {}
    for r in records:
        key = (r["kind"], int(r["bytes"]), r.get("group"))
        if key in agg:
            agg[key]["count"] += 1
        else:
            agg[key] = {"kind": key[0], "count": 1, "bytes": key[1],
                        "group": key[2]}
    return sorted(agg.values(), key=lambda r: -r["bytes"] * r["count"])


def ring_cost_bytes(kind, payload_bytes, n_devices):
    """Wire bytes PER LINK for one ring execution of the collective:
    all_reduce moves 2(n-1)/n of the payload, all_gather and
    reduce_scatter (n-1)/n, all_to_all (n-1)/n of the local shard,
    collective_permute exactly the payload."""
    n = max(int(n_devices), 1)
    if n == 1:
        return 0
    f = {"all_reduce": 2 * (n - 1) / n,
         "all_gather": (n - 1) / n,
         "reduce_scatter": (n - 1) / n,
         "all_to_all": (n - 1) / n,
         "collective_permute": 1.0}.get(kind, 1.0)
    return int(payload_bytes * f)


def _records_of(step):
    if isinstance(step, (list, tuple)):
        return list(step)
    return list(getattr(step, "last_collectives", ()))


def bytes_by_kind(step):
    """{kind: (payload bytes, ring wire bytes)} of the step's last call."""
    out = {}
    for r in _records_of(step):
        p, w = out.get(r["kind"], (0, 0))
        out[r["kind"]] = (p + r["bytes"],
                          w + ring_cost_bytes(r["kind"], r["bytes"],
                                              r.get("group") or 1))
    return out


def comm_report(step, link_gbps=100.0):
    """Human-readable per-collective budget of a step's last call.

    step: a TrainStep / PPTrainStep (its `last_collectives`) or a list
    of records. link_gbps prices the wire time per link (the
    reference's default ici_gbps)."""
    rows = collective_summary(_records_of(step))
    if not rows:
        _wire_bytes.set(0)
        _wire_us.set(0)
        return ("no collectives in the step (single-device or fully "
                "replicated step)")
    lines = [f"{'collective':20s} {'count':>5s} {'payload':>12s} "
             f"{'wire/link':>12s} {'~us @' + str(link_gbps) + 'GB/s':>14s}"]
    total_us, total_wire, kind_counts = 0.0, 0, {}
    for r in rows:
        wire = ring_cost_bytes(r["kind"], r["bytes"], r["group"] or 1)
        us = wire * r["count"] / (link_gbps * 1e3)
        total_us += us
        total_wire += wire * r["count"]
        kind_counts[r["kind"]] = kind_counts.get(r["kind"], 0) + r["count"]
        lines.append(f"{r['kind']:20s} {r['count']:5d} "
                     f"{r['bytes']:12,} {wire:12,} {us:14.1f}")
    mesh = getattr(step, "mesh", None)
    n_dev = mesh.size if mesh is not None else 1
    lines.append(f"total wire time ≈ {total_us:.1f} us/step over "
                 f"{n_dev} devices (ring model, no overlap credit)")
    _wire_bytes.set(total_wire)
    _wire_us.set(total_us)
    for kind, cnt in kind_counts.items():
        _collective_count.labels(kind).set(cnt)
    return "\n".join(lines)
