"""Versioned wire format for cross-process request migration.

Counterpart of mxnet_tpu/serving/fleet/wire.py, the same blob: what the
in-process migration contract moves on a `Request` (the engine's
export_requests / adopt: prompt and emitted tokens, the sampling knobs
that key the per-request sampling stream, `kv_history` for the int8
replay contract, the trace stitch {trace_id, t_begin}, the accumulated
TTFT phases) plus the optional KV handoff payload (the engine's
export_handoff: the request's used KV pages and decode-cursor scalars),
serialised to a JSON-safe dict. Arrays travel as {dtype, shape, base64}
triples under an `__nd__` key, and `dumps` sorts keys, so a blob of the
same request is the same bytes whichever package wrote it.

bfloat16 has no numpy dtype. The port's KV tier holds bfloat16 pages as
their 2-byte bit patterns (int16, dtype string '<i2'), and that is how
they travel. The reference writes such a leaf with its ml_dtypes dtype
string '<V2', which decodes as an opaque 2-byte void ('|V2'). Decode
keeps each leaf's dtype as written (so a blob re-encodes to its own
bytes); the adopting engine accepts a 2-byte '<i2' or '|V2' leaf where
its pages are bfloat16 and views its bits as bfloat16.

Version discipline: `WIRE_VERSION` bumps on any change to the blob
layout. A worker handed a blob of another version refuses it with
`WireVersionError` (the fleet worker answers HTTP 409 with a structured
body): adopting a half-understood blob could corrupt KV state silently,
where refusing lets the router fall back to the replay restart.
"""
from __future__ import annotations

import base64
import json

import numpy as np

from ...base import MXNetError
from ..scheduler import Request

__all__ = ["WIRE_VERSION", "WireVersionError", "encode_request",
           "decode_request", "check_version", "dumps", "loads"]

#: Schema version of the migration blob. Bump on ANY layout change.
WIRE_VERSION = 1


class WireVersionError(MXNetError):
    """A blob whose `wire_version` this build does not speak. The
    receiver rejects it; the sender falls back to the replay restart,
    which is bit-identical anyway."""

    def __init__(self, got, want=WIRE_VERSION):
        super().__init__(
            f"wire schema version {got!r} != {want}: refusing to adopt "
            "(a mismatched worker rejects rather than risk corrupting "
            "KV state)")
        self.got = got
        self.want = want


def _nd_enc(arr):
    a = np.ascontiguousarray(arr)
    return {"__nd__": {
        "dtype": a.dtype.str,
        "shape": list(a.shape),
        "data": base64.b64encode(a.tobytes()).decode("ascii"),
    }}


def _nd_dec(obj):
    nd = obj["__nd__"]
    a = np.frombuffer(base64.b64decode(nd["data"]),
                      dtype=np.dtype(nd["dtype"]))
    return a.reshape([int(s) for s in nd["shape"]]).copy()


def _payload(kvp, leaf):
    return {
        "length": int(kvp["length"]),
        "cur_tok": int(kvp["cur_tok"]),
        "remaining": int(kvp["remaining"]),
        "counters": int(kvp["counters"]),
        "t_export": float(kvp["t_export"]),
        "pages": [{name: leaf(v) for name, v in page.items()}
                  for page in kvp["pages"]],
    }


def encode_request(req):
    """Request -> JSON-safe dict covering the whole migration contract.
    `kv_payload` (set by the engine's export_handoff) rides along when
    present; `req.stream` and the submitting engine's clock fields
    (`t_submit`, deadlines in its clock domain) do not: clocks do not
    cross processes, and the adopting engine starts its own."""
    d = {
        "wire_version": WIRE_VERSION,
        "id": str(req.id),
        "prompt": [int(t) for t in req.prompt],
        "max_new_tokens": int(req.max_new_tokens),
        "do_sample": bool(req.do_sample),
        "temperature": float(req.temperature),
        "top_k": int(req.top_k),
        "top_p": float(req.top_p),
        "seed": int(req.seed),
        "eos_token_id": (None if req.eos_token_id is None
                         else int(req.eos_token_id)),
        "priority": int(req.priority),
        "deadline_ms": (None if req.deadline_ms is None
                        else float(req.deadline_ms)),
        "adapter_id": req.adapter_id,
        "tenant": req.tenant,
        "status": str(req.status),
        "output_tokens": [int(t) for t in req.output_tokens],
        "phases": {str(k): float(v)
                   for k, v in (req.phases or {}).items()},
        "trace": dict(req.trace) if req.trace else None,
        "kv_history": [int(c) for c in (req.kv_history or [])],
        "kv_attach": int(getattr(req, "kv_attach", 0) or 0),
        "kv_payload": None,
    }
    kvp = getattr(req, "kv_payload", None)
    if kvp is not None:
        d["kv_payload"] = _payload(kvp, _nd_enc)
    return d


def decode_request(d):
    """JSON-safe dict -> Request, the exact inverse of encode_request:
    re-encoding the result gives an equal dict (and equal bytes, base64
    payloads included). Raises WireVersionError on a version
    mismatch."""
    check_version(d)
    req = Request(
        d["prompt"], d["max_new_tokens"], request_id=d["id"],
        do_sample=d.get("do_sample", False),
        temperature=d.get("temperature", 1.0),
        top_k=d.get("top_k", 0), top_p=d.get("top_p", 1.0),
        seed=d.get("seed", 0), eos_token_id=d.get("eos_token_id"),
        priority=d.get("priority", 1),
        deadline_ms=d.get("deadline_ms"),
        adapter_id=d.get("adapter_id"), tenant=d.get("tenant"),
        trace=dict(d["trace"]) if d.get("trace") else None)
    req.status = d.get("status", "exported")
    # the recorded instants are another process's clock: adoption
    # starts them fresh here
    req.token_times = []
    req.output_tokens = [int(t) for t in d.get("output_tokens", [])]
    req.phases = {str(k): float(v)
                  for k, v in (d.get("phases") or {}).items()}
    req.kv_history = [int(c) for c in (d.get("kv_history") or [])]
    req.kv_attach = int(d.get("kv_attach", 0) or 0)
    kvp = d.get("kv_payload")
    if kvp is not None:
        req.kv_payload = _payload(kvp, _nd_dec)
    return req


def check_version(d):
    if not isinstance(d, dict):
        raise WireVersionError(None)
    if d.get("wire_version") != WIRE_VERSION:
        raise WireVersionError(d.get("wire_version"))


def dumps(d):
    """Blob dict -> canonical bytes (sorted keys: equal dicts give equal
    bytes)."""
    return json.dumps(d, sort_keys=True).encode("utf-8")


def loads(raw):
    """Bytes -> blob dict, the version checked before anything
    downstream trusts the layout."""
    try:
        d = json.loads(raw)
    except (ValueError, TypeError) as e:
        raise MXNetError(f"malformed wire blob: {e}")
    check_version(d)
    return d
