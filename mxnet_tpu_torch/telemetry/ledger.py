"""HBM ledger: per-subsystem device-byte accounting, reconciled
against the allocator's live bytes.

Counterpart of mxnet_tpu/telemetry/ledger.py. `telemetry/memory.py`
answers *how much* device memory is in use; this module answers *where
it went*. Each subsystem registers a **provider** — a callable
returning ``{category: value}`` where a value is:

  * a tensor or an iterable of tensors — counted toward the accounted
    total by their storages, **deduplicated** across every provider and
    category by ``untyped_storage().data_ptr()`` (the reference dedupes
    shared arrays by identity), so two engines over one model, or a
    view of a counted slab, never double-count;
  * an ``int`` — raw bytes, counted as-is (no dedup possible);
  * a ``Detail(int)`` — an *informational* figure published as a gauge
    but excluded from the accounted total (e.g. the prefix-cache-held
    subset of the KV page slab, which is already counted inside
    ``kv_pages``, or the host KV tier, which is not device memory).

A tensor's bytes are its storage's ``nbytes()`` (for a tensor that owns
its storage, numel x element size). ``snapshot()`` walks the
providers, reconciles the accounted total against
``torch.cuda.memory_allocated`` (the same source as
``memory_live_array_bytes``; read only in a process that already runs
CUDA) and the device capacity (env override ``MXNET_TPU_HBM_BYTES``),
and publishes:

    ledger_bytes{component="engine/0/kv_pages"}   per category
    ledger_accounted_bytes                        sum of deduped categories
    ledger_unattributed_bytes                     live - accounted
    ledger_headroom_bytes                         limit - in use (when a
                                                  limit is known)

Providers are weakly held (bound methods): a collected owner drops out
silently, like /statusz providers. Stdlib-only at import.
"""
from __future__ import annotations

import os
import threading
import weakref

__all__ = ["Detail", "register", "unregister", "providers", "snapshot",
           "install"]

_lock = threading.Lock()
_providers = {}            # name -> () -> provider callable (weak-aware)


class Detail(int):
    """Informational byte figure: published as a gauge, excluded from
    the accounted total (use for categories that overlap another)."""


def register(name, fn):
    """Publish `fn() -> {category: tensors | int | Detail}` under `name`.
    Bound methods are held via WeakMethod — a dead owner drops the
    provider instead of leaking it."""
    if hasattr(fn, "__self__"):
        ref = weakref.WeakMethod(fn)
        get = lambda r=ref: r()                          # noqa: E731
    else:
        get = lambda f=fn: f                             # noqa: E731
    with _lock:
        _providers[str(name)] = get


def unregister(name):
    with _lock:
        _providers.pop(str(name), None)


def providers():
    with _lock:
        return sorted(_providers)


def _gauges(registry):
    g = registry.gauge
    return {
        "bytes": g("ledger_bytes",
                   "HBM ledger: accounted device bytes per component "
                   "(component = provider/category)",
                   labelnames=("component",)),
        "accounted": g("ledger_accounted_bytes",
                       "HBM ledger: total bytes accounted to a "
                       "subsystem (identity-deduped)"),
        "unattributed": g("ledger_unattributed_bytes",
                          "live CUDA tensor bytes not claimed by any "
                          "ledger provider (live - accounted)"),
        "headroom": g("ledger_headroom_bytes",
                      "device capacity minus live bytes (0 when no "
                      "capacity limit is known)"),
    }


def _tensors_of(value):
    """Flatten a provider value into tensors; returns None when the
    value is a plain byte count instead."""
    if isinstance(value, int) and not isinstance(value, bool):
        return None
    if hasattr(value, "untyped_storage"):
        value = [value]
    return [t for t in value
            if t is not None and hasattr(t, "untyped_storage")]


def _storage_key(t):
    """(device, storage base address): one key per device allocation,
    whatever view of it a provider hands in."""
    st = t.untyped_storage()
    return (str(t.device), st.data_ptr()), int(st.nbytes())


def snapshot(registry=None):
    """One reconciliation pass: walk the providers, dedupe, compare
    with the live-array total and the allocator limit, update the
    ledger gauges, and return the full /memz dict."""
    from . import default_registry
    gs = _gauges(registry or default_registry)
    with _lock:
        items = sorted(_providers.items())
    components = {}
    seen = set()               # storage key of every counted tensor
    accounted = 0
    dead = []
    for name, get in items:
        fn = get()
        if fn is None:
            dead.append(name)
            continue
        try:
            cats = fn() or {}
        except Exception as e:
            components[name] = {"error": f"{type(e).__name__}: {e}"}
            continue
        comp = {}
        for cat, value in cats.items():
            if isinstance(value, Detail):
                comp[str(cat)] = {"bytes": int(value), "detail": True}
                gs["bytes"].labels(f"{name}/{cat}").set(int(value))
                continue
            tensors = _tensors_of(value)
            if tensors is None:            # raw int bytes
                n = int(value)
            else:
                n = 0
                for t in tensors:
                    key, nbytes = _storage_key(t)
                    if key in seen:
                        continue
                    seen.add(key)
                    n += nbytes
            comp[str(cat)] = {"bytes": n}
            accounted += n
            gs["bytes"].labels(f"{name}/{cat}").set(n)
        components[name] = comp
    if dead:
        with _lock:
            for name in dead:
                _providers.pop(name, None)

    out = {"components": components, "accounted_bytes": accounted}
    live = None
    limit = float(os.environ.get("MXNET_TPU_HBM_BYTES", 0) or 0) or None
    in_use = None
    from . import memory
    if memory.cuda_live() is not None:   # never the thing that starts CUDA
        try:
            mem = memory.sample(registry)
            live = mem.get("live_array_bytes")
            # the first device's allocator view
            for k, v in mem.items():
                if k.startswith("bytes_limit") and limit is None:
                    limit = float(v)
                if k.startswith("bytes_in_use") and in_use is None:
                    in_use = float(v)
        except Exception as e:
            out["memory_error"] = str(e)
    out["live_array_bytes"] = live
    if live is not None:
        out["unattributed_bytes"] = int(live - accounted)
        gs["unattributed"].set(live - accounted)
        if accounted:
            out["unattributed_fraction"] = round(
                (live - accounted) / max(live, 1), 6)
    out["capacity_bytes"] = limit
    used = in_use if in_use is not None else live
    if limit is not None and used is not None:
        out["headroom_bytes"] = int(limit - used)
        gs["headroom"].set(limit - used)
    gs["accounted"].set(accounted)
    return out


def install(registry=None):
    """Reconcile on every snapshot/render of the registry (opt-in, like
    memory.install — a ledger walk is O(provided tensors))."""
    from . import default_registry
    reg = registry or default_registry
    reg.add_collect_hook(lambda: snapshot(reg))
