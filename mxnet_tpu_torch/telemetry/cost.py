"""Device-cost accounting: program cost registry, MFU/roofline gauges,
and compile attribution.

Counterpart of mxnet_tpu/telemetry/cost.py, with one process-global
program table:

  * **Program cost registry** — every program the framework dispatches
    is keyed by a signature string (``engine0/dispatch``). The
    reference registers XLA ``cost_analysis()`` figures once per
    compiled program (its ``CostedFunction``, an AOT wrapper). The port
    runs eager PyTorch over hand-written kernels, and what one dispatch
    computes depends on its data (the live rows of the (B, W) grid and
    the context each row attends), so its FLOPs and bytes come from the
    model's own formula, per dispatch: ``gpt2_dispatch_cost`` counts
    them over the rows the dispatch really computes, and
    ``note_dispatch(program, seconds, flops=..., bytes_accessed=...)``
    refreshes the record with them. Combined with the measured
    dispatch time it publishes live MFU (``cost_mfu{program}``),
    achieved bandwidth, arithmetic intensity, and a compute- versus
    memory-bound roofline classification per program.
  * **Time** — the serving engine brackets its dispatch with two CUDA
    events and reads their ``elapsed_time`` after the dispatch's one
    existing device-to-host copy (which already waited for the
    stream), never through an extra synchronize; on the CPU it reads
    the host clock.
  * **Compile attribution** — the port's "compiles" are the kernel
    library builds and loads of ``ops/_build.py`` (``build_all``,
    ``load``): each one counts ``compiles_total{program}`` /
    ``compile_seconds_total{program}`` under ``kernels/<library>``.
    Compile events feed registered hooks; the flight recorder
    subscribes, so a build or load after an engine's ``mark_warm()``
    (``steady_state()`` is then true) latches a retrace-storm dump.
  * **Peaks** — per-device peak FLOP/s by compute dtype and memory
    bandwidth, chosen by ``torch.cuda.get_device_name``, env-
    overridable with ``MXNET_TPU_PEAK_FLOPS`` /
    ``MXNET_TPU_PEAK_BANDWIDTH``. The ridge point (peak_flops /
    peak_bw) classifies each program. A CUDA card the table does not
    name publishes no peak, so no MFU, bandwidth share or roofline
    class (/compilez says ``unknown_device``); only the CPU gets the
    nominal figures.

In-path cost per dispatch is the formula (a loop over the slots) and a
handful of instrument updates; ``set_enabled(False)`` turns the
in-path accounting into a no-op for A/B runs (and the engine then
records no CUDA events).

Stdlib-only at import: torch is read from ``sys.modules`` inside
``peaks()`` and only when the process already initialized CUDA.
"""
from __future__ import annotations

import math
import os
import threading
import time
import weakref

__all__ = ["register_program", "record_compile", "note_dispatch", "get",
           "report", "peaks", "set_enabled", "enabled",
           "add_compile_hook", "remove_compile_hook", "reset_programs",
           "add_steady_probe", "steady_state", "gpt2_dispatch_cost"]

_lock = threading.Lock()
_programs = {}             # program key -> _ProgramRecord
_compile_hooks = []
_steady_probes = []        # weak refs to () -> bool (engines' warm flags)
_enabled = True
_device_peaks = None       # cached ({dtype: flops}, bw, kind)
_peaks_published = None    # last (flops, bw) written to the gauges

# (device-name substring, ({compute dtype: peak FLOP/s}, peak bytes/s)).
# Source: NVIDIA's H100 SXM5 datasheet (dense tensor-core bfloat16 and
# float16, CUDA-core float32, HBM3 bandwidth). Lower-cased substrings of
# torch.cuda.get_device_name; "H100 80GB HBM3" is how the SXM part
# names itself.
_PEAK_TABLE = (
    ("h100 80gb hbm3", ({"bfloat16": 989e12, "float16": 989e12,
                         "float32": 67e12}, 3.35e12)),
    ("h100 sxm", ({"bfloat16": 989e12, "float16": 989e12,
                   "float32": 67e12}, 3.35e12)),
)
# nominal numbers so CPU runs produce finite ratios (never a card's)
_FALLBACK_PEAKS = ({"bfloat16": 1e12, "float16": 1e12, "float32": 1e12},
                   100e9)


class _ProgramRecord:
    """One program's cost + accumulated compile/dispatch totals
    (mirrored onto labeled instruments; this object is the /compilez +
    report() source of truth). `steady_compiles` counts the compiles
    flagged after warmup."""

    __slots__ = ("program", "flops", "bytes_accessed", "source",
                 "compiles", "compile_seconds", "dispatches",
                 "dispatch_seconds", "last_seconds", "last_compile_ts",
                 "dtype", "steady_compiles", "shards", "children")

    def __init__(self, program):
        self.program = program
        self.flops = None
        self.bytes_accessed = None
        self.source = "model"
        self.compiles = 0
        self.compile_seconds = 0.0
        self.dispatches = 0
        self.dispatch_seconds = 0.0
        self.last_seconds = None
        self.last_compile_ts = None
        self.dtype = None
        self.steady_compiles = 0
        self.shards = 1            # tensor-parallel shards (chips)
        self.children = None       # cached labeled gauge/counter children


_SNAP_FIELDS = tuple(f for f in _ProgramRecord.__slots__ if f != "children")
_P = ("program",)
_metrics_cache = None


def _metrics():
    """Get-or-create the cost instrument family (lazy so importing
    telemetry stays declaration-free until cost accounting is used)."""
    global _metrics_cache
    if _metrics_cache is None:
        from . import counter, gauge
        _metrics_cache = {
            "compiles": counter(
                "compiles_total",
                "kernel library builds and loads per program", _P),
            "compile_seconds": counter(
                "compile_seconds_total",
                "wall seconds spent building and loading kernel "
                "libraries, per program", _P),
            "dispatches": counter(
                "cost_dispatches_total",
                "cost-accounted dispatches per program", _P),
            "dispatch_seconds": counter(
                "cost_dispatch_seconds_total",
                "accumulated dispatch seconds per program", _P),
            "program_flops": gauge(
                "cost_program_flops",
                "model-formula FLOPs of the program's last dispatch", _P),
            "program_bytes": gauge(
                "cost_program_bytes_accessed",
                "model-formula bytes moved by the last dispatch", _P),
            "ai": gauge(
                "cost_arithmetic_intensity",
                "program FLOPs / bytes accessed (roofline x-axis)", _P),
            "compute_bound": gauge(
                "cost_compute_bound",
                "1 = arithmetic intensity above the device ridge point "
                "(compute bound), 0 = below (memory bound)", _P),
            "mfu": gauge(
                "cost_mfu",
                "model FLOPs utilization of the last dispatch "
                "(flops / seconds / peak_flops)", _P),
            "achieved_flops": gauge(
                "cost_achieved_flops_per_sec",
                "program FLOPs / last dispatch seconds", _P),
            "achieved_bw": gauge(
                "cost_achieved_bandwidth_bytes_per_sec",
                "program bytes accessed / last dispatch seconds", _P),
            "peak_flops": gauge(
                "cost_peak_flops",
                "assumed per-card peak FLOP/s (device table or "
                "MXNET_TPU_PEAK_FLOPS)"),
            "peak_bw": gauge(
                "cost_peak_bandwidth_bytes_per_sec",
                "assumed per-card peak memory bytes/s (device table or "
                "MXNET_TPU_PEAK_BANDWIDTH)"),
            "ridge": gauge(
                "cost_ridge_intensity",
                "device ridge point: peak_flops / peak_bandwidth "
                "(FLOPs per byte)"),
        }
    return _metrics_cache


# -- peaks ------------------------------------------------------------------

def _device_table():
    """({dtype: peak FLOP/s}, peak bytes/s, device kind): looked up by
    the card's name once CUDA runs (cached then), nominal CPU numbers
    before that; ({}, None, kind) for a card the table does not name."""
    global _device_peaks
    if _device_peaks is not None:
        return _device_peaks
    from . import memory
    torch = memory.cuda_live()
    if torch is None:
        return _FALLBACK_PEAKS + ("cpu",)
    kind, table = "unknown", ({}, None)
    try:
        kind = str(torch.cuda.get_device_name(0))
        low = kind.lower()
        for sub, vals in _PEAK_TABLE:
            if sub in low:
                table = vals
                break
    except Exception:
        pass
    _device_peaks = (table[0], table[1], kind)
    return _device_peaks


def peaks(dtype=None):
    """(peak_flops, peak_bandwidth_bytes_per_sec, device_kind) for
    `dtype` (a compute dtype name; default bfloat16).

    Env overrides are read every call; the device-name lookup is
    cached once CUDA runs. Safe without torch: falls back to nominal
    numbers. On a CUDA card the table does not name, a peak with no
    override is None, and nothing that divides by it is published."""
    fl, bw, kind = _device_table()
    flops = float(os.environ.get("MXNET_TPU_PEAK_FLOPS", 0) or 0) \
        or fl.get(str(dtype or "bfloat16"), fl.get("bfloat16"))
    bw = float(os.environ.get("MXNET_TPU_PEAK_BANDWIDTH", 0) or 0) or bw
    global _peaks_published
    if _peaks_published != (flops, bw):     # hot path: publish on change
        m = _metrics()
        if flops is not None:
            m["peak_flops"].set(flops)
        if bw is not None:
            m["peak_bw"].set(bw)
        if flops is not None and bw is not None:
            m["ridge"].set(flops / bw)
        _peaks_published = (flops, bw)
    return flops, bw, kind


# -- enable/disable the in-path accounting ----------------------------------

def set_enabled(flag):
    """Gate the per-dispatch accounting (note_dispatch becomes a no-op
    returning None). Compile attribution and program registration are
    one-time events and stay on."""
    global _enabled
    _enabled = bool(flag)


def enabled():
    return _enabled


# -- steady state (compile-after-warmup detection) ---------------------------

def add_steady_probe(fn):
    """Register `fn() -> bool` (an engine's warm flag, held weakly for
    bound methods): while any probe answers True, a compile is flagged
    steady."""
    ref = weakref.WeakMethod(fn) if hasattr(fn, "__self__") \
        else (lambda f=fn: f)
    with _lock:
        _steady_probes.append(ref)


def steady_state():
    """True when a live registered owner declared warmup over."""
    with _lock:
        refs = list(_steady_probes)
    dead = []
    out = False
    for ref in refs:
        fn = ref()
        if fn is None:
            dead.append(ref)
            continue
        try:
            out = out or bool(fn())
        except Exception:
            pass
    if dead:
        with _lock:
            for ref in dead:
                if ref in _steady_probes:
                    _steady_probes.remove(ref)
    return out


# -- the program table ------------------------------------------------------

def _record(program):
    rec = _programs.get(program)
    if rec is None:
        rec = _programs.setdefault(program, _ProgramRecord(program))
    return rec


def _clean(v):
    if v is None:
        return None
    v = float(v)
    return v if math.isfinite(v) and v > 0 else None


def _children(rec):
    """The record's labeled instrument children, looked up once."""
    ch = rec.children
    if ch is None:
        m = _metrics()
        ch = rec.children = {k: m[k].labels(rec.program) for k in (
            "dispatches", "dispatch_seconds", "program_flops",
            "program_bytes", "ai", "compute_bound", "mfu",
            "achieved_flops", "achieved_bw")}
    return ch


def register_program(program, flops=None, bytes_accessed=None,
                     dtype=None, shards=1):
    """Register (or refresh) a program's cost: `flops`/`bytes_accessed`
    of ONE dispatch, whole-model figures; `dtype` is its compute dtype
    (picks the peak MFU compares against); `shards` the tensor-parallel
    shard count, by which the live MFU and bandwidth gauges divide (each
    chip did 1/shards of the work in that time). Non-finite /
    non-positive values are treated as unknown. Returns the record's
    snapshot."""
    flops, bytes_accessed = _clean(flops), _clean(bytes_accessed)
    with _lock:
        rec = _record(program)
        if flops is not None:
            rec.flops = flops
        if bytes_accessed is not None:
            rec.bytes_accessed = bytes_accessed
        if dtype is not None:
            rec.dtype = str(dtype)
        rec.shards = max(int(shards), 1)
        flops, bytes_accessed = rec.flops, rec.bytes_accessed
    ch = _children(rec)
    if flops is not None:
        ch["program_flops"].set(flops)
    if bytes_accessed is not None:
        ch["program_bytes"].set(bytes_accessed)
    if flops is not None and bytes_accessed is not None:
        ai = flops / bytes_accessed
        pf, pb, _ = peaks(rec.dtype)
        ch["ai"].set(ai)
        if pf and pb:
            ch["compute_bound"].set(1.0 if ai >= pf / pb else 0.0)
    return get(program)


def record_compile(program, seconds):
    """Count one kernel build or load of `program` and fan the event
    out to the compile hooks (the flight recorder's retrace-storm
    detector rides here). One made while steady_state() holds (after
    an owner declared warmup over) is counted steady."""
    seconds = float(seconds)
    steady = steady_state()
    with _lock:
        rec = _record(program)
        rec.compiles += 1
        rec.compile_seconds += seconds
        rec.last_compile_ts = time.time()
        if steady:
            rec.steady_compiles += 1
        hooks = list(_compile_hooks)
    m = _metrics()
    m["compiles"].labels(program).inc()
    m["compile_seconds"].labels(program).inc(seconds)
    ev = {"program": program, "seconds": seconds, "steady": bool(steady),
          "ts": time.time()}
    for fn in hooks:
        try:
            fn(ev)
        except Exception:
            pass               # a broken subscriber must not break dispatch
    return ev


def note_dispatch(program, seconds, flops=None, bytes_accessed=None):
    """Attribute one measured dispatch time to `program`; `flops` /
    `bytes_accessed` (this dispatch's own, from the model formula)
    refresh the record first. Publishes the live MFU / achieved-
    bandwidth gauges when the program has a cost. Returns the program
    record (None when accounting is disabled) — callers use `.flops`
    for goodput counters."""
    if not _enabled:
        return None
    seconds = max(float(seconds), 1e-9)
    flops, bytes_accessed = _clean(flops), _clean(bytes_accessed)
    with _lock:
        rec = _record(program)
        if flops is not None:
            rec.flops = flops
        if bytes_accessed is not None:
            rec.bytes_accessed = bytes_accessed
        rec.dispatches += 1
        rec.dispatch_seconds += seconds
        rec.last_seconds = seconds
        flops, nbytes = rec.flops, rec.bytes_accessed
        sh = rec.shards
    ch = _children(rec)
    ch["dispatches"].inc()
    ch["dispatch_seconds"].inc(seconds)
    # the registered cost is whole-model; the gauges compare against ONE
    # chip's peak, so a tp-way program's figures divide by the shards
    if flops is not None:
        pf, pb, _ = peaks(rec.dtype)
        if pf:
            ch["mfu"].set(flops / seconds / pf / sh)
        ch["achieved_flops"].set(flops / seconds / sh)
        ch["program_flops"].set(flops)
        if nbytes is not None:
            ai = flops / nbytes
            ch["ai"].set(ai)
            if pf and pb:
                ch["compute_bound"].set(1.0 if ai >= pf / pb else 0.0)
    if nbytes is not None:
        ch["achieved_bw"].set(nbytes / seconds / sh)
        ch["program_bytes"].set(nbytes)
    return rec


def get(program):
    """Snapshot dict of one program's record (None when unknown)."""
    with _lock:
        rec = _programs.get(program)
        if rec is None:
            return None
        return _snap(rec)


def _snap(rec):
    out = {k: getattr(rec, k) for k in _SNAP_FIELDS}
    if rec.flops and rec.bytes_accessed:
        out["arithmetic_intensity"] = rec.flops / rec.bytes_accessed
    if rec.flops and rec.last_seconds:
        pf, pb, _ = peaks(rec.dtype)
        sh = rec.shards
        if pf:
            out["mfu"] = rec.flops / rec.last_seconds / pf / sh
        if rec.bytes_accessed and pb:
            out["bandwidth_util"] = (rec.bytes_accessed
                                     / rec.last_seconds / pb / sh)
    return out


def report():
    """The /compilez view: every program's cost, roofline placement,
    compile attribution and dispatch totals, plus the assumed device
    peaks (bfloat16's; each program's MFU uses its own dtype's).
    `unknown_device` is true on a CUDA card the peak table does not
    name: its peaks, ridge, MFUs and roofline classes are then None or
    absent."""
    pf, pb, kind = peaks()
    with _lock:
        recs = sorted(_programs.items())
    progs = {p: _snap(r) for p, r in recs}
    for p, snap in progs.items():
        ai = snap.get("arithmetic_intensity")
        f, b, _ = peaks(snap.get("dtype"))
        if ai is not None and f and b:
            snap["bound"] = "compute" if ai >= f / b else "memory"
    return {"device_kind": kind, "peak_flops": pf,
            "peak_bandwidth_bytes_per_sec": pb,
            "ridge_intensity": pf / pb if pf and pb else None,
            "unknown_device": not (pf and pb),
            "programs": progs,
            "steady_compiles": sum(s["steady_compiles"]
                                   for s in progs.values())}


def reset_programs():
    """Forget every program record (tests / between bench rounds that
    rebuild their engines). Instruments are left to telemetry.reset()."""
    with _lock:
        _programs.clear()


# -- compile hooks ----------------------------------------------------------

def add_compile_hook(fn):
    """fn(event_dict) runs on every record_compile (the flight recorder
    subscribes for steady-state rebuild detection)."""
    with _lock:
        if fn not in _compile_hooks:
            _compile_hooks.append(fn)


def remove_compile_hook(fn):
    with _lock:
        try:
            _compile_hooks.remove(fn)
        except ValueError:
            pass


# -- the model formula ------------------------------------------------------

def gpt2_dispatch_cost(cfg, q_counts, lengths, width, weight_bytes,
                       kv_itemsize, logits_itemsize=4):
    """FLOPs and bytes of one GPT-2 serving dispatch over the (B, W)
    grid, from the model's shapes.

    q_counts[b]: query rows slot b computes (a prefill chunk's tokens,
    1 + drafts for a decode or verify row, 0 idle); lengths[b]: the
    positions already in its KV cache (row i of the slot attends
    lengths[b] + i + 1 keys). Per layer a row costs 2·U·3U (q, k, v) +
    2·U·U (out proj) + 2·2·U·F (MLP) FLOPs and one attended key 2·U
    (q·k) + 2·U (p·v); the tied LM head costs 2·U·V per row. Returns a
    dict:

      flops       the live rows' FLOPs (the model FLOPs: what MFU and
                  serving_model_flops_total count);
      grid_flops  the FLOPs the card runs: the dense layers and the LM
                  head over all B·W rows (dead rows included), the
                  attention over live rows only (the span kernels skip
                  dead rows);
      bytes       weight_bytes (read once) + the KV the live slots read
                  (lengths + q_counts positions, k and v, every layer)
                  and write (one position per live row) + the logits
                  of the whole grid (B·W·V at logits_itemsize).
    """
    U, L, V = int(cfg.units), int(cfg.num_layers), int(cfg.vocab_size)
    F = int(getattr(cfg, "hidden_size", 4 * U))
    rows = keys = kv_read = 0
    for q, n in zip(q_counts, lengths):
        q, n = int(q), int(n)
        if q <= 0:
            continue
        rows += q
        keys += q * n + q * (q + 1) // 2
        kv_read += n + q
    grid = len(q_counts) * int(width)
    per_row = L * (8 * U * U + 4 * U * F) + 2 * U * V
    attn = L * 4 * U * keys
    kv_pos = L * 2 * U * int(kv_itemsize)
    return {"flops": rows * per_row + attn,
            "grid_flops": grid * per_row + attn,
            "bytes": (int(weight_bytes) + kv_pos * (kv_read + rows)
                      + grid * V * int(logits_itemsize)),
            "rows": rows, "grid_rows": grid}
