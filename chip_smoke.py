#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mxnet_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (nvcc) and this checkout; never
JAX. Phases, each printing one JSON line, and any failure raises (the
script then exits non-zero without the final `ok` line):

  1. device   the card's name and power limit (nvidia-smi), torch, CUDA.
  2. build    every CUDA kernel of the port built from csrc/ (one nvcc
              per source, in parallel) and the ptxas resource report.
  3. span     ragged_span_attention's kernel against its plain PyTorch
              version at GPT-2 774M serving shapes (B=8, Sq=64, H=20,
              D=64, page 64, 16 pages per slot, 128 pages, permuted
              table, mixed q_counts and lengths), float32 (tol 1e-5)
              and bfloat16 (tol 2e-2), dead rows and idle slots exactly
              0, plus edge cases; times of kernel, plain version and the
              F.scaled_dot_product_attention yardstick, and the bound.
  4. decode   the same for ragged_decode_attention, and whether it
              agrees bit for bit with the span kernel at Sq=1.
  5. gpt2     GPT-2 774M at full width (36 layers, 1280 units, 20
              heads, vocab 50257, 1024 positions; seeded random
              weights) served by ServingEngine(num_slots=8,
              max_length=1024, page_size=64): 8 greedy requests, prompts
              U[16, 128], 32 new tokens each, float32, once through the
              kernels and once through the plain versions (attn_impl=
              "torch"). Streams must agree (a divergence is allowed only
              where the plain path's top-2 logit gap is below 1e-4); the
              span kernel must have run 36 times per dispatch. One ragged
              single-token forward on the served cache drives the decode
              kernel (logits within 1e-4 of the plain path). Then the
              kernel path serves the same traffic in bfloat16, timed.
              The float32 and bfloat16 kernel paths each serve once more
              under torch.profiler: device busy share and top kernels.
  6. kernels  one line listing every ported kernel with its launches on
              the main path (phase 5), errors, times and bound.
Then the last line: {"ok": true, "device": {...}}.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # H100 SXM memory rate
PEAK_FLOPS = {"float32": 67e12,    # H100 SXM, outside the tensor cores
              "bfloat16": 989e12}  # H100 SXM, dense tensor cores
SOURCE = "mxnet_tpu_torch/csrc/ragged_attention.cu"
REPLACES = {
    "ragged_span_attention":
        "mxnet_tpu/ops/pallas_attention.py:576 _ragged_span_kernel",
    "ragged_decode_attention":
        "mxnet_tpu/ops/pallas_attention.py:402 _ragged_decode_kernel",
}
GPT2_LAYERS = 36
DEV = "cuda"


def emit(obj):
    print(json.dumps(obj), flush=True)


def require(cond, msg):
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------

def time_ms(torch, fn, iters=25, warmup=3):
    """Median device time of fn() over `iters` launches, CUDA events
    around each. Before each launch a 64 MB buffer is rewritten (the
    caller meets these pages cold in L2, as on the serving path: 36
    layers of pools do not fit in it) and the stream is held by a short
    device sleep so that host-side wrapper work is not timed."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEV)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def attention_work(lengths, q_counts, S, P, H, D, itemsize, out_rows):
    """Bytes the function must move and the operations it must do for
    these inputs: live q rows, the live K/V pages of each slot (each read
    once), the whole output written once; 4*D flops per (live row,
    visible key) pair and head."""
    kv_bytes = q_bytes = pairs = 0
    for length, qc in zip(lengths, q_counts):
        if qc <= 0:
            continue
        pages = min(-(-(length + qc - 1) // S), P)
        kv_bytes += 2 * pages * S * H * D * itemsize
        q_bytes += qc * H * D * itemsize
        pairs += sum(min(max(length + j, 0), P * S) for j in range(qc))
    nbytes = kv_bytes + q_bytes + out_rows * H * D * itemsize
    return nbytes, 4 * D * H * pairs


def bound(nbytes, flops, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phases 3 and 4: kernels against their plain versions
# ---------------------------------------------------------------------------

def make_pool(torch, B, Sq, H, D, S, P, N, dtype, seed):
    rng = np.random.default_rng(seed)
    q = torch.tensor(rng.standard_normal((B, Sq, H, D)), dtype=dtype,
                     device=DEV)
    kp = torch.tensor(rng.standard_normal((N, S, H, D)), dtype=dtype,
                      device=DEV)
    vp = torch.tensor(rng.standard_normal((N, S, H, D)), dtype=dtype,
                      device=DEV)
    table = torch.tensor(rng.permutation(N)[:B * P].reshape(B, P),
                         dtype=torch.int32, device=DEV)
    return q, kp, vp, table


def dense_yardstick(torch, kp, vp, table, lengths, Sq):
    """The inputs of the library yardstick: the gathered dense (B, H, T,
    D) view and the same causal-offset mask. Built outside the timing."""
    B, P = table.shape
    S, H, D = kp.shape[1:]
    k = kp[table.long()].reshape(B, P * S, H, D).transpose(1, 2)
    v = vp[table.long()].reshape(B, P * S, H, D).transpose(1, 2)
    pos = torch.arange(P * S, device=DEV)
    limit = lengths.long()[:, None] + torch.arange(Sq, device=DEV)
    mask = (pos[None, None, :] < limit[:, :, None])[:, None]
    return k.contiguous(), v.contiguous(), mask


def phase_span(torch, F, ra):
    B, Sq, H, D, S, P, N = 8, 64, 20, 64, 64, 16, 128
    lengths = [1, 1000, 3, 960, 500, 1, 1023, 64]
    q_counts = [1, 4, 64, 17, 0, 64, 1, 33]
    out = {"phase": "span", "shape": dict(B=B, Sq=Sq, H=H, D=D, S=S, P=P,
                                          N=N),
           "lengths": lengths, "q_counts": q_counts}
    L = torch.tensor(lengths, dtype=torch.int32, device=DEV)
    qc = torch.tensor(q_counts, dtype=torch.int32, device=DEV)
    dead = (torch.arange(Sq, device=DEV)[None, :] >= qc[:, None])
    for dtype, name, tol in ((torch.float32, "float32", 1e-5),
                             (torch.bfloat16, "bfloat16", 2e-2)):
        q, kp, vp, table = make_pool(torch, B, Sq, H, D, S, P, N, dtype, 0)

        def kernel():
            return ra.ragged_span_attention(q, kp, vp, table, L,
                                            q_counts=qc, impl="auto")

        def plain():
            return ra.ragged_span_attention(q, kp, vp, table, L,
                                            q_counts=qc, impl="torch")
        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        require(err <= tol, f"span {name}: max abs err {err} > {tol}")
        require(bool((got[dead] == 0).all()),
                f"span {name}: dead rows / idle slots are not exactly 0")
        require(bool(torch.isfinite(got).all()), f"span {name}: non-finite")
        k, v, mask = dense_yardstick(torch, kp, vp, table, L, Sq)
        qt = q.transpose(1, 2).contiguous()
        nbytes, flops = attention_work(lengths, q_counts, S, P, H, D,
                                       q.element_size(), B * Sq)
        bms, by = bound(nbytes, flops, name)
        out[name] = {
            "max_abs_err": err, "tol": tol,
            "ms": time_ms(torch, kernel), "plain_ms": time_ms(torch, plain),
            "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, k, v, attn_mask=mask)),
            "bound_ms": bms, "bound_by": by, "bytes": nbytes,
            "flops": flops}
    # edge cases at small shapes: all idle, all decode, ragged tails,
    # lengths 0, a head dim and page size off the 32 grid
    edges = [(5, 8, 2, 16, 8, 4, [5, 1, 24, 13, 8], qcs)
             for qcs in ([0] * 5, [1] * 5, [8] * 5, [3, 7, 2, 6, 1])]
    edges += [(3, 20, 3, 40, 12, 3, [0, 20, 36], [20, 17, 3]),
              (2, 33, 1, 128, 64, 2, [60, 100], [33, 29])]
    worst = 0.0
    for i, (b, sq, h, d, s, p, lens, qcs) in enumerate(edges):
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            q, kp, vp, table = make_pool(torch, b, sq, h, d, s, p,
                                         b * p + 1, dtype, 10 + i)
            Le = torch.tensor(lens, dtype=torch.int32, device=DEV)
            qce = torch.tensor(qcs, dtype=torch.int32, device=DEV)
            got = ra.ragged_span_attention(q, kp, vp, table, Le,
                                           q_counts=qce, impl="auto")
            ref = ra.ragged_span_attention(q, kp, vp, table, Le,
                                           q_counts=qce, impl="torch")
            err = (got.float() - ref.float()).abs().max().item()
            require(err <= tol, f"span edge {i} {dtype}: err {err}")
            deadm = torch.arange(sq, device=DEV)[None, :] >= qce[:, None]
            require(bool((got[deadm] == 0).all()), f"span edge {i}: dead")
            if dtype == torch.float32:
                worst = max(worst, err)
    out["edge_cases"] = len(edges)
    out["edge_max_abs_err_f32"] = worst
    emit(out)
    return out


def phase_decode(torch, F, ra):
    B, H, D, S, P, N = 8, 20, 64, 64, 16, 128
    lengths = [1, 1000, 3, 960, 0, 2, 1024, 64]
    out = {"phase": "decode", "shape": dict(B=B, H=H, D=D, S=S, P=P, N=N),
           "lengths": lengths}
    L = torch.tensor(lengths, dtype=torch.int32, device=DEV)
    ones = torch.ones(B, dtype=torch.int32, device=DEV)
    for dtype, name, tol in ((torch.float32, "float32", 1e-5),
                             (torch.bfloat16, "bfloat16", 2e-2)):
        q4, kp, vp, table = make_pool(torch, B, 1, H, D, S, P, N, dtype, 1)
        q = q4[:, 0].contiguous()

        def kernel():
            return ra.ragged_decode_attention(q, kp, vp, table, L,
                                              impl="auto")

        def plain():
            return ra.ragged_decode_attention(q, kp, vp, table, L,
                                              impl="torch")
        got, ref = kernel(), plain()
        err = (got.float() - ref.float()).abs().max().item()
        require(err <= tol, f"decode {name}: max abs err {err} > {tol}")
        require(bool((got[4] == 0).all()), f"decode {name}: length 0 != 0")
        require(bool(torch.isfinite(got).all()),
                f"decode {name}: non-finite")
        span1 = ra.ragged_span_attention(q4, kp, vp, table, L,
                                         q_counts=ones, impl="auto")[:, 0]
        k, v, mask = dense_yardstick(torch, kp, vp, table, L, 1)
        qt = q4.transpose(1, 2).contiguous()
        nbytes, flops = attention_work(lengths, [1] * B, S, P, H, D,
                                       q.element_size(), B)
        bms, by = bound(nbytes, flops, name)
        out[name] = {
            "max_abs_err": err, "tol": tol,
            "span_sq1_bit_identical": bool(torch.equal(span1, got)),
            "span_sq1_max_abs_diff":
                (span1.float() - got.float()).abs().max().item(),
            "ms": time_ms(torch, kernel), "plain_ms": time_ms(torch, plain),
            "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, k, v, attn_mask=mask)),
            "bound_ms": bms, "bound_by": by, "bytes": nbytes,
            "flops": flops}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase 5: GPT-2 774M served end to end
# ---------------------------------------------------------------------------

def serve(torch, eng, prompts, n_new, Request):
    reqs = [Request(p, n_new, request_id=i) for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return [r.output_tokens for r in reqs], wall


def trace_serve(torch, eng, prompts, n_new, Request):
    """Serve once under torch.profiler (CPU and CUDA activities): the
    device's busy share of the window (sum of kernel times over wall
    time; the profiler's own host cost makes it a lower bound) and the
    kernels that took the most device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = serve(torch, eng, prompts, n_new, Request)
    cuda = torch.autograd.DeviceType.CUDA
    rows = sorted(((e.self_device_time_total, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == cuda and e.self_device_time_total),
                  reverse=True)
    if not rows:
        return {"wall_s": wall, "device_busy_share": "not measured"}
    dev_ms = sum(r[0] for r in rows) / 1e3
    return {"wall_s": wall, "device_ms": dev_ms,
            "device_busy_share": dev_ms / (wall * 1e3),
            "top_kernels": [{"name": k[:90], "ms": d / 1e3, "count": c}
                            for d, k, c in rows[:8]]}


def top2_gap(torch, model, tokens):
    """The plain path's gap between the two largest next-token logits
    after `tokens` (one slot, the whole prefix as one span)."""
    cache = model.make_cache(1, 1024, page_size=64, lengths=[0],
                             attn_impl="torch")
    ids = torch.tensor([tokens], dtype=torch.int64, device=DEV)
    with torch.no_grad():
        logits, _ = model(ids, cache)
    top = torch.topk(logits[0, -1].float(), 2).values
    return (top[0] - top[1]).item()


def gpt2_config(cfg):
    return cfg


def phase_gpt2(torch, ra, card):
    from mxnet_tpu_torch.models import (GPT2ForCausalLM, PagedKVCache,
                                        gpt2_774m_config, init_params)
    from mxnet_tpu_torch.serving import Request, ServingEngine

    cfg = gpt2_774m_config(dropout=0.0, attention_dropout=0.0)
    require(cfg.num_layers == GPT2_LAYERS, "774M config changed")
    cfg = gpt2_config(cfg)
    t0 = time.perf_counter()
    model = GPT2ForCausalLM(cfg, device=DEV)
    init_params(model, seed=0, std=0.02)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    plens = rng.integers(16, 129, 8)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in plens]
    n_new = 32
    out = {"phase": "gpt2", "card": card, "config": "gpt2_774m_config",
           "layers": cfg.num_layers, "units": cfg.units,
           "heads": cfg.num_heads, "vocab": cfg.vocab_size,
           "prompt_lens": [int(n) for n in plens], "new_tokens": n_new,
           "init_s": init_s}
    ekw = dict(num_slots=8, max_length=1024, page_size=64)

    # the main path: float32 through the kernels; launches counted here
    eng = ServingEngine(model, device=DEV, **ekw)
    ra.reset_launches()
    got, wall = serve(torch, eng, prompts, n_new, Request)
    dispatches = eng.stats["decode_dispatches"]
    span_launches = ra.LAUNCHES["ragged_span_attention"]
    require(span_launches == GPT2_LAYERS * dispatches,
            f"span launches {span_launches} != 36 x {dispatches} dispatches")
    require(all(len(t) == n_new for t in got), "short streams")
    require(all(0 <= t < cfg.vocab_size for s in got for t in s),
            "token out of range")
    # one ragged single-token forward on the served cache drives the
    # decode kernel: each slot holds its request's prompt + 31 written
    # tokens (slot i served request i) and feeds its last token
    lengths = [int(n) + n_new - 1 for n in plens]
    table = eng._dstate["table"]
    last = torch.tensor([[s[-1]] for s in got], device=DEV)
    logits = {}
    for impl in ("auto", "torch"):
        cache = PagedKVCache(eng._kp, eng._vp, table,
                             torch.tensor(lengths, dtype=torch.int32,
                                          device=DEV), attn_impl=impl)
        with torch.no_grad():
            logits[impl] = model(last, cache)[0].float()
    launches = dict(ra.LAUNCHES)
    require(launches["ragged_decode_attention"] == GPT2_LAYERS,
            f"decode launches {launches['ragged_decode_attention']}")
    dlog = (logits["auto"] - logits["torch"]).abs().max().item()
    require(dlog <= 1e-4, f"decode forward logits differ by {dlog}")
    require(bool(torch.isfinite(logits["auto"]).all()), "non-finite logits")
    out["float32_kernel"] = {"card": card, "wall_s": wall,
                             "dispatches": dispatches,
                             "tokens": sum(map(len, got)),
                             "tokens_per_s": sum(map(len, got)) / wall,
                             "ms_per_dispatch": wall / dispatches * 1e3}
    out["launches"] = launches
    out["decode_forward_logits_max_abs_diff"] = dlog
    out["float32_kernel_trace"] = trace_serve(torch, eng, prompts, n_new,
                                              Request)
    del eng, cache, logits
    torch.cuda.empty_cache()

    # the same traffic through the plain versions
    eng = ServingEngine(model, attn_impl="torch", device=DEV, **ekw)
    want, wall = serve(torch, eng, prompts, n_new, Request)
    out["float32_plain"] = {"card": card, "wall_s": wall,
                            "dispatches": eng.stats["decode_dispatches"],
                            "ms_per_dispatch": wall
                            / eng.stats["decode_dispatches"] * 1e3}
    del eng
    torch.cuda.empty_cache()
    divergences = []
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            j = next(k for k in range(n_new) if a[k] != b[k])
            gap = top2_gap(torch, model, prompts[i] + b[:j])
            divergences.append({"request": i, "token": j, "top2_gap": gap})
            require(gap < 1e-4, f"request {i} diverges at token {j} where "
                    f"the plain top-2 gap is {gap}")
    out["streams_identical"] = not divergences
    out["divergences"] = divergences

    # the kernel path in bfloat16 (the same weights, rounded), timed
    model.to(torch.bfloat16)
    eng = ServingEngine(model, device=DEV, **ekw)
    serve(torch, eng, prompts, n_new, Request)          # warm-up
    eng.stats["decode_dispatches"] = 0
    got16, wall = serve(torch, eng, prompts, n_new, Request)
    d16 = eng.stats["decode_dispatches"]
    require(all(len(t) == n_new for t in got16), "short bf16 streams")
    out["bfloat16_kernel"] = {
        "card": card, "wall_s": wall, "dispatches": d16,
        "tokens_per_s": sum(map(len, got16)) / wall,
        "ms_per_dispatch": wall / d16 * 1e3,
        "greedy_tokens_equal_to_float32":
            sum(x == y for a, b in zip(got16, got) for x, y in zip(a, b)),
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    out["bfloat16_kernel_trace"] = trace_serve(torch, eng, prompts, n_new,
                                               Request)
    del eng, model
    torch.cuda.empty_cache()
    emit(out)
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import _build
    from mxnet_tpu_torch.ops import ragged_attention as ra

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi()
    print(card, flush=True)
    emit({"phase": "device", "nvidia_smi": card,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    logs = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "compiled": sorted(logs),
          "ptxas": [ln.strip() for log in logs.values()
                    for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]})

    span = phase_span(torch, F, ra)
    decode = phase_decode(torch, F, ra)
    gpt2 = phase_gpt2(torch, ra, card)

    kernels = []
    for name, res in (("ragged_span_attention", span),
                      ("ragged_decode_attention", decode)):
        f32, b16 = res["float32"], res["bfloat16"]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name],
            "launches": gpt2["launches"][name],
            "max_abs_err": f32["max_abs_err"],
            "max_abs_err_bf16": b16["max_abs_err"],
            "ms": f32["ms"], "kernel_ms": f32["ms"],
            "plain_ms": f32["plain_ms"],
            "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"],
            "library_ms": f32["library_ms"],
            "ms_bf16": b16["ms"], "plain_ms_bf16": b16["plain_ms"],
            "bound_ms_bf16": b16["bound_ms"],
            "library_ms_bf16": b16["library_ms"], "card": card})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
