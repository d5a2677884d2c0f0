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
  6. fused    fused_attention's CUDA forward and backward against its
              plain PyTorch version (forward output, dq, dk, dv) at
              BERT-base shapes (B=32, T=512, H=12, D=64, key padding from
              valid lengths U[384, 512], dropout 0.1) in BTHD and in
              BHTD, at GPT-2 774M causal shapes (B=8, T=1024, H=20, D=64,
              dropout 0.1, BTHD), float32 (forward 1e-5 absolute,
              gradients 1e-4 relative to the largest) and bfloat16
              (forward and gradients 1.2e-2 relative to the largest),
              plus edge cases (a fully padded batch row, causal Tq < Tk,
              D = 40 and 128, T off the 64 grid, T = 1100 past the
              reference's whole-row limit); every call must pass
              fused_attention.supported(), the gate dot_product_attention
              routes by; forward and backward times of kernel, plain
              version and the F.scaled_dot_product_attention yardstick,
              and the bound.
  7. bert     BERT-base MLM training at full width (12 layers, 768 units,
              12 heads, 3072 hidden, vocab 30522, 512 positions; seeded
              random weights) through parallel.TrainStep with AdamW(1e-4,
              wd 0.01), dropout and attention dropout 0.1, on bench.py's
              bench_bert traffic (B=32, T=512, 76 masked positions per
              row below its valid length, valid lengths U[384, 512],
              random labels): 5 float32 steps through the kernels (the
              main path: fused forward and backward 12 times a step) and
              5 through the plain versions from the same weights and
              seed (losses agree within 1e-5 relative at every step);
              before them, one float32 forward and backward of each path
              with the same dropout stream: every parameter's gradient
              within 1e-4 of the largest gradient magnitude of the
              layer that owns it (this pins the backward through all
              12 layers); then 20 timed bfloat16
              steps (float32 masters) on
              the kernel path — the loss must fall — with ms per step,
              tokens/s, peak memory and bert_base_mlm_mfu; then one more
              bfloat16 step under torch.profiler.
  8. kernels  one line listing every ported kernel with its launches on
              its main path (phase 5 for the ragged kernels, phase 7's
              float32 kernel run for the fused pair), errors, times and
              bound.
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
# bfloat16 kernel-against-plain tolerance, relative to the largest
# magnitude of the plain result: 1.5 units in the last place of it (bf16
# spacing is at most 2**-7 of a value); both round once from float32
BF16_REL_TOL = 1.2e-2
SOURCE = "mxnet_tpu_torch/csrc/ragged_attention.cu"
FUSED_SOURCE = "mxnet_tpu_torch/csrc/fused_attention.cu"
REPLACES = {
    "ragged_span_attention":
        "mxnet_tpu/ops/pallas_attention.py:576 _ragged_span_kernel",
    "ragged_decode_attention":
        "mxnet_tpu/ops/pallas_attention.py:402 _ragged_decode_kernel",
    "fused_attention_fwd":
        "mxnet_tpu/ops/pallas_attention.py:201 _fwd_kernel_packed (BTHD); "
        "mxnet_tpu/ops/pallas_attention.py:104 _fwd_kernel (BHTD)",
    "fused_attention_bwd":
        "mxnet_tpu/ops/pallas_attention.py:224 _bwd_kernel_packed (BTHD); "
        "mxnet_tpu/ops/pallas_attention.py:120 _bwd_kernel (BHTD)",
}
GPT2_LAYERS = 36
BERT_LAYERS = 12
# phase 6 cells: (B, H, T, D, layout, causal, dropout); the BERT cells
# take key padding from valid lengths U[3T/4, T] (numpy seed 0)
FUSED_CELLS = {"bert_bthd": (32, 12, 512, 64, "BTHD", False, 0.1),
               "bert_bhtd": (32, 12, 512, 64, "BHTD", False, 0.1),
               "gpt2_774m_causal": (8, 20, 1024, 64, "BTHD", True, 0.1)}
# edge cases (B, H, Tq, Tk, D, layout, causal, dropout, valid lengths): a
# fully padded batch row, causal Tq < Tk, head dims 40 and 128, T off
# the 64 grid, T past the reference's whole-row limit (MAX_FUSED_T)
FUSED_EDGES = [(3, 2, 200, 200, 64, "BTHD", False, 0.1, [0, 150, 200]),
               (2, 3, 100, 200, 64, "BHTD", True, 0.1, None),
               (2, 3, 130, 130, 40, "BTHD", False, 0.1, [77, 130]),
               (2, 2, 130, 130, 128, "BTHD", True, 0.1, None),
               (2, 2, 70, 70, 128, "BHTD", False, 0.0, [70, 1]),
               (1, 2, 1100, 1100, 64, "BTHD", False, 0.1, [700])]
# phase 7 traffic (bench.py bench_bert): batch, sequence, masked per row
BERT_TRAFFIC = dict(B=32, T=512, M=76)
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
# phase 6: the fused training attention against its plain version
# ---------------------------------------------------------------------------

def fused_work(B, H, Tq, Tk, D, itemsize, causal):
    """(forward, backward) x (bytes, flops) of fused attention: q, k, v
    (and bias) read once and o written once forward; q, k, v, dO read and
    dq, dk, dv written once backward; 4·D flops per (query, key) pair
    forward and 10·D backward, half the pairs when causal."""
    pairs = B * H * Tq * Tk // (2 if causal else 1)
    q_bytes, kv_bytes = B * Tq * H * D * itemsize, B * Tk * H * D * itemsize
    bias = B * Tk * 4
    return ((2 * q_bytes + 2 * kv_bytes + bias, 4 * D * pairs),
            (3 * q_bytes + 4 * kv_bytes + bias, 10 * D * pairs))


def fused_case(torch, F, fa, B, H, Tq, Tk, D, layout, causal, p, lens,
               dtype, seed, timed):
    """Kernel against plain version on one set of inputs: forward output
    and the three gradients; with `timed`, forward and backward times of
    the kernel, the plain version and F.scaled_dot_product_attention."""
    rng = np.random.default_rng(seed)

    def shape(t):
        return (B, t, H, D) if layout == "BTHD" else (B, H, t, D)

    def leaf(t):
        return torch.tensor(rng.standard_normal(shape(t)), dtype=dtype,
                            device=DEV, requires_grad=True)
    q, k, v = leaf(Tq), leaf(Tk), leaf(Tk)
    do = torch.tensor(rng.standard_normal(shape(Tq)), dtype=dtype,
                      device=DEV)
    mask = None if lens is None else (
        torch.arange(Tk, device=DEV)[None, :]
        < torch.tensor(lens, device=DEV)[:, None])
    words = torch.tensor([int(x) for x in rng.integers(-2 ** 31, 2 ** 31, 2)],
                         dtype=torch.int32, device=DEV)
    name = f"fused {layout} B={B} H={H} Tq={Tq} Tk={Tk} D={D} {dtype}"
    # the gate dot_product_attention routes by must take every call here
    require(fa.supported(q, k, mask, layout=layout),
            f"{name}: supported() refuses a call the kernel takes")

    def run(impl):
        return fa.fused_attention(q, k, v, mask=mask, causal=causal,
                                  dropout_p=p, seed=words, layout=layout,
                                  impl=impl)
    res = {}
    for impl in ("auto", "torch"):
        o = run(impl)
        res[impl] = (o, torch.autograd.grad(o, (q, k, v), do))
    torch.cuda.synchronize()
    (o, g), (o_ref, g_ref) = res["auto"], res["torch"]
    err = (o.float() - o_ref.float()).abs().max().item()
    gabs = [(a.float() - b.float()).abs().max().item()
            for a, b in zip(g, g_ref)]
    grel = [e / b.float().abs().max().item() for e, b in zip(gabs, g_ref)]
    rel = err / o_ref.float().abs().max().item()
    f32 = dtype == torch.float32
    # float32 forward: absolute; bfloat16: relative to the largest output
    tol = 1e-5 if f32 else BF16_REL_TOL
    gtol = 1e-4 if f32 else BF16_REL_TOL
    require((err if f32 else rel) <= tol,
            f"{name}: forward err {err} (relative {rel}) > {tol}")
    require(max(grel) <= gtol, f"{name}: gradient rel errs {grel} > {gtol}")
    require(bool(torch.isfinite(o).all()) and all(
        bool(torch.isfinite(x).all()) for x in g), f"{name}: non-finite")
    if lens is not None and 0 in lens:
        b = lens.index(0)
        require(bool((o[b] == 0).all()),
                f"{name}: the fully padded batch row is not exactly 0")
    out = {"max_abs_err": err, "rel_err": rel, "tol": tol,
           "tol_kind": "absolute" if f32 else "relative",
           "grad_max_abs_err": gabs, "grad_rel_err": grel, "grad_tol": gtol}
    if not timed:
        return out
    del res
    name_t = "float32" if dtype == torch.float32 else "bfloat16"
    (fb, ff), (bb, bf) = fused_work(B, H, Tq, Tk, D, q.element_size(),
                                    causal)
    out["bound_ms"], out["bound_by"] = bound(fb, ff, name_t)
    out["bwd_bound_ms"], out["bwd_bound_by"] = bound(bb, bf, name_t)
    out.update(bytes=fb, flops=ff, bwd_bytes=bb, bwd_flops=bf)
    for impl, key in (("auto", ""), ("torch", "plain_")):
        with torch.no_grad():
            out[key + "ms"] = time_ms(torch, lambda: run(impl))
        o = run(impl)
        out[key + "bwd_ms"] = time_ms(torch, lambda: torch.autograd.grad(
            o, (q, k, v), do, retain_graph=True))
        del o
    # the library yardstick: SDPA on (B, H, T, D) copies, the same mask
    # and dropout rate (its dropout bits differ; time only)
    bhtd = [(x if layout == "BHTD" else x.transpose(1, 2)).detach()
            .contiguous().requires_grad_(True) for x in (q, k, v)]
    dob = (do if layout == "BHTD" else do.transpose(1, 2)).contiguous()
    am = None if mask is None else mask[:, None, None, :]

    def sdpa():
        return F.scaled_dot_product_attention(*bhtd, attn_mask=am,
                                              dropout_p=p, is_causal=causal)
    with torch.no_grad():
        out["library_ms"] = time_ms(torch, sdpa)
    o = sdpa()
    out["library_bwd_ms"] = time_ms(torch, lambda: torch.autograd.grad(
        o, bhtd, dob, retain_graph=True))
    del o, bhtd
    torch.cuda.empty_cache()
    return out


def phase_fused(torch, F, fa):
    B, _, T = FUSED_CELLS["bert_bthd"][:3]
    lens = [int(n) for n in np.random.default_rng(0).integers(
        T * 3 // 4, T + 1, B)]
    out = {"phase": "fused", "bert_valid_lengths": lens}
    for i, (label, (B, H, T, D, layout, causal, p)) in enumerate(
            FUSED_CELLS.items()):
        out[label] = {"shape": dict(B=B, H=H, Tq=T, Tk=T, D=D, layout=layout,
                                    causal=causal, dropout=p)}
        for dtype, name in ((torch.float32, "float32"),
                            (torch.bfloat16, "bfloat16")):
            out[label][name] = fused_case(
                torch, F, fa, B, H, T, T, D, layout, causal, p,
                None if causal else lens, dtype, seed=20 + i, timed=True)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for i, args in enumerate(FUSED_EDGES):
        for dtype, name in ((torch.float32, "float32"),
                            (torch.bfloat16, "bfloat16")):
            r = fused_case(torch, F, fa, *args, dtype, seed=40 + i,
                           timed=False)
            worst[name] = max(worst[name], r["max_abs_err"] if name ==
                              "float32" else r["rel_err"],
                              max(r["grad_rel_err"]))
    out["edge_cases"] = len(FUSED_EDGES)
    out["edge_worst_err"] = worst
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


KERNEL_CLASSES = (("fused_attention", ("fused_fwd", "fused_bwd")),
                  ("ragged_attention", ("ragged_",)),
                  ("gemm", ("gemm", "nvjet", "cutlass", "xmma")),
                  ("embedding_and_gather_backward", ("indexing_backward",
                                                     "scatter_gather")))


def kernel_class(name):
    for label, keys in KERNEL_CLASSES:
        if any(k in name for k in keys):
            return label
    return "other"


def profiled(torch, run, top):
    """Call run() (which returns its own wall seconds, ending in a device
    sync) under torch.profiler (CPU and CUDA activities): the device's
    busy share of the window (sum of kernel times over wall time; the
    profiler's own host cost makes it a lower bound), device time by
    kernel class, and the `top` kernels by device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = run()
    cuda = torch.autograd.DeviceType.CUDA
    rows = sorted(((e.self_device_time_total, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == cuda and e.self_device_time_total),
                  reverse=True)
    if not rows:
        return {"wall_s": wall, "device_busy_share": "not measured"}
    dev_ms = sum(r[0] for r in rows) / 1e3
    classes = {}
    for d, k, _ in rows:
        label = kernel_class(k)
        classes[label] = classes.get(label, 0.0) + d / 1e3
    return {"wall_s": wall, "device_ms": dev_ms,
            "device_busy_share": dev_ms / (wall * 1e3),
            "device_ms_by_class": classes,
            "top_kernels": [{"name": k[:90], "ms": d / 1e3, "count": c}
                            for d, k, c in rows[:top]]}


def trace_serve(torch, eng, prompts, n_new, Request):
    """Serve once under the profiler."""
    return profiled(torch,
                    lambda: serve(torch, eng, prompts, n_new, Request)[1], 8)


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


def phase_gpt2(torch, ra, card):
    from mxnet_tpu_torch.models import (GPT2ForCausalLM, PagedKVCache,
                                        gpt2_774m_config, init_params)
    from mxnet_tpu_torch.serving import Request, ServingEngine

    cfg = gpt2_774m_config(dropout=0.0, attention_dropout=0.0)
    require(cfg.num_layers == GPT2_LAYERS, "774M config changed")
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


# ---------------------------------------------------------------------------
# phase 7: BERT-base MLM training steps
# ---------------------------------------------------------------------------

def bert_batch(torch, cfg, B, T, M):
    """bench_bert's traffic: random ids, token types 0, valid lengths
    U[3T/4, T] (U[384, 512] at T = 512), M masked positions per row drawn
    without replacement below its valid length, random labels (numpy
    seed 0)."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, (B, T))
    vl = rng.integers(T * 3 // 4, T + 1, B)
    pos = np.stack([np.sort(rng.choice(int(n), M, replace=False))
                    for n in vl])
    labels = rng.integers(0, cfg.vocab_size, (B, M))
    arrays = (ids, np.zeros((B, T)), vl, pos, labels)
    return tuple(torch.tensor(a, dtype=torch.int32, device=DEV)
                 for a in arrays), [int(n) for n in vl]


def trace_step(torch, step, batch):
    """One training step under the profiler."""
    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(*batch)
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    return profiled(torch, run, 10)


def phase_bert(torch, fa, card):
    from mxnet_tpu_torch import rng
    from mxnet_tpu_torch.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models import (BertForMaskedLM, bert_base_config,
                                        init_params)
    from mxnet_tpu_torch.optimizer import AdamW
    from mxnet_tpu_torch.parallel import TrainStep

    def make(**kw):
        cfg = bert_base_config(dropout=0.1, attention_dropout=0.1, **kw)
        require(cfg.num_layers == BERT_LAYERS, "base config changed")
        return init_params(BertForMaskedLM(cfg, device=DEV), seed=0,
                           std=0.02), cfg

    def grads(model):
        """One float32 forward and backward of the training loss in
        train() mode, dropout drawn from a fixed generator: every
        parameter's gradient (then cleared)."""
        model.train()
        with rng.generator_scope(rng.step_generator(0, 1, DEV)):
            loss = SoftmaxCrossEntropyLoss()(model(*batch[:4]), batch[4])
            loss.mean().backward()
        g = {n: p.grad for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return g

    def train(model, steps):
        rng.seed(0)        # the same dropout stream on every path
        step = TrainStep(model, SoftmaxCrossEntropyLoss(),
                         AdamW(learning_rate=1e-4, wd=0.01), n_net_inputs=4)
        return step, [float(step(*batch)) for _ in range(steps)]

    t0 = time.perf_counter()
    model, cfg = make()
    torch.cuda.synchronize()
    out = {"phase": "bert", "card": card, "config": "bert_base_config",
           "layers": cfg.num_layers, "units": cfg.units,
           "heads": cfg.num_heads, "hidden": cfg.hidden_size,
           "vocab": cfg.vocab_size, "max_length": cfg.max_length,
           "params": cfg.num_params(),
           "init_s": time.perf_counter() - t0}
    batch, lens = bert_batch(torch, cfg, **BERT_TRAFFIC)
    B, T = batch[0].shape
    out["traffic"] = {"batch": B, "seq_len": T,
                      "masked_per_row": batch[3].shape[1],
                      "valid_lengths": lens}

    # the main path: float32 through the kernels; launches counted here
    steps = 5
    g_kernel = grads(model)
    fa.reset_launches()
    t0 = time.perf_counter()
    _, losses = train(model, steps)
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    for name in launches:
        require(launches[name] == BERT_LAYERS * steps,
                f"{name} launched {launches[name]} times, not "
                f"{BERT_LAYERS} x {steps}")
    out["launches"] = launches
    out["float32_kernel"] = {"losses": losses, "wall_s": wall,
                             "ms_per_step": wall / steps * 1e3}
    del model
    torch.cuda.empty_cache()

    # the same steps through the plain versions, from the same weights
    model, _ = make(attention_impl="torch")
    # each gradient's error over the largest gradient magnitude of the
    # layer that owns it (a Dense's weight and bias together): the
    # attention key biases' true gradient is 0 (a key bias shifts every
    # score of a query alike), so on their own both paths hold only noise
    g_plain = grads(model)
    top = {}
    for n, g in g_plain.items():
        owner = n.rsplit(".", 1)[0]
        top[owner] = max(top.get(owner, 0.0), g.abs().max().item())
    g_rel = {n: (g_kernel[n] - g).abs().max().item()
             / (top[n.rsplit(".", 1)[0]] or 1.0) for n, g in g_plain.items()}
    del g_kernel, g_plain
    worst = max(g_rel, key=g_rel.get)
    require(g_rel[worst] <= 1e-4, f"float32 gradient of {worst} differs by "
            f"{g_rel[worst]} of its layer's largest gradient")
    out["float32_grad_rel_err"] = {"worst": g_rel[worst],
                                   "worst_param": worst,
                                   "params": len(g_rel),
                                   "tol": 1e-4}
    t0 = time.perf_counter()
    _, plain = train(model, steps)
    wall = time.perf_counter() - t0
    del model
    torch.cuda.empty_cache()
    require(fa.LAUNCHES == launches, "the plain path launched a kernel")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, plain)]
    require(all(np.isfinite(losses)), f"non-finite losses {losses}")
    require(max(rel) <= 1e-5, f"losses differ by {rel} relative")
    out["float32_plain"] = {"losses": plain, "wall_s": wall,
                            "ms_per_step": wall / steps * 1e3}
    out["float32_loss_rel_diff"] = rel

    # bfloat16 weights with float32 masters on the kernel path, timed
    model, _ = make()
    model.to(torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    step, _ = train(model, 1)                       # warm-up
    n = 20
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bl = [step(*batch) for _ in range(n)]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n
    bl = [float(x) for x in bl]
    require(all(np.isfinite(bl)), f"non-finite bfloat16 losses {bl}")
    require(bl[-1] < bl[0], f"the bfloat16 loss did not fall: {bl}")
    flops_per_token = 6 * cfg.num_params() \
        + 12 * cfg.num_layers * cfg.units * T
    out["bfloat16_kernel"] = {
        "card": card, "steps": n, "losses": bl, "ms_per_step": dt * 1e3,
        "tokens_per_s": B * T / dt,
        "bert_base_mlm_mfu": flops_per_token * B * T / dt
        / PEAK_FLOPS["bfloat16"],
        "achieved_tflops": flops_per_token * B * T / dt / 1e12,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    out["bfloat16_kernel_trace"] = trace_step(torch, step, batch)
    del step, model
    torch.cuda.empty_cache()
    emit(out)
    return out


def kernel_entry(name, source, launches, f32, b16, card, **extra):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": f32["max_abs_err"],
            "max_abs_err_bf16": b16["max_abs_err"],
            "ms": f32["ms"], "kernel_ms": f32["ms"],
            "plain_ms": f32["plain_ms"],
            "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"],
            "library_ms": f32["library_ms"],
            "ms_bf16": b16["ms"], "plain_ms_bf16": b16["plain_ms"],
            "bound_ms_bf16": b16["bound_ms"],
            "library_ms_bf16": b16["library_ms"], "card": card, **extra}


def fused_entries(fused, launches, card):
    """The fused pair's two kernels-line entries: times at the BERT-base
    BTHD cell (the main path's shape), the BHTD and GPT-2 cells beside."""
    main = fused["bert_bthd"]
    f32, b16 = main["float32"], main["bfloat16"]
    fwd = kernel_entry(
        "fused_attention_fwd", FUSED_SOURCE, launches["fused_attention_fwd"],
        f32, b16, card,
        other_cells={c: {t: fused[c][t]["ms"] for t in ("float32",
                                                        "bfloat16")}
                     for c in ("bert_bhtd", "gpt2_774m_causal")})

    def bwd_view(r):
        return {"max_abs_err": max(r["grad_max_abs_err"]),
                "ms": r["bwd_ms"], "plain_ms": r["plain_bwd_ms"],
                "bound_ms": r["bwd_bound_ms"], "bound_by": r["bwd_bound_by"],
                "library_ms": r["library_bwd_ms"]}
    bwd = kernel_entry(
        "fused_attention_bwd", FUSED_SOURCE, launches["fused_attention_bwd"],
        bwd_view(f32), bwd_view(b16), card,
        grad_rel_err=max(f32["grad_rel_err"]),
        grad_rel_err_bf16=max(b16["grad_rel_err"]),
        other_cells={c: {t: fused[c][t]["bwd_ms"] for t in ("float32",
                                                            "bfloat16")}
                     for c in ("bert_bhtd", "gpt2_774m_causal")})
    return [fwd, bwd]


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import _build
    from mxnet_tpu_torch.ops import fused_attention as fa
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
    fused = phase_fused(torch, F, fa)
    bert = phase_bert(torch, fa, card)

    kernels = [kernel_entry(name, SOURCE, gpt2["launches"][name],
                            res["float32"], res["bfloat16"], card)
               for name, res in (("ragged_span_attention", span),
                                 ("ragged_decode_attention", decode))]
    kernels += fused_entries(fused, bert["launches"], card)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
