#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mxnet_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (nvcc) and this checkout; never
JAX. Phases, each printing one JSON line, and any failure raises (the
script then exits non-zero without the final `ok` line):

  1. device   the card's name and power limit (nvidia-smi), torch, CUDA.
  2. build    every CUDA kernel of the port built from csrc/ (one nvcc
              per source, in parallel) and the ptxas resource report.
  3. span     ragged_span_attention's kernels against their plain
              PyTorch version: float32 q on the CUDA-core kernel (tol
              1e-5 absolute), bfloat16 q on the tensor-core kernel (tol
              1.2e-2 of the largest plain value). Two timed cells at GPT-2
              774M serving shapes (B=8, Sq=64, H=20, D=64, page 64, 16
              pages per slot, 128 pages, permuted table): the kernel cell
              (long contexts, mixed q_counts) and serve_decode, phase
              gpt2's decode dispatch (q_counts 1, lengths its prompts +
              16); then edge cases (SPAN_EDGES: split boundaries, splits
              with no live page, both routes in bfloat16, misaligned
              pools). Every call: the family span_route names launches
              (counted under its key alone), two runs give the same
              bits, dead rows and idle slots are exactly 0. Times of
              kernel, plain version and the F.scaled_dot_product_attention
              yardstick (and their ratio), and the bound; the kernel's
              time with the pools warm in L2 and under the split plan's
              other targets (SPLIT_TARGETS, each checked too).
  3b. span_int8  the same for int8 pools with per-(page, head) float32
              scales, bfloat16 q held to INT8_BF16_REL_TOL (2e-3 of the
              largest plain value; the int8 kernels keep P in float32),
              and the smallest input that showed the tensor-core
              kernel's former single rounding of P (INT8_ROUNDING_CASE);
              the yardstick is SDPA on the dequantized gathered view.
  4. decode   ragged_decode_attention at the decode cell (B=8, H=20, D=64,
              page 64, 16 pages, lengths up to 1024 and a length-0
              slot) and DECODE_EDGES (the split plan's boundaries, D =
              40, 12 and 128, misaligned pools), against the plain
              version of its split (float32 1e-5 absolute, bfloat16 1.2e-2
              of the largest plain value) and the unsplit one; one launch
              a call, the same bits twice, length-0 slots exactly 0; times
              of kernel, plain, SDPA and the span kernel at Sq=1 on the
              same inputs, the bound, the kernel under DEC_SPLIT_TARGETS,
              and whether it agrees bit for bit with the span kernel at
              Sq=1.
  5. gpt2     GPT-2 774M at full width (36 layers, 1280 units, 20
              heads, vocab 50257, 1024 positions; seeded random
              weights) served by ServingEngine(num_slots=8,
              max_length=1024, page_size=64): 8 greedy requests, prompts
              U[16, 128], 32 new tokens each, float32, once through the
              kernels and once through the plain versions (attn_impl=
              "torch"). Streams must agree (a divergence is allowed only
              where the plain path's top-2 logit gap is below 1e-4); the
              CUDA-core span kernel must have run 36 times per dispatch
              (the tensor-core one never). One ragged
              single-token forward on the served cache drives the decode
              kernel (logits within 1e-4 of the plain path). Then the
              kernel path serves the same traffic in bfloat16, timed (the
              tensor-core span kernel 36 times a dispatch, the CUDA-core
              one never), and the bfloat16 plain path once: with d the
              largest |kernel - plain| first-token logit, first tokens
              agree wherever the plain top-2 gap exceeds 2*d.
              The float32 and bfloat16 kernel paths each serve once more
              under torch.profiler: device busy share, top kernels and
              the span kernel's device ms a serve.
  5b. gpt2_int8  the same model and traffic on int8 KV pages
              (kv_dtype="int8", chunk_tokens 64): float32 through the
              kernels (the int8 span kernel exactly 36 times a dispatch,
              the float ragged kernels never) and through the plain
              versions (streams agree under the 1e-4 top-2 rule, the gap
              read on the int8 path's own write schedule); against phase
              5's float32 streams: d = the largest |int8 - float32|
              first-token logit of each prompt is measured, and the first
              tokens must agree wherever float32's top-2 gap exceeds 2*d,
              the engine's token must be the int8 path's argmax wherever
              that path's gap exceeds 1e-2; the cache quantizer writes
              the CPU's bytes on the card; one single-token forward on
              the served cache through the span kernel (logits within
              1e-4 of the plain path); then bfloat16 on int8 pages, timed
              (the int8 tensor-core span kernel 36 times a dispatch) and
              profiled, and KV bytes per token of each page dtype.
  5c. prefix  the 774M model in float32 on the kernel path, float and
              int8 pages, the prefix cache off and on: every prompt is a
              256-token shared prefix (4 pages) and a unique tail
              U[16, 128]; request 0 alone, then requests 1-7 together,
              then the bare prefix (the copy-on-write split), 32 greedy
              tokens each. Streams equal with the cache on and off,
              7*256 + 255 prompt tokens saved, prefill(on) + saved =
              prefill(off), the page audit clean, the tree's pages
              untouched by the split; ms per serve.
  6. fused    fused_attention's CUDA forward and backward against its
              plain PyTorch version (forward output, dq, dk, dv) at
              BERT-base shapes (B=32, T=512, H=12, D=64, key padding from
              valid lengths U[384, 512], dropout 0.1) in BTHD and in
              BHTD, at GPT-2 774M causal shapes (B=8, T=1024, H=20, D=64,
              dropout 0.1, BTHD), float32 through the "cuda_core" route
              (csrc/fused_attention.cu: split TF32 by mma.sync; forward
              1e-5 absolute, gradients 1e-4 relative to the largest) and
              bfloat16 through the tensor-core kernels
              (forward and gradients 1.2e-2 relative to the largest), plus
              edge cases (a fully padded batch row, causal Tq < Tk, D = 40
              and 128, T off the 64 grid, T = 1100 past the reference's
              whole-row limit, D = 12, which the route rule sends to the
              CUDA-core kernels in bfloat16); every call must pass
              fused_attention.supported(), launch the family
              fused_attention.kernel_route() names (and count under its
              keys alone), and give bit-identical gradients in two
              backward runs (float32 and bfloat16); forward and backward
              times of kernel, plain version and the
              F.scaled_dot_product_attention yardstick (and their ratio),
              and the bound (float32 also against the split-TF32 rate,
              TF32X3_FLOPS); the CUDA-core kernels in bfloat16 at the
              BERT-base cell on padded rows, and timed at that cell with
              D = 40 on rows 44 elements apart (SDPA beside).
  7. bert     BERT-base MLM training at full width (12 layers, 768 units,
              12 heads, 3072 hidden, vocab 30522, 512 positions; seeded
              random weights) through parallel.TrainStep with AdamW(1e-4,
              wd 0.01), dropout and attention dropout 0.1, on bench.py's
              bench_bert traffic (B=32, T=512, 76 masked positions per
              row below its valid length, valid lengths U[384, 512],
              random labels): 5 float32 steps through the kernels (the
              main path in float32: the CUDA-core fused forward and
              backward 12 times a step, the tensor-core pair never) and
              5 through the plain versions from the same weights and
              seed (losses agree within 1e-5 relative at every step);
              before them, one float32 forward and backward of each path
              with the same dropout stream: every parameter's gradient
              within 1e-4 of the largest gradient magnitude of the
              layer that owns it (this pins the backward through all
              12 layers); then 20 timed bfloat16 steps (float32 masters)
              on the kernel path (the main path in bfloat16: the
              tensor-core pair 12 times a step, the CUDA-core pair
              never) — the loss must fall — with ms per step, tokens/s,
              peak memory and bert_base_mlm_mfu; then one more bfloat16
              step under torch.profiler (the fused kernels' share of
              device time).
  7b. gpt2_train  GPT-2 774M at full width (seeded random weights) on
              the cache=None training path: one forward and backward of
              the next-token loss, B=2, T=1024, dropout and attention
              dropout 0.1, float32 and bfloat16, kernel path against the
              plain path from the same weights and dropout generator
              (losses within 1e-5 relative in float32, 1e-4 in
              bfloat16); each kernel pass launches its family's fused
              forward and backward exactly 36 times (float32 the
              "cuda_core" pair, bfloat16 the tensor-core pair) and
              nothing else; the kernel path's ms a pass (median of 3)
              and one profiled pass (busy share, time by kernel class).
  8. kernels  one line listing every ported kernel with its launches on
              its main path (phase 5's float32 serve for the CUDA-core
              span and the decode kernel, its bfloat16 serve for the
              tensor-core span kernel, phase 5b's serves for the int8
              ones, phase 7's float32 steps for the CUDA-core fused
              pair, its bfloat16 steps for the tensor-core pair; each
              fused entry also with its launches in phase 7b), errors,
              times, bound and library times.
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
# the float32 fused kernels' products as split TF32, three tensor-core
# products each: dense TF32 of the H100 SXM over three
TF32X3_FLOPS = 494.7e12 / 3
# bfloat16 kernel-against-plain tolerance, relative to the largest
# magnitude of the plain result: 1.5 units in the last place of it (bf16
# spacing is at most 2**-7 of a value); both round once from float32
BF16_REL_TOL = 1.2e-2
# bfloat16 q over int8 pages, kernel against plain: both keep P in
# float32 (the tensor-core kernel as three bfloat16 terms), and both
# round the output to bfloat16 once, so they differ only where their
# float32 results straddle a bfloat16 rounding point (a flip costs one
# spacing, 2**-8 to 2**-7 of that element), rare on the largest
# elements; 2e-3 of the largest plain value (a single bfloat16 rounding
# of P read 4.6e-3 and 7.4e-3, PERF.md section 6)
INT8_BF16_REL_TOL = 2e-3
# the smallest input on which the int8 tensor-core kernel's single
# bfloat16 rounding of P exceeded INT8_BF16_REL_TOL (found by
# mxnet_tpu_torch/tools/compare_kernels.py on the kernel that rounded P
# once, before it was split into bfloat16 terms:
# one slot, one head, D = 64, page 16, one query row, make_pool seed):
# (keys, seed)
INT8_ROUNDING_CASE = (1, 0)
# bfloat16 BERT-base, kernel path against plain path, one forward and
# backward from the same weights and dropout stream (readings in PERF.md
# section 6): each gradient's difference over its layer's largest
# float32 gradient may reach this, or the plain path's own bfloat16
# error against float32 where that is larger (a gradient summed over
# every token, such as the token-type embedding's, cancels and keeps few
# bits in bfloat16); the loss, taken in float32 from the logits, agrees
# to this relative difference
BF16_MODEL_GRAD_TOL = 5e-2
BF16_MODEL_LOSS_TOL = 1e-4
SOURCE = "mxnet_tpu_torch/csrc/ragged_attention.cu"
SPAN_TC_SOURCE = "mxnet_tpu_torch/csrc/ragged_attention_tc.cu"
SPAN, SPAN_TC = "ragged_span_attention", "ragged_span_attention_tc"
INT8, INT8_TC = "ragged_span_attention_int8", "ragged_span_attention_int8_tc"
FUSED_SOURCE = "mxnet_tpu_torch/csrc/fused_attention.cu"
FUSED_TC_SOURCE = "mxnet_tpu_torch/csrc/fused_attention_tc.cu"
REPLACES = {
    "ragged_span_attention":
        "mxnet_tpu/ops/pallas_attention.py:576 _ragged_span_kernel",
    "ragged_decode_attention":
        "mxnet_tpu/ops/pallas_attention.py:402 _ragged_decode_kernel",
    INT8:
        "mxnet_tpu/ops/pallas_attention.py:633 _ragged_span_quant_kernel",
    "fused_attention_fwd":
        "mxnet_tpu/ops/pallas_attention.py:201 _fwd_kernel_packed (BTHD); "
        "mxnet_tpu/ops/pallas_attention.py:104 _fwd_kernel (BHTD)",
    "fused_attention_bwd":
        "mxnet_tpu/ops/pallas_attention.py:224 _bwd_kernel_packed (BTHD); "
        "mxnet_tpu/ops/pallas_attention.py:120 _bwd_kernel (BHTD)",
}
# the tensor-core kernels replace the same Pallas bodies, for bfloat16
REPLACES[SPAN_TC] = REPLACES[SPAN]
REPLACES[INT8_TC] = REPLACES[INT8]
REPLACES["fused_attention_fwd_tc"] = REPLACES["fused_attention_fwd"]
REPLACES["fused_attention_bwd_tc"] = REPLACES["fused_attention_bwd"]
GPT2_LAYERS = 36
BERT_LAYERS = 12
# phase 6 cells: (B, H, T, D, layout, causal, dropout); the BERT cells
# take key padding from valid lengths U[3T/4, T] (numpy seed 0)
FUSED_CELLS = {"bert_bthd": (32, 12, 512, 64, "BTHD", False, 0.1),
               "bert_bhtd": (32, 12, 512, 64, "BHTD", False, 0.1),
               "gpt2_774m_causal": (8, 20, 1024, 64, "BTHD", True, 0.1)}
# edge cases (B, H, Tq, Tk, D, layout, causal, dropout, valid lengths): a
# fully padded batch row, causal Tq < Tk, head dims 40 and 128, T off
# the 64 grid, T past the reference's whole-row limit (MAX_FUSED_T), and
# head dim 12, whose 24-byte rows send bfloat16 to the CUDA-core kernels
# (padded keys BTHD, and causal Tq < Tk BHTD)
FUSED_EDGES = [(3, 2, 200, 200, 64, "BTHD", False, 0.1, [0, 150, 200]),
               (2, 3, 100, 200, 64, "BHTD", True, 0.1, None),
               (2, 3, 130, 130, 40, "BTHD", False, 0.1, [77, 130]),
               (2, 2, 130, 130, 128, "BTHD", True, 0.1, None),
               (2, 2, 70, 70, 128, "BHTD", False, 0.0, [70, 1]),
               (1, 2, 1100, 1100, 64, "BTHD", False, 0.1, [700]),
               (2, 3, 90, 90, 12, "BTHD", False, 0.1, [0, 90]),
               (2, 3, 70, 150, 12, "BHTD", True, 0.1, None)]
# launch-count keys of each kernel family, forward and backward
FAMILY_KEYS = {"tensor_core": ("fused_attention_fwd_tc",
                               "fused_attention_bwd_tc"),
               "cuda_core": ("fused_attention_fwd", "fused_attention_bwd")}
# span cells: the split plan's other targets timed beside its own
# (ops/ragged_attention.py _BLOCKS_PER_SM), in blocks an SM
SPLIT_TARGETS = (1, 2, 8)
# phase 7 traffic (bench.py bench_bert): batch, sequence, masked per row
BERT_TRAFFIC = dict(B=32, T=512, M=76)
# phase 7b: GPT-2 774M's training forward and backward, batch and sequence
GPT2_TRAIN = dict(B=2, T=1024)
DEV = "cuda"


def emit(obj):
    print(json.dumps(obj), flush=True)


def require(cond, msg):
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------

def time_ms(torch, fn, iters=25, warmup=3, cold=True):
    """Median device time of fn() over `iters` launches, CUDA events
    around each. Before each launch a 64 MB buffer is rewritten (the
    caller meets these pages cold in L2, as on the serving path: 36
    layers of pools do not fit in it; `cold=False` skips it) and the
    stream is held by a short device sleep so that host-side wrapper
    work is not timed."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEV)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        if cold:
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


def attention_work(lengths, q_counts, S, P, H, D, itemsize, out_rows,
                   kv_itemsize=None, scale_bytes=0):
    """Bytes the function must move and the operations it must do for
    these inputs: live q rows, the live K/V pages of each slot (each read
    once, at kv_itemsize bytes an element, plus `scale_bytes` per live
    (page, head) for int8 pages), the whole output written once; 4*D
    flops per (live row, visible key) pair and head."""
    kv_itemsize = itemsize if kv_itemsize is None else kv_itemsize
    kv_bytes = q_bytes = pairs = 0
    for length, qc in zip(lengths, q_counts):
        if qc <= 0:
            continue
        pages = min(-(-(length + qc - 1) // S), P)
        kv_bytes += 2 * pages * S * H * D * kv_itemsize \
            + pages * H * scale_bytes
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

def make_pool(torch, B, Sq, H, D, S, P, N, dtype, seed, quant=False):
    """q (B, Sq, H, D) in `dtype`, k/v pools (N, S, H, D), a permuted
    (B, P) table and the (N, H) k/v scales: None for float pools; with
    `quant` the pools are int8 codes of the same gaussian slabs with
    per-(page, head) absmax/127 float32 scales (tests/test_quant_kv.py's
    construction)."""
    rng = np.random.default_rng(seed)
    q = torch.tensor(rng.standard_normal((B, Sq, H, D)), dtype=dtype,
                     device=DEV)
    k = rng.standard_normal((N, S, H, D))
    v = rng.standard_normal((N, S, H, D))
    table = torch.tensor(rng.permutation(N)[:B * P].reshape(B, P),
                         dtype=torch.int32, device=DEV)
    if not quant:
        return (q, torch.tensor(k, dtype=dtype, device=DEV),
                torch.tensor(v, dtype=dtype, device=DEV), table, None, None)
    codes, scales = [], []
    for x in (k, v):
        s = (np.abs(x).max(axis=(1, 3)) / 127.0).astype(np.float32)
        c = np.clip(np.round(x / s[:, None, :, None]), -127, 127)
        codes.append(torch.tensor(c.astype(np.int8), device=DEV))
        scales.append(torch.tensor(s, device=DEV))
    return (q, *codes, table, *scales)


def dense_yardstick(torch, kp, vp, table, lengths, Sq, ks=None, vs=None,
                    dtype=None):
    """The inputs of the library yardstick: the gathered dense (B, H, T,
    D) view (int8 pools dequantized, in q's dtype) and the same
    causal-offset mask. Built outside the timing."""
    B, P = table.shape
    S, H, D = kp.shape[1:]
    tbl = table.long()
    k, v = kp[tbl], vp[tbl]
    if ks is not None:
        k = (k.float() * ks[tbl][:, :, None, :, None]).to(dtype)
        v = (v.float() * vs[tbl][:, :, None, :, None]).to(dtype)
    k = k.reshape(B, P * S, H, D).transpose(1, 2)
    v = v.reshape(B, P * S, H, D).transpose(1, 2)
    pos = torch.arange(P * S, device=DEV)
    limit = lengths.long()[:, None] + torch.arange(Sq, device=DEV)
    mask = (pos[None, None, :] < limit[:, :, None])[:, None]
    return k.contiguous(), v.contiguous(), mask


def check_close(got, ref, f32, name, tol=BF16_REL_TOL):
    """Kernel against plain: float32 within 1e-5 absolute, bfloat16
    within `tol` of the largest plain magnitude; finite. Returns (max abs
    error, that error over the largest plain magnitude)."""
    err = (got.float() - ref.float()).abs().max().item()
    top = ref.float().abs().max().item()
    rel = err / top if top else err
    require((err <= 1e-5) if f32 else (rel <= tol),
            f"{name}: max abs err {err} (relative {rel}, tol {tol})")
    require(bool(got.float().isfinite().all()), f"{name}: non-finite")
    return err, rel


def misaligned(torch, t):
    """A contiguous copy of `t` whose base lies 8 bytes past a 16-byte
    boundary (4 bytes for int8): the span route rule refuses it."""
    shift = 4 if t.element_size() <= 2 else 2
    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=DEV)
    out = buf[shift:shift + t.numel()].view(t.shape)
    out.copy_(t)
    require(out.data_ptr() % 16 != 0, "misaligned copy is aligned")
    return out


def span_call(torch, ra, args, kw, label):
    """One checked kernel call of ragged_span_attention: it launches the
    family that span_route names (one launch, counted under that family's
    key alone), a second run gives the same bits, and dead rows are
    exact zeros. Returns (output, route)."""
    q, kp, vp = args[:3]
    route = ra.span_route(q, kp, vp)
    key = ra.span_launch_key(route, kp.dtype == torch.int8)
    before = dict(ra.LAUNCHES)
    got = ra.ragged_span_attention(*args, impl="auto", **kw)
    again = ra.ragged_span_attention(*args, impl="auto", **kw)
    torch.cuda.synchronize()
    moved = {k: ra.LAUNCHES[k] - before[k] for k in before
             if ra.LAUNCHES[k] != before[k]}
    require(moved == {key: 2}, f"{label}: route {route} but launches "
            f"moved {moved}")
    require(torch.equal(got, again), f"{label}: two runs differ")
    qc = kw["q_counts"]
    dead = torch.arange(q.shape[1], device=DEV)[None, :] >= qc[:, None]
    require(bool((got[dead] == 0).all()),
            f"{label}: dead rows / idle slots are not exactly 0")
    return got, route


def span_cell(torch, F, ra, quant, label, lengths, q_counts, seed,
              B=8, Sq=64, H=20, D=64, S=64, P=16, N=128):
    """A timed cell of the span kernel, float32 and bfloat16 q: kernel
    against plain (and the checks of span_call), times of kernel, plain
    version and the SDPA yardstick on the gathered view, the bound; the
    kernel's time with the pools warm in L2 and under SPLIT_TARGETS."""
    out = {"shape": dict(B=B, Sq=Sq, H=H, D=D, S=S, P=P, N=N),
           "lengths": lengths, "q_counts": q_counts,
           "splits": ra.span_split_plan(
               B, H, Sq, P,
               torch.cuda.get_device_properties(0).multi_processor_count)}
    L = torch.tensor(lengths, dtype=torch.int32, device=DEV)
    qc = torch.tensor(q_counts, dtype=torch.int32, device=DEV)
    for dtype, name in ((torch.float32, "float32"),
                        (torch.bfloat16, "bfloat16")):
        q, kp, vp, table, ks, vs = make_pool(torch, B, Sq, H, D, S, P, N,
                                             dtype, seed, quant)
        kw = dict(q_counts=qc, k_scale=ks, v_scale=vs)
        args = (q, kp, vp, table, L)

        def kernel():
            return ra.ragged_span_attention(*args, impl="auto", **kw)

        def plain():
            return ra.ragged_span_attention(*args, impl="torch", **kw)
        got, route = span_call(torch, ra, args, kw, f"{label} {name}")
        ref = plain()
        f32 = dtype == torch.float32
        tol = INT8_BF16_REL_TOL if quant else BF16_REL_TOL
        err, rel = check_close(got, ref, f32, f"{label} {name}", tol)
        k, v, mask = dense_yardstick(torch, kp, vp, table, L, Sq, ks, vs,
                                     dtype)
        qt = q.transpose(1, 2).contiguous()
        nbytes, flops = attention_work(
            lengths, q_counts, S, P, H, D, q.element_size(), B * Sq,
            kv_itemsize=kp.element_size(), scale_bytes=8 if quant else 0)
        bms, by = bound(nbytes, flops, name)
        ms = time_ms(torch, kernel)
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, k, v, attn_mask=mask))
        # what holds the kernel: the same launch with the pools warm in
        # L2, and under the split plan's other targets (each checked
        # against the plain version too)
        targets, keep = {}, ra._BLOCKS_PER_SM
        try:
            for k in SPLIT_TARGETS:
                ra._BLOCKS_PER_SM = k
                check_close(kernel(), ref, f32, f"{label} {name} target {k}",
                            tol)
                targets[k] = time_ms(torch, kernel)
        finally:
            ra._BLOCKS_PER_SM = keep
        out[name] = {
            "route": route, "max_abs_err": err, "rel_err": rel,
            "tol": 1e-5 if f32 else tol,
            "tol_kind": "absolute" if f32 else "relative",
            "ms": ms, "plain_ms": time_ms(torch, plain), "library_ms": lib,
            "ms_over_library": ms / lib, "bound_ms": bms, "bound_by": by,
            "ms_over_bound": ms / bms, "ms_warm_l2":
                time_ms(torch, kernel, cold=False),
            "ms_by_split_target": targets, "bytes": nbytes,
            "flops": flops}
        del k, v, mask, q, kp, vp
    return out


# span edge cases (B, Sq, H, D, S, P, lengths, q_counts, misaligned):
# all idle, all decode, ragged tails, lengths 0 and page size 8 (the
# CUDA-core route in bfloat16: S % 16 != 0); D = 40 / S = 12 (the
# CUDA-core route); D = 128 at S = 64 (the tensor cores in bfloat16);
# then, where the split plan cuts a slot's pages over several blocks: a
# slot whose live pages end exactly on a split boundary with splits past
# them that hold no live page, a length of P*S - q_count + 1 (every
# split live), q_count 64 at length 1, and an idle slot, at S = 16 (a
# key tile spans four pages); D = 64 at S = 64 over three live splits;
# D = 128 at S = 128 (a page spans two key tiles) with a second query
# tile; and pools 8 bytes off a 16-byte boundary (the CUDA-core route
# in bfloat16)
SPAN_EDGES = [(5, 8, 2, 16, 8, 4, [5, 1, 24, 13, 8], qcs, False)
              for qcs in ([0] * 5, [1] * 5, [8] * 5, [3, 7, 2, 6, 1])]
SPAN_EDGES += [(3, 20, 3, 40, 12, 3, [0, 20, 36], [20, 17, 3], False),
               (2, 33, 1, 128, 64, 2, [60, 100], [33, 29], False),
               (4, 64, 2, 64, 16, 8, [60, 124, 1, 10], [5, 5, 64, 0],
                False),
               (3, 64, 2, 64, 64, 6, [300, 1, 130], [17, 64, 1], False),
               (2, 70, 2, 128, 128, 4, [400, 5], [70, 3], False),
               (2, 16, 2, 64, 64, 2, [70, 5], [16, 16], True)]


def phase_span(torch, F, ra, quant=False):
    """Phase 3 (float pools) or, with `quant`, 3b (int8 pools): the
    kernel cell (long contexts, mixed q_counts), the serve's decode cell
    (phase gpt2's dispatch shape: one live row a slot, contexts of its
    prompts + 16) and the edge cases."""
    label = "span_int8" if quant else "span"
    out = {"phase": label}
    out.update(span_cell(torch, F, ra, quant, label,
                         [1, 1000, 3, 960, 500, 1, 1023, 64],
                         [1, 4, 64, 17, 0, 64, 1, 33], 0))
    out["serve_decode"] = span_cell(
        torch, F, ra, quant, f"{label} serve_decode",
        [128, 103, 89, 62, 66, 36, 40, 33], [1] * 8, 2)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    routes = {"float32": set(), "bfloat16": set()}
    for i, (b, sq, h, d, s, p, lens, qcs, off) in enumerate(SPAN_EDGES):
        for dtype in (torch.float32, torch.bfloat16):
            q, kp, vp, table, ks, vs = make_pool(
                torch, b, sq, h, d, s, p, b * p + 1, dtype, 10 + i, quant)
            if off:
                kp, vp = misaligned(torch, kp), misaligned(torch, vp)
            Le = torch.tensor(lens, dtype=torch.int32, device=DEV)
            qce = torch.tensor(qcs, dtype=torch.int32, device=DEV)
            kw = dict(q_counts=qce, k_scale=ks, v_scale=vs)
            args = (q, kp, vp, table, Le)
            key = "float32" if dtype == torch.float32 else "bfloat16"
            got, route = span_call(torch, ra, args, kw,
                                   f"{label} edge {i} {key}")
            ref = ra.ragged_span_attention(*args, impl="torch", **kw)
            f32 = dtype == torch.float32
            err, rel = check_close(
                got, ref, f32, f"{label} edge {i} {dtype}",
                INT8_BF16_REL_TOL if quant else BF16_REL_TOL)
            worst[key] = max(worst[key], err if f32 else rel)
            routes[key].add(route)
    # both branches of the route rule are held in bfloat16; float32
    # always takes the CUDA cores
    require(routes["bfloat16"] == {"tensor_core", "cuda_core"}
            and routes["float32"] == {"cuda_core"},
            f"{label}: edge routes {routes}")
    out["edge_cases"] = len(SPAN_EDGES)
    out["edge_routes"] = {k: sorted(v) for k, v in routes.items()}
    out["edge_max_abs_err_f32"] = worst["float32"]
    out["edge_max_rel_err_bf16"] = worst["bfloat16"]
    out["bf16_tol"] = INT8_BF16_REL_TOL if quant else BF16_REL_TOL
    if quant:
        out["rounding_case"] = int8_rounding_case(torch, ra)
    emit(out)
    return out


def int8_rounding_case(torch, ra):
    """The smallest input that showed the int8 tensor-core kernel's
    single bfloat16 rounding of P (INT8_ROUNDING_CASE), held to
    INT8_BF16_REL_TOL."""
    keys, seed = INT8_ROUNDING_CASE
    P = -(-keys // 16)
    q, kp, vp, table, ks, vs = make_pool(torch, 1, 1, 1, 64, 16, P, P + 1,
                                         torch.bfloat16, seed, quant=True)
    args = (q, kp, vp, table,
            torch.tensor([keys], dtype=torch.int32, device=DEV))
    kw = dict(q_counts=torch.ones(1, dtype=torch.int32, device=DEV),
              k_scale=ks, v_scale=vs)
    got, route = span_call(torch, ra, args, kw, "span_int8 rounding case")
    require(route == "tensor_core", f"rounding case routed to {route}")
    ref = ra.ragged_span_attention(*args, impl="torch", **kw)
    err, rel = check_close(got, ref, False, "span_int8 rounding case",
                           INT8_BF16_REL_TOL)
    return {"keys": keys, "seed": seed, "shape": dict(B=1, Sq=1, H=1, D=64,
                                                      S=16, P=P),
            "max_abs_err": err, "rel_err": rel, "tol": INT8_BF16_REL_TOL}


# decode edge cases (B, H, D, S, P, lengths, misaligned): lengths 0, 1,
# a whole page, a page and one key, every page, and those around the
# split plan's boundaries (filled in from the plan: "pps" stands for its
# pages a split times S); D = 40 at S = 16, D = 12 at S = 8 (one column a
# lane, 24-byte rows), D = 128 at S = 32, and pools 8 bytes off a 16-byte
# boundary (narrower copies)
DECODE_EDGES = [(8, 2, 64, 64, 16, [0, 1, "pps", "pps+1", "P*S", 64, 65,
                                    "2pps-1"], False),
                (3, 3, 40, 16, 8, [0, 17, 128], False),
                (3, 2, 12, 8, 5, [40, 9, 1], False),
                (2, 4, 128, 32, 6, [192, 33], False),
                (3, 2, 64, 64, 4, [256, 1, 65], True)]
# the decode plan's other targets timed beside its own
# (ops/ragged_attention.py _DEC_BLOCKS_PER_SM), in blocks an SM
DEC_SPLIT_TARGETS = (1, 4, 8, 32)


def decode_call(torch, ra, args, label):
    """One checked kernel call of ragged_decode_attention: it launches
    the decode kernel once (counted under its key alone), a second run
    gives the same bits, and length-0 slots are exact zeros. Returns the
    output and the split plain version at the kernel's plan."""
    q, kp, vp, table, L = args
    before = dict(ra.LAUNCHES)
    got = ra.ragged_decode_attention(*args, impl="auto")
    again = ra.ragged_decode_attention(*args, impl="auto")
    torch.cuda.synchronize()
    moved = {k: ra.LAUNCHES[k] - before[k] for k in before
             if ra.LAUNCHES[k] != before[k]}
    require(moved == {"ragged_decode_attention": 2},
            f"{label}: launches moved {moved}")
    require(torch.equal(got, again), f"{label}: two runs differ")
    require(bool((got[L == 0] == 0).all()), f"{label}: length 0 != 0")
    B, H, D = q.shape
    n = ra.decode_split_plan(B, H, table.shape[1],
                             torch.cuda.get_device_properties(0)
                             .multi_processor_count)
    ref = ra._ragged_decode_split_reference(q, kp, vp, table, L,
                                            1.0 / D ** 0.5, n)
    return got, ref, n


def phase_decode(torch, F, ra):
    """Phase 4: the decode kernel at the decode cell (one query row a
    slot, long and short contexts and a length-0 slot) and the edge
    cases, against the split plain version at the kernel's plan (and the
    unsplit one), float32 at 1e-5 absolute and bfloat16 at BF16_REL_TOL;
    times of kernel, plain version, SDPA and the span kernel at Sq = 1 on
    the same inputs, the bound, and the kernel under DEC_SPLIT_TARGETS."""
    B, H, D, S, P, N = 8, 20, 64, 64, 16, 128
    lengths = [1, 1000, 3, 960, 0, 2, 1024, 64]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {"phase": "decode", "shape": dict(B=B, H=H, D=D, S=S, P=P, N=N),
           "lengths": lengths, "splits": ra.decode_split_plan(B, H, P, sms)}
    L = torch.tensor(lengths, dtype=torch.int32, device=DEV)
    ones = torch.ones(B, dtype=torch.int32, device=DEV)
    for dtype, name in ((torch.float32, "float32"),
                        (torch.bfloat16, "bfloat16")):
        q4, kp, vp, table, _, _ = make_pool(torch, B, 1, H, D, S, P, N,
                                            dtype, 1)
        q = q4[:, 0].contiguous()
        args = (q, kp, vp, table, L)

        def kernel():
            return ra.ragged_decode_attention(*args, impl="auto")

        def plain():
            return ra.ragged_decode_attention(*args, impl="torch")

        def span():
            return ra.ragged_span_attention(q4, kp, vp, table, L,
                                            q_counts=ones, impl="auto")
        got, ref, _ = decode_call(torch, ra, args, f"decode {name}")
        f32 = dtype == torch.float32
        err, rel = check_close(got, ref, f32, f"decode {name}")
        err_unsplit, _ = check_close(got, plain(), f32,
                                     f"decode {name} (unsplit plain)")
        span1 = span()[:, 0]
        k, v, mask = dense_yardstick(torch, kp, vp, table, L, 1)
        qt = q4.transpose(1, 2).contiguous()
        nbytes, flops = attention_work(lengths, [1] * B, S, P, H, D,
                                       q.element_size(), B)
        bms, by = bound(nbytes, flops, name)
        ms = time_ms(torch, kernel)
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, k, v, attn_mask=mask))
        targets, keep = {}, ra._DEC_BLOCKS_PER_SM
        try:
            for t in DEC_SPLIT_TARGETS:
                ra._DEC_BLOCKS_PER_SM = t
                n = ra.decode_split_plan(B, H, P, sms)
                check_close(kernel(), ra._ragged_decode_split_reference(
                    *args, 1.0 / D ** 0.5, n), f32,
                    f"decode {name} target {t}")
                targets[t] = {"splits": n, "ms": time_ms(torch, kernel)}
        finally:
            ra._DEC_BLOCKS_PER_SM = keep
        out[name] = {
            "max_abs_err": err, "rel_err": rel,
            "max_abs_err_unsplit_plain": err_unsplit,
            "tol": 1e-5 if f32 else BF16_REL_TOL,
            "tol_kind": "absolute" if f32 else "relative",
            "span_sq1_bit_identical": bool(torch.equal(span1, got)),
            "span_sq1_max_abs_diff":
                (span1.float() - got.float()).abs().max().item(),
            "ms": ms, "plain_ms": time_ms(torch, plain), "library_ms": lib,
            "ms_over_library": ms / lib, "span_sq1_ms": time_ms(torch, span),
            "bound_ms": bms, "bound_by": by, "ms_over_bound": ms / bms,
            "ms_warm_l2": time_ms(torch, kernel, cold=False),
            "ms_by_split_target": targets, "bytes": nbytes, "flops": flops}
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for i, (b, h, d, s, p, lens, off) in enumerate(DECODE_EDGES):
        n = ra.decode_split_plan(b, h, p, sms)
        pps = -(-p // n) * s
        lens = [{"pps": pps, "pps+1": pps + 1, "P*S": p * s,
                 "2pps-1": 2 * pps - 1}.get(x, x) for x in lens]
        for dtype, name in ((torch.float32, "float32"),
                            (torch.bfloat16, "bfloat16")):
            q4, kp, vp, table, _, _ = make_pool(torch, b, 1, h, d, s, p,
                                                b * p + 1, dtype, 30 + i)
            if off:
                kp, vp = misaligned(torch, kp), misaligned(torch, vp)
            args = (q4[:, 0].contiguous(), kp, vp, table,
                    torch.tensor(lens, dtype=torch.int32, device=DEV))
            label = f"decode edge {i} {name}"
            got, ref, _ = decode_call(torch, ra, args, label)
            f32 = dtype == torch.float32
            err, rel = check_close(got, ref, f32, label)
            worst[name] = max(worst[name], err if f32 else rel)
    out["edge_cases"] = len(DECODE_EDGES)
    out["edge_max_abs_err_f32"] = worst["float32"]
    out["edge_max_rel_err_bf16"] = worst["bfloat16"]
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase 6: the fused training attention against its plain version
# ---------------------------------------------------------------------------

def fused_work(B, H, Tq, Tk, D, itemsize, causal, lens):
    """(forward, backward) x (bytes, flops) of fused attention on these
    inputs, counting only what the function needs: a (query, key) pair
    only where the key is live (below the batch row's valid length in
    `lens`, all Tk when None) and, when causal, at or below the query's
    diagonal (key <= query + Tk - Tq); the K and V rows of live keys and
    the q and dO rows with at least one live pair read once, the bias
    read once, o forward and dq, dk, dv backward written whole; 4·D flops
    a pair forward and 10·D backward."""
    off = Tk - Tq
    pairs = live_q = live_kv = 0
    for b in range(B):
        n = Tk if lens is None else lens[b]
        seen = [min(max(i + off + 1, 0), n) if causal else n
                for i in range(Tq)]
        pairs += sum(seen)
        live_q += sum(1 for x in seen if x > 0)
        live_kv += max(seen, default=0)
    row = H * D * itemsize
    q_in, kv_in = live_q * row, live_kv * row
    q_out, kv_out = B * Tq * row, B * Tk * row
    pairs *= H
    bias = B * Tk * 4
    return ((q_in + 2 * kv_in + bias + q_out, 4 * D * pairs),
            (2 * q_in + 2 * kv_in + bias + q_out + 2 * kv_out,
             10 * D * pairs))


def fused_case(torch, F, fa, B, H, Tq, Tk, D, layout, causal, p, lens,
               dtype, seed, timed, pad=0):
    """Kernel against plain version on one set of inputs: forward output
    and the three gradients, the kernel family that ran (each launch
    counted under its key, the other family's keys untouched), and for
    bfloat16 whether two backward runs agree bit for bit; with `timed`,
    forward and backward times of the kernel, the plain version and
    F.scaled_dot_product_attention. `pad` > 0 lays q, k, v out as
    slices of rows D + pad elements apart."""
    rng = np.random.default_rng(seed)

    def shape(t, d=D):
        return (B, t, H, d) if layout == "BTHD" else (B, H, t, d)

    def leaf(t):
        x = torch.tensor(rng.standard_normal(shape(t, D + pad)), dtype=dtype,
                         device=DEV)[..., :D]
        return x.detach().requires_grad_(True)
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
    route = fa.kernel_route(q, k, v, layout)
    require(route == "cuda_core" or dtype == torch.bfloat16,
            f"{name}: float32 routed to {route}")

    def run(impl):
        return fa.fused_attention(q, k, v, mask=mask, causal=causal,
                                  dropout_p=p, seed=words, layout=layout,
                                  impl=impl)
    res = {}
    for impl in ("auto", "torch"):
        fa.reset_launches()
        o = run(impl)
        res[impl] = (o, torch.autograd.grad(o, (q, k, v), do))
        launches = dict(fa.LAUNCHES)
        want = dict.fromkeys(launches, 0)
        if impl == "auto":
            want.update(dict.fromkeys(FAMILY_KEYS[route], 1))
        require(launches == want, f"{name} impl={impl}: launches {launches}")
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
    out = {"route": route, "max_abs_err": err, "rel_err": rel, "tol": tol,
           "tol_kind": "absolute" if f32 else "relative",
           "grad_max_abs_err": gabs, "grad_rel_err": grel, "grad_tol": gtol}
    # the backward is deterministic: no atomics, a fixed sum order
    g2 = torch.autograd.grad(run("auto"), (q, k, v), do)
    out["bwd_bit_identical"] = all(bool(torch.equal(a, b))
                                   for a, b in zip(g, g2))
    require(out["bwd_bit_identical"], f"{name}: two backward runs differ")
    del g2
    if not timed:
        return out
    del res
    name_t = "float32" if dtype == torch.float32 else "bfloat16"
    (fb, ff), (bb, bf) = fused_work(B, H, Tq, Tk, D, q.element_size(),
                                    causal, lens)
    out["bound_ms"], out["bound_by"] = bound(fb, ff, name_t)
    out["bwd_bound_ms"], out["bwd_bound_by"] = bound(bb, bf, name_t)
    if name_t == "float32":
        # the same work with every product as three TF32 products
        out["bound_tf32x3_ms"] = max(fb / HBM_BYTES_PER_S,
                                     ff / TF32X3_FLOPS) * 1e3
        out["bwd_bound_tf32x3_ms"] = max(bb / HBM_BYTES_PER_S,
                                         bf / TF32X3_FLOPS) * 1e3
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
    out["ms_over_library"] = out["ms"] / out["library_ms"]
    out["bwd_ms_over_library"] = out["bwd_ms"] / out["library_bwd_ms"]
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
            r = fused_case(torch, F, fa, B, H, T, T, D, layout, causal, p,
                           None if causal else lens, dtype, seed=20 + i,
                           timed=True)
            require(r["route"] == ("cuda_core" if name == "float32"
                                   else "tensor_core"),
                    f"fused {label} {name}: routed to {r['route']}")
            out[label][name] = r
    # the CUDA-core kernels in bfloat16 at the BERT-base cell, untimed:
    # rows 68 elements apart are off the 16-byte grid, so the route rule
    # sends them there
    B, H, T, D, layout, causal, p = FUSED_CELLS["bert_bthd"]
    r = fused_case(torch, F, fa, B, H, T, T, D, layout, causal, p, lens,
                   torch.bfloat16, seed=20, timed=False, pad=4)
    require(r["route"] == "cuda_core", "padded rows took the tensor cores")
    out["bert_bthd"]["bfloat16_cuda_core"] = r
    # the CUDA-core kernels in bfloat16, timed, at the BERT-base cell with
    # D = 40 on rows 44 elements apart (off the 16-byte grid)
    r = fused_case(torch, F, fa, B, H, T, T, 40, layout, causal, p, lens,
                   torch.bfloat16, seed=21, timed=True, pad=4)
    require(r["route"] == "cuda_core", "padded rows took the tensor cores")
    out["bert_bthd_d40_unaligned"] = {"bfloat16": r}
    # (route, layout, causal) of every bfloat16 call held to the plain
    # version: each family must cover both layouts, causal and not
    covered = {(out[c]["bfloat16"]["route"], cell[4], cell[5])
               for c, cell in FUSED_CELLS.items()}
    covered.add(("cuda_core", layout, causal))
    worst = {"float32": 0.0, "bfloat16": 0.0}
    routes = []
    for i, args in enumerate(FUSED_EDGES):
        for dtype, name in ((torch.float32, "float32"),
                            (torch.bfloat16, "bfloat16")):
            r = fused_case(torch, F, fa, *args, dtype, seed=40 + i,
                           timed=False)
            worst[name] = max(worst[name], r["max_abs_err"] if name ==
                              "float32" else r["rel_err"],
                              max(r["grad_rel_err"]))
            if name == "bfloat16":
                routes.append(r["route"])
                covered.add((r["route"], args[5], args[6]))
    for family in FAMILY_KEYS:
        mine = sorted((lay, c) for f, lay, c in covered if f == family)
        require({lay for lay, _ in mine} == {"BTHD", "BHTD"}
                and {c for _, c in mine} == {False, True},
                f"bfloat16 calls on the {family} kernels cover only {mine}: "
                "both layouts, causal and not, are required")
        out[f"bf16_{family}_covers"] = mine
    out["edge_cases"] = len(FUSED_EDGES)
    out["edge_worst_err"] = worst
    out["edge_routes_bf16"] = routes
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase 5: GPT-2 774M served end to end
# ---------------------------------------------------------------------------

def serve(torch, eng, prompts, n_new, Request, reqs_out=None):
    """Serve greedy requests for `prompts`; their token streams and the
    wall seconds (ending in a device sync). The Request objects are
    appended to `reqs_out` when given."""
    reqs = [Request(p, n_new, request_id=i) for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if reqs_out is not None:
        reqs_out.extend(reqs)
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
    events = prof.key_averages()
    # kernel launches issued by the host in the window
    launches = sum(e.count for e in events
                   if e.key.startswith("cudaLaunchKernel"))
    rows = sorted(((e.self_device_time_total, e.key, e.count)
                   for e in events
                   if e.device_type == cuda and e.self_device_time_total),
                  reverse=True)
    if not rows:
        return {"wall_s": wall, "device_busy_share": "not measured",
                "cuda_launches": launches}
    dev_ms = sum(r[0] for r in rows) / 1e3
    classes = {}
    for d, k, _ in rows:
        label = kernel_class(k)
        classes[label] = classes.get(label, 0.0) + d / 1e3
    span = [(d, c) for d, k, c in rows if "ragged_span" in k]
    return {"wall_s": wall, "device_ms": dev_ms,
            "device_busy_share": dev_ms / (wall * 1e3),
            "span_device_ms": sum(d for d, _ in span) / 1e3,
            "span_launches": sum(c for _, c in span),
            "cuda_launches": launches,
            "device_ms_by_class": classes,
            "top_kernels": [{"name": k[:90], "ms": d / 1e3, "count": c}
                            for d, k, c in rows[:top]]}


def trace_serve(torch, eng, prompts, n_new, Request):
    """Serve once under the profiler."""
    return profiled(torch,
                    lambda: serve(torch, eng, prompts, n_new, Request)[1], 8)


def float_logits(torch, model, tokens, impl="torch"):
    """The float path's next-token logits after `tokens` (one slot, the
    whole prefix as one span), in float32: plain (impl "torch") or
    through the kernels ("auto")."""
    cache = model.make_cache(1, 1024, page_size=64, lengths=[0],
                             attn_impl=impl)
    with torch.no_grad():
        logits, _ = model(torch.tensor([tokens], device=DEV), cache)
    return logits[0, -1].float()


def gap2(logits):
    """The gap between the two largest logits."""
    top = logits.topk(2).values
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
    span_launches = ra.LAUNCHES[SPAN]
    require(span_launches == GPT2_LAYERS * dispatches,
            f"span launches {span_launches} != 36 x {dispatches} dispatches")
    require(ra.LAUNCHES[SPAN_TC] == 0, "float32 launched the tensor cores")
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
    out["page_bytes"] = {"float32": eng.page_pool.page_bytes}
    out["streams_float32"] = got
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
            gap = gap2(float_logits(torch, model, prompts[i] + b[:j]))
            divergences.append({"request": i, "token": j, "top2_gap": gap})
            require(gap < 1e-4, f"request {i} diverges at token {j} where "
                    f"the plain top-2 gap is {gap}")
    out["streams_identical"] = not divergences
    out["divergences"] = divergences

    # the kernel path in bfloat16 (the same weights, rounded), timed: the
    # main path of the tensor-core span kernel, counts read here
    model.to(torch.bfloat16)
    eng = ServingEngine(model, device=DEV, **ekw)
    serve(torch, eng, prompts, n_new, Request)          # warm-up
    eng.stats["decode_dispatches"] = 0
    ra.reset_launches()
    got16, wall = serve(torch, eng, prompts, n_new, Request)
    d16 = eng.stats["decode_dispatches"]
    launches16 = dict(ra.LAUNCHES)
    require(launches16[SPAN_TC] == GPT2_LAYERS * d16 and launches16[SPAN]
            == 0, f"bf16 span launches {launches16} for {d16} dispatches")
    out["launches_bf16"] = launches16
    out["page_bytes"]["bfloat16"] = eng.page_pool.page_bytes
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
    del eng
    torch.cuda.empty_cache()

    # bfloat16 kernel path against the bfloat16 plain path: with d the
    # largest |kernel - plain| first-token logit (each prompt as one
    # span), the first tokens must agree wherever the plain path's top-2
    # gap exceeds 2*d
    eng = ServingEngine(model, attn_impl="torch", device=DEV, **ekw)
    before = dict(ra.LAUNCHES)
    want16, _ = serve(torch, eng, prompts, n_new, Request)
    require(ra.LAUNCHES == before, "the bf16 plain path launched a kernel")
    del eng
    torch.cuda.empty_cache()
    first = []
    for i, p in enumerate(prompts):
        lk = float_logits(torch, model, p, "auto")
        lp = float_logits(torch, model, p)
        first.append({"request": i, "max_abs_logit_diff":
                      (lk - lp).abs().max().item(), "plain_top2_gap":
                      gap2(lp), "equal": got16[i][0] == want16[i][0]})
    d = max(r["max_abs_logit_diff"] for r in first)
    for r in first:
        if r["plain_top2_gap"] > 2 * d:
            require(r["equal"], f"bf16 first token of request "
                    f"{r['request']} differs from the plain path where its "
                    f"gap {r['plain_top2_gap']} exceeds 2 x {d}")
    out["bfloat16_vs_plain"] = {
        "max_abs_logit_diff": d, "first_tokens": first,
        "tokens_equal": sum(x == y for a, b in zip(got16, want16)
                            for x, y in zip(a, b)),
        "tokens": sum(map(len, want16)),
        "streams_equal": sum(a == b for a, b in zip(got16, want16))}
    del model
    torch.cuda.empty_cache()
    emit(out)
    return out


def gpt2_774m(torch):
    """GPT-2 774M at full width with seeded random weights, float32."""
    from mxnet_tpu_torch.models import (GPT2ForCausalLM, gpt2_774m_config,
                                        init_params)
    cfg = gpt2_774m_config(dropout=0.0, attention_dropout=0.0)
    require(cfg.num_layers == GPT2_LAYERS, "774M config changed")
    model = GPT2ForCausalLM(cfg, device=DEV)
    init_params(model, seed=0, std=0.02)
    return model, cfg


def int8_logits(torch, model, prompt, emitted, history):
    """The plain int8 path's next-token logits after `prompt + emitted`,
    on one slot replaying the engine's write schedule: the prompt in its
    recorded chunks (`history`, Request.kv_history), then each emitted
    token as a one-row write (int8 numerics depend on the chunking)."""
    cache = model.make_cache(1, 1024, page_size=64, lengths=[0],
                             attn_impl="torch", kv_dtype="int8")
    cuts = np.cumsum([0] + list(history))
    feeds = [prompt[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
    feeds += [[t] for t in emitted]
    with torch.no_grad():
        for toks in feeds:
            logits, cache = model(torch.tensor([toks], device=DEV), cache)
    return logits[0, -1].float()


def quantizer_bytes_match(torch):
    """The cache quantizer on the card writes the CPU's bytes: the same
    random write schedule (chunks of 1, 3 and 5 rows over pages of 4,
    dead span rows, locked pages, writes past capacity, growing
    magnitudes) into an int8 PagedKVCache on each device; codes and
    scales compared byte for byte (the CPU side is held to the JAX
    reference by tests/test_torch_quant_kv.py)."""
    from mxnet_tpu_torch.models import PagedKVCache
    rng = np.random.default_rng(7)
    L, B, H, D, S, P = 2, 4, 20, 64, 4, 3
    N = B * P + 2
    table = rng.permutation(N)[:B * P].reshape(B, P).astype(np.int32)
    caches = {dev: PagedKVCache.create(L, B, H, P * S, D, page_size=S,
                                       num_pages=N, page_table=table,
                                       lengths=np.zeros(B), kv_dtype="int8",
                                       device=dev) for dev in ("cpu", DEV)}
    for step in range(12):
        t = (1, 3, 5)[step % 3]
        lengths = rng.integers(0, P * S + 3, B).astype(np.int32)
        spans = rng.integers(0, t + 1, B).astype(np.int32)
        lock = rng.random(N) < 0.25
        k = ((1.0 + step) * rng.standard_normal((B, H, t, D))).astype(
            np.float32)
        v = ((1.0 + step) * rng.standard_normal((B, H, t, D))).astype(
            np.float32)
        for dev, c in caches.items():
            w = PagedKVCache(c.k_pages, c.v_pages, c.page_table,
                             torch.tensor(lengths, device=dev),
                             page_lock=torch.tensor(lock, device=dev),
                             spans=torch.tensor(spans, device=dev),
                             k_scale=c.k_scale, v_scale=c.v_scale)
            w.write_decode(step % L, torch.tensor(k, device=dev),
                           torch.tensor(v, device=dev))
    a, b = caches["cpu"], caches[DEV]
    return all(bool(torch.equal(x[:, :N], y[:, :N].cpu()))
               for x, y in ((a.k_pages, b.k_pages), (a.v_pages, b.v_pages),
                            (a.k_scale, b.k_scale), (a.v_scale, b.v_scale)))


def phase_gpt2_int8(torch, ra, card, gpt2):
    """Phase 5b: the 774M serve on int8 KV pages."""
    from mxnet_tpu_torch.models import PagedKVCache
    from mxnet_tpu_torch.serving import Request, ServingEngine

    model, cfg = gpt2_774m(torch)
    rng = np.random.default_rng(0)
    plens = rng.integers(16, 129, 8)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in plens]
    require([int(n) for n in plens] == gpt2["prompt_lens"],
            "phase gpt2 and gpt2_int8 traffic differ")
    n_new = 32
    out = {"phase": "gpt2_int8", "card": card, "config": "gpt2_774m_config",
           "kv_dtype": "int8", "prompt_lens": gpt2["prompt_lens"],
           "new_tokens": n_new}
    ekw = dict(num_slots=8, max_length=1024, page_size=64, chunk_tokens=64,
               kv_dtype="int8")

    # the int8 main path: float32 through the kernels; counts read here
    eng = ServingEngine(model, device=DEV, **ekw)
    ra.reset_launches()
    got, wall = serve(torch, eng, prompts, n_new, Request)
    launches = dict(ra.LAUNCHES)
    dispatches = eng.stats["decode_dispatches"]
    require(launches[INT8] == GPT2_LAYERS * dispatches,
            f"int8 span launches {launches[INT8]} != 36 x {dispatches}")
    require(launches[SPAN] == 0 and launches[SPAN_TC] == 0
            and launches[INT8_TC] == 0
            and launches["ragged_decode_attention"] == 0,
            f"other ragged kernels ran on float32 int8 pages: {launches}")
    require(all(len(t) == n_new for t in got), "short int8 streams")
    require(eng.audit_pages() == [], "int8 page audit failed")
    # one ragged single-token forward on the served int8 cache: every
    # t == 1 call takes the span kernel. Each path starts from the same
    # pools and scales (a forward writes, and scales never go down)
    lengths = torch.tensor([int(n) + n_new - 1 for n in plens],
                           dtype=torch.int32, device=DEV)
    last = torch.tensor([[s[-1]] for s in got], device=DEV)
    saved = [x.clone() for x in (eng._kp, eng._vp, eng._ks, eng._vs)]
    logits = {}
    for impl in ("auto", "torch"):
        for x, y in zip((eng._kp, eng._vp, eng._ks, eng._vs), saved):
            x.copy_(y)
        cache = PagedKVCache(eng._kp, eng._vp, eng._dstate["table"],
                             lengths, k_scale=eng._ks, v_scale=eng._vs,
                             attn_impl=impl)
        with torch.no_grad():
            logits[impl] = model(last, cache)[0].float()
        if impl == "auto":
            require(ra.LAUNCHES[INT8] - launches[INT8] == GPT2_LAYERS,
                    "the single-token int8 forward missed the span kernel")
    del saved, cache
    dlog = (logits["auto"] - logits["torch"]).abs().max().item()
    require(dlog <= 1e-4, f"int8 single-token logits differ by {dlog}")
    require(bool(torch.isfinite(logits["auto"]).all()), "non-finite logits")
    out["float32_kernel"] = {"card": card, "wall_s": wall,
                             "dispatches": dispatches,
                             "ms_per_dispatch": wall / dispatches * 1e3}
    out["launches"] = launches
    out["single_token_logits_max_abs_diff"] = dlog
    out["page_bytes"] = dict(gpt2["page_bytes"],
                             int8=eng.page_pool.page_bytes)
    out["kv_bytes_per_token"] = {k: v / 64
                                 for k, v in out["page_bytes"].items()}
    del eng, logits
    torch.cuda.empty_cache()

    # the same traffic through the plain versions
    eng = ServingEngine(model, attn_impl="torch", device=DEV, **ekw)
    plain_reqs = []
    want, wall = serve(torch, eng, prompts, n_new, Request, plain_reqs)
    out["float32_plain"] = {"wall_s": wall, "ms_per_dispatch": wall
                            / eng.stats["decode_dispatches"] * 1e3}
    require(ra.LAUNCHES[INT8] == launches[INT8] + GPT2_LAYERS,
            "the plain path launched a kernel")
    del eng
    torch.cuda.empty_cache()
    divergences = []
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            j = next(k for k in range(n_new) if a[k] != b[k])
            gap = gap2(int8_logits(torch, model, prompts[i], b[:j],
                                   plain_reqs[i].kv_history))
            divergences.append({"request": i, "token": j, "top2_gap": gap})
            require(gap < 1e-4, f"int8 request {i} diverges at token {j} "
                    f"where the plain top-2 gap is {gap}")
    out["streams_identical"] = not divergences
    out["divergences"] = divergences

    # int8 against phase gpt2's float32 streams, first tokens. With d the
    # largest |int8 - float32| logit of the prompt (plain paths, the
    # engine's write schedule), a float32 top-2 gap above 2*d leaves no
    # room for a flip: there the tokens must agree. Wherever the int8
    # path's own gap exceeds 1e-2 the engine's token must be its argmax.
    # (The reference's tiny-model rule, agreement wherever float32's gap
    # exceeds 1e-2, assumes d < 5e-3; at 774M d is measured instead.)
    f32 = gpt2["streams_float32"]
    first = []
    for i, p in enumerate(prompts):
        lf = float_logits(torch, model, p)
        l8 = int8_logits(torch, model, p, [], plain_reqs[i].kv_history)
        gap, gap8 = gap2(lf), gap2(l8)
        d = (l8 - lf).abs().max().item()
        row = {"request": i, "float32_top2_gap": gap, "int8_top2_gap": gap8,
               "max_abs_logit_diff": d, "max_abs_logit": lf.abs().max().item(),
               "equal": got[i][0] == f32[i][0],
               "int8_argmax_equal": int(l8.argmax()) == got[i][0]}
        first.append(row)
        if gap > 2 * d:
            require(row["equal"], f"int8 first token of request {i} differs "
                    f"from float32 where its gap {gap} exceeds 2 x {d}")
        if gap8 > 1e-2:
            require(row["int8_argmax_equal"], f"int8 first token of request "
                    f"{i} is not the int8 path's argmax (gap {gap8})")
    # the cache quantizer on the card against the CPU's bytes
    require(quantizer_bytes_match(torch),
            "the int8 cache quantizer writes other bytes on the card")
    out["vs_float32"] = {
        "tokens_equal": sum(x == y for a, b in zip(got, f32)
                            for x, y in zip(a, b)),
        "tokens": sum(map(len, f32)),
        "streams_equal": sum(a == b for a, b in zip(got, f32)),
        "first_tokens": first}

    # bfloat16 weights on int8 pages, timed and profiled: the main path
    # of the int8 tensor-core span kernel, counts read here
    model.to(torch.bfloat16)
    eng = ServingEngine(model, device=DEV, **ekw)
    serve(torch, eng, prompts, n_new, Request)          # warm-up
    eng.stats["decode_dispatches"] = 0
    ra.reset_launches()
    got16, wall = serve(torch, eng, prompts, n_new, Request)
    d16 = eng.stats["decode_dispatches"]
    launches16 = dict(ra.LAUNCHES)
    require(launches16[INT8_TC] == GPT2_LAYERS * d16 and launches16[INT8]
            == 0, f"bf16 int8 span launches {launches16} for {d16}")
    out["launches_bf16"] = launches16
    require(all(len(t) == n_new for t in got16), "short bf16 int8 streams")
    out["bfloat16_kernel"] = {
        "card": card, "wall_s": wall, "dispatches": d16,
        "tokens_per_s": sum(map(len, got16)) / wall,
        "ms_per_dispatch": wall / d16 * 1e3,
        "greedy_tokens_equal_to_float32_int8":
            sum(x == y for a, b in zip(got16, got) for x, y in zip(a, b))}
    out["bfloat16_kernel_trace"] = trace_serve(torch, eng, prompts, n_new,
                                               Request)
    del eng, model
    torch.cuda.empty_cache()
    emit(out)
    return out


def phase_prefix(torch, ra, card):
    """Phase 5c: shared-prefix traffic with the prefix cache off and on,
    float32 and int8 pages, the kernel path."""
    from mxnet_tpu_torch.serving import Request, ServingEngine

    model, cfg = gpt2_774m(torch)
    rng = np.random.default_rng(1)
    S, n_pre, n_new = 64, 256, 32
    prefix = rng.integers(0, cfg.vocab_size, n_pre).tolist()
    tails = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
             for n in rng.integers(16, 129, 8)]
    prompts = [prefix + t for t in tails]
    # a non-binding prefill budget keeps each prompt on the chunk_tokens
    # grid whoever shares the dispatch: int8 numerics depend on where
    # chunks end, and a page-aligned prefix hit starts on that grid
    ekw = dict(num_slots=8, max_length=1024, page_size=S, chunk_tokens=S,
               prefill_chunk_budget=8 * S)
    out = {"phase": "prefix", "card": card, "config": "gpt2_774m_config",
           "prefix_tokens": n_pre, "tail_lens": [len(t) for t in tails],
           "new_tokens": n_new}
    f32_pool_bytes = None
    for kv in ("float32", "int8"):
        runs = {}
        for on in (False, True):
            kw = dict(ekw, kv_dtype="int8" if kv == "int8" else None,
                      prefix_cache=on)
            if kv == "int8" and on:
                # the float32 cache-on pool's bytes as the int8 budget
                kw["hbm_budget_bytes"] = f32_pool_bytes
            eng = ServingEngine(model, device=DEV, **kw)
            if kv == "float32" and on:
                f32_pool_bytes = eng.page_pool.num_pages \
                    * eng.page_pool.page_bytes
            ra.reset_launches()
            walls, streams = [], []
            for group in ([prompts[0]], prompts[1:]):
                toks, wall = serve(torch, eng, group, n_new, Request)
                streams += toks
                walls.append(wall)
            tree = before = None
            if on:
                pc = eng.prefix_cache
                tree = sorted(pc._by_page)
                leaves = [eng._kp, eng._vp] + (
                    [eng._ks, eng._vs] if kv == "int8" else [])
                before = [x[:, tree].clone() for x in leaves]
            toks, wall = serve(torch, eng, [prefix], n_new, Request)
            streams += toks
            walls.append(wall)
            if on:
                same = all(bool(torch.equal(b, x[:, tree]))
                           for b, x in zip(before, leaves))
                require(same, f"prefix {kv}: the CoW request wrote into "
                        "the tree's pages")
                del before
            audit = eng.audit_pages()
            require(audit == [], f"prefix {kv} on={on}: audit {audit}")
            key = INT8 if kv == "int8" else SPAN
            require(ra.LAUNCHES[key] == GPT2_LAYERS
                    * eng.stats["decode_dispatches"]
                    and ra.LAUNCHES[SPAN_TC] == ra.LAUNCHES[INT8_TC] == 0,
                    f"prefix {kv}: the span kernel missed dispatches")
            st = eng.stats
            runs[on] = {"streams": streams, "wall_s": walls,
                        "ms_per_serve": [w * 1e3 for w in walls],
                        "dispatches": st["decode_dispatches"],
                        "prefill_tokens": st["prefill_tokens"],
                        "prefix_hits": st["prefix_hits"],
                        "prefix_misses": st["prefix_misses"],
                        "prefix_tokens_saved": st["prefix_tokens_saved"],
                        "pool_pages": eng.page_pool.num_pages,
                        "page_bytes": eng.page_pool.page_bytes,
                        "hbm_budget_bytes": kw.get("hbm_budget_bytes")}
            del eng
            torch.cuda.empty_cache()
        off, on = runs[False], runs[True]
        require(on["streams"] == off["streams"],
                f"prefix {kv}: streams differ with the cache on and off")
        saved = 7 * n_pre + (n_pre - 1)
        require(on["prefix_tokens_saved"] == saved,
                f"prefix {kv}: saved {on['prefix_tokens_saved']} != {saved}")
        require(on["prefill_tokens"] + on["prefix_tokens_saved"]
                == off["prefill_tokens"], f"prefix {kv}: prefill identity")
        for r in (off, on):
            del r["streams"]
        out[kv] = {"off": off, "on": on, "streams_identical": True}
    del model
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
        """One forward and backward of the training loss (from float32
        logits) in train() mode, dropout drawn from a fixed generator: the
        loss and every parameter's gradient (then cleared)."""
        model.train()
        with rng.generator_scope(rng.step_generator(0, 1, DEV)):
            loss = SoftmaxCrossEntropyLoss()(model(*batch[:4]).float(),
                                             batch[4]).mean()
            loss.backward()
        g = {n: p.grad for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return float(loss.detach()), g

    def layer_top(g):
        """The largest gradient magnitude of each layer (a Dense's weight
        and bias together): the attention key biases' true gradient is 0
        (a key bias shifts every score of a query alike), so on their own
        both paths hold only noise."""
        top = {}
        for n, x in g.items():
            owner = n.rsplit(".", 1)[0]
            top[owner] = max(top.get(owner, 0.0), x.abs().max().item())
        return top

    def grad_rel(g_a, g_b, top):
        """Each parameter's largest |g_a - g_b| over its layer's `top`."""
        return {n: (g_a[n].float() - g.float()).abs().max().item()
                / (top[n.rsplit(".", 1)[0]] or 1.0) for n, g in g_b.items()}

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
    _, g_kernel = grads(model)
    fa.reset_launches()
    t0 = time.perf_counter()
    _, losses = train(model, steps)
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    want = {k: (BERT_LAYERS * steps if k in FAMILY_KEYS["cuda_core"] else 0)
            for k in launches}
    require(launches == want, f"float32 steps launched {launches}, not "
            f"{BERT_LAYERS} x {steps} of the CUDA-core pair alone")
    out["launches"] = launches
    out["float32_kernel"] = {"losses": losses, "wall_s": wall,
                             "ms_per_step": wall / steps * 1e3}
    del model
    torch.cuda.empty_cache()

    # the same steps through the plain versions, from the same weights
    model, _ = make(attention_impl="torch")
    _, g32 = grads(model)          # kept for the bfloat16 check below
    top32 = layer_top(g32)
    rel = grad_rel(g_kernel, g32, top32)
    del g_kernel
    worst = max(rel, key=rel.get)
    require(rel[worst] <= 1e-4, f"float32 gradient of {worst} differs by "
            f"{rel[worst]} of its layer's largest gradient")
    out["float32_grad_rel_err"] = {"worst": rel[worst], "worst_param": worst,
                                   "params": len(rel), "tol": 1e-4}
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
    fa.reset_launches()
    loss16, g16_kernel = grads(model)
    once = dict(fa.LAUNCHES)
    want = {k: (BERT_LAYERS if k in FAMILY_KEYS["tensor_core"] else 0)
            for k in once}
    require(once == want, f"a bfloat16 forward and backward launched "
            f"{once}, not {BERT_LAYERS} of the tensor-core pair alone")
    torch.cuda.reset_peak_memory_stats()
    step, _ = train(model, 1)                       # warm-up
    n = 20
    fa.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bl = [step(*batch) for _ in range(n)]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n
    bl = [float(x) for x in bl]
    launches16 = dict(fa.LAUNCHES)
    want = {k: (BERT_LAYERS * n if k in FAMILY_KEYS["tensor_core"] else 0)
            for k in launches16}
    require(launches16 == want, f"bfloat16 steps launched {launches16}, "
            f"not {BERT_LAYERS} x {n} of the tensor-core pair alone")
    out["launches_bf16"] = launches16
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
    trace = trace_step(torch, step, batch)
    by_class = trace.get("device_ms_by_class", {})
    if by_class:
        trace["fused_attention_share"] = \
            by_class.get("fused_attention", 0.0) / trace["device_ms"]
    out["bfloat16_kernel_trace"] = trace
    del step, model
    torch.cuda.empty_cache()

    # one bfloat16 forward and backward of the model on the plain path,
    # from the same weights and dropout stream: the kernels' calls inside
    # the model (their strides, dtypes and seeds) against the plain ones
    model, _ = make(attention_impl="torch")
    model.to(torch.bfloat16)
    fa.reset_launches()
    plain16, g16_plain = grads(model)
    require(not any(fa.LAUNCHES.values()), "the plain path launched a kernel")
    del model
    diff = grad_rel(g16_kernel, g16_plain, top32)
    own = grad_rel(g16_plain, g32, top32)      # the plain path's bf16 error
    del g16_kernel, g16_plain, g32
    torch.cuda.empty_cache()
    limit = {n: max(BF16_MODEL_GRAD_TOL, own[n]) for n in diff}
    worst = max(diff, key=lambda n: diff[n] / limit[n])
    loss_rel = abs(loss16 - plain16) / abs(plain16)
    out["bfloat16_grad_rel_err"] = {
        "worst": diff[worst], "worst_param": worst,
        "worst_limit": limit[worst], "largest": max(diff.values()),
        "largest_param": max(diff, key=diff.get),
        "over_tol_by_own_error": sorted(n for n in diff
                                        if own[n] > BF16_MODEL_GRAD_TOL),
        "plain_own_error_largest": max(own.values()), "params": len(diff),
        "tol": BF16_MODEL_GRAD_TOL, "loss_kernel": loss16,
        "loss_plain": plain16, "loss_rel_diff": loss_rel,
        "loss_tol": BF16_MODEL_LOSS_TOL}
    require(diff[worst] <= limit[worst], f"bfloat16 gradient of {worst} "
            f"differs by {diff[worst]} of its layer's largest float32 "
            f"gradient, over {limit[worst]}")
    require(loss_rel <= BF16_MODEL_LOSS_TOL, f"bfloat16 losses {loss16} and "
            f"{plain16} differ by {loss_rel} relative")
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase 7b: GPT-2 774M's training forward (cache=None) and backward
# ---------------------------------------------------------------------------

def phase_gpt2_train(torch, fa, card):
    """One forward and backward of GPT-2 774M's causal LM loss at full
    width on the cache=None path, B = 2, T = 1024, dropout and attention
    dropout 0.1 (train() mode), float32 and bfloat16: the kernel path
    (attention_impl "auto") against the plain path ("torch") from the
    same weights and the same dropout generator. Each kernel pass must
    launch its family's fused forward and backward once a layer and
    nothing else; then the kernel path's forward and backward timed, and
    once more under the profiler."""
    from mxnet_tpu_torch import rng
    from mxnet_tpu_torch.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models import (GPT2ForCausalLM, gpt2_774m_config,
                                        init_params)
    B, T = GPT2_TRAIN["B"], GPT2_TRAIN["T"]
    out = {"phase": "gpt2_train", "card": card, "config": "gpt2_774m_config",
           "batch": B, "seq_len": T, "dropout": 0.1}

    def make(dtype, impl):
        cfg = gpt2_774m_config(dropout=0.1, attention_dropout=0.1,
                               attention_impl=impl, dtype=dtype)
        require(cfg.num_layers == GPT2_LAYERS, "774M config changed")
        model = init_params(GPT2ForCausalLM(cfg, device=DEV), seed=0,
                            std=0.02)
        model.train()
        return model, cfg

    def fwd_bwd(model, ids):
        """The next-token loss (float32 logits) and its backward, dropout
        drawn from a fixed generator; wall ms, ending in a device sync."""
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with rng.generator_scope(rng.step_generator(0, 1, DEV)):
            logits = model(ids)
            loss = SoftmaxCrossEntropyLoss()(logits[:, :-1].float(),
                                             ids[:, 1:]).mean()
            loss.backward()
        torch.cuda.synchronize()
        return float(loss.detach()), (time.perf_counter() - t0) * 1e3

    ids = None
    for dtype, family, tol in (("float32", "cuda_core", 1e-5),
                               ("bfloat16", "tensor_core",
                                BF16_MODEL_LOSS_TOL)):
        res = {}
        for impl in ("auto", "torch"):
            model, cfg = make(dtype, impl)
            if ids is None:
                ids = torch.tensor(np.random.default_rng(0).integers(
                    0, cfg.vocab_size, (B, T)), dtype=torch.int64,
                    device=DEV)
            fa.reset_launches()
            loss, ms = fwd_bwd(model, ids)
            launches = dict(fa.LAUNCHES)
            want = {k: (GPT2_LAYERS if impl == "auto"
                        and k in FAMILY_KEYS[family] else 0)
                    for k in launches}
            require(launches == want, f"gpt2_train {dtype} impl={impl}: "
                    f"launches {launches}, not {want}")
            grads_ok = all(p.grad is not None
                           and bool(torch.isfinite(p.grad).all())
                           for p in model.parameters())
            require(np.isfinite(loss) and grads_ok,
                    f"gpt2_train {dtype} impl={impl}: non-finite loss "
                    f"{loss} or gradients")
            r = {"loss": loss, "first_ms": ms, "launches": launches}
            if impl == "auto":
                r["ms"] = [fwd_bwd(model, ids)[1] for _ in range(3)]
                r["median_ms"] = float(np.median(r["ms"]))
                r["trace"] = profiled(
                    torch, lambda: fwd_bwd(model, ids)[1] / 1e3, 10)
            res[impl] = r
            del model
            torch.cuda.empty_cache()
        rel = abs(res["auto"]["loss"] - res["torch"]["loss"]) \
            / abs(res["torch"]["loss"])
        require(rel <= tol, f"gpt2_train {dtype}: losses "
                f"{res['auto']['loss']} and {res['torch']['loss']} differ "
                f"by {rel} relative, over {tol}")
        out[dtype] = {"kernel": res["auto"], "plain": res["torch"],
                      "loss_rel_diff": rel, "loss_tol": tol}
    emit(out)
    return out


def kernel_entry(name, source, launches, f32, b16, card, **extra):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": f32["max_abs_err"],
            "max_abs_err_bf16": b16["max_abs_err"],
            "rel_err_bf16": b16.get("rel_err"),
            "ms": f32["ms"], "kernel_ms": f32["ms"],
            "plain_ms": f32["plain_ms"],
            "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"],
            "library_ms": f32["library_ms"],
            "ms_bf16": b16.get("ms"), "plain_ms_bf16": b16.get("plain_ms"),
            "bound_ms_bf16": b16.get("bound_ms"),
            "library_ms_bf16": b16.get("library_ms"), "card": card, **extra}


def span_entries(span, span8, gpt2, gpt2_int8, card):
    """The four span kernels' kernels-line entries: the CUDA-core kernel
    at float32 q (launches from the float32 serves, phases 5 and 5b) and
    the tensor-core kernel at bfloat16 q (launches from the bfloat16
    serves), float and int8 pages, each at the kernel cell with the
    serve's decode cell beside."""
    def entry(name, source, res, dtype, launches):
        cell, dec = res[dtype], res["serve_decode"][dtype]
        require(cell["route"] == dec["route"] == (
            "tensor_core" if name.endswith("_tc") else "cuda_core"),
            f"{name}: the cells ran on another route")
        keys = ("ms", "plain_ms", "library_ms", "ms_over_library",
                "bound_ms", "bound_by", "max_abs_err", "rel_err")
        return {"name": name, "route": "cuda", "family": cell["route"],
                "source": source, "replaces": REPLACES[name],
                "launches": launches, "dtype": dtype,
                "max_abs_err": cell["max_abs_err"],
                "rel_err": cell["rel_err"], "ms": cell["ms"],
                "kernel_ms": cell["ms"], "plain_ms": cell["plain_ms"],
                "bound_ms": cell["bound_ms"], "bound_by": cell["bound_by"],
                "library_ms": cell["library_ms"],
                "ms_over_library": cell["ms_over_library"],
                "serve_decode": {k: dec[k] for k in keys}, "card": card}
    return [entry(SPAN, SOURCE, span, "float32", gpt2["launches"][SPAN]),
            entry(SPAN_TC, SPAN_TC_SOURCE, span, "bfloat16",
                  gpt2["launches_bf16"][SPAN_TC]),
            entry(INT8, SOURCE, span8, "float32",
                  gpt2_int8["launches"][INT8]),
            entry(INT8_TC, SPAN_TC_SOURCE, span8, "bfloat16",
                  gpt2_int8["launches_bf16"][INT8_TC])]


def fused_entries(fused, launches, launches16, gpt2_train, card):
    """The fused kernels' four kernels-line entries at the BERT-base BTHD
    cell (the main path's shape), the BHTD and GPT-2 cells beside: the
    CUDA-core pair (float32, with the split-TF32 bound beside; bfloat16
    times at the unaligned D = 40 cell; launches from phase 7's float32
    kernel steps) and the tensor-core pair (bfloat16; launches from phase
    7's bfloat16 steps); each with its launches in phase 7b's GPT-2
    774M training pass of its dtype."""
    main = fused["bert_bthd"]
    f32, b16 = main["float32"], main["bfloat16"]
    cells = ("bert_bhtd", "gpt2_774m_causal")

    def bwd_view(r):
        return {"max_abs_err": max(r["grad_max_abs_err"]),
                "rel_err": max(r["grad_rel_err"]),
                "ms": r.get("bwd_ms"), "plain_ms": r.get("plain_bwd_ms"),
                "bound_ms": r.get("bwd_bound_ms"),
                "bound_by": r.get("bwd_bound_by"),
                "bound_tf32x3_ms": r.get("bwd_bound_tf32x3_ms"),
                "library_ms": r.get("library_bwd_ms")}

    def other(dtype, key, lib_key, bound_key):
        return {c: {"ms": fused[c][dtype][key],
                    "library_ms": fused[c][dtype][lib_key],
                    "bound_ms": fused[c][dtype][bound_key],
                    "bound_tf32x3_ms": fused[c][dtype].get(
                        bound_key.replace("bound", "bound_tf32x3"))}
                for c in cells}

    def train(dtype, key):
        return gpt2_train[dtype]["kernel"]["launches"][key]

    def tc_entry(name, r, n, cells_):
        return {"name": name, "route": "cuda", "source": FUSED_TC_SOURCE,
                "replaces": REPLACES[name], "launches": n,
                "dtype": "bfloat16", "max_abs_err": r["max_abs_err"],
                "rel_err": r["rel_err"], "ms": r["ms"], "kernel_ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                "ms_over_library": r["ms"] / r["library_ms"],
                "card": card, "other_cells": cells_}
    # the CUDA-core pair in bfloat16: timed at the unaligned D = 40 cell,
    # its errors at the BERT-base cell on padded rows beside
    cc16 = main["bfloat16_cuda_core"]
    d40 = fused["bert_bthd_d40_unaligned"]["bfloat16"]
    cell16 = "bert_bthd at D = 40, rows 44 elements apart"
    return [
        kernel_entry("fused_attention_fwd", FUSED_SOURCE,
                     launches["fused_attention_fwd"], f32, d40, card,
                     bound_tf32x3_ms=f32["bound_tf32x3_ms"],
                     bf16_cell=cell16, bert_cell_rel_err_bf16=cc16["rel_err"],
                     gpt2_train_launches=train("float32",
                                               "fused_attention_fwd"),
                     other_cells=other("float32", "ms", "library_ms",
                                       "bound_ms")),
        kernel_entry("fused_attention_bwd", FUSED_SOURCE,
                     launches["fused_attention_bwd"], bwd_view(f32),
                     bwd_view(d40), card,
                     bound_tf32x3_ms=f32["bwd_bound_tf32x3_ms"],
                     grad_rel_err=max(f32["grad_rel_err"]),
                     grad_rel_err_bf16=max(d40["grad_rel_err"]),
                     bf16_cell=cell16,
                     bert_cell_grad_rel_err_bf16=max(cc16["grad_rel_err"]),
                     gpt2_train_launches=train("float32",
                                               "fused_attention_bwd"),
                     other_cells=other("float32", "bwd_ms",
                                       "library_bwd_ms", "bwd_bound_ms")),
        dict(tc_entry("fused_attention_fwd_tc", b16,
                      launches16["fused_attention_fwd_tc"],
                      other("bfloat16", "ms", "library_ms", "bound_ms")),
             gpt2_train_launches=train("bfloat16",
                                       "fused_attention_fwd_tc")),
        dict(tc_entry("fused_attention_bwd_tc", bwd_view(b16),
                      launches16["fused_attention_bwd_tc"],
                      other("bfloat16", "bwd_ms", "library_bwd_ms",
                            "bwd_bound_ms")),
             gpt2_train_launches=train("bfloat16",
                                       "fused_attention_bwd_tc"))]


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
    span8 = phase_span(torch, F, ra, quant=True)
    decode = phase_decode(torch, F, ra)
    gpt2 = phase_gpt2(torch, ra, card)
    gpt2_int8 = phase_gpt2_int8(torch, ra, card, gpt2)
    phase_prefix(torch, ra, card)
    fused = phase_fused(torch, F, fa)
    bert = phase_bert(torch, fa, card)
    gpt2_train = phase_gpt2_train(torch, fa, card)

    kernels = span_entries(span, span8, gpt2, gpt2_int8, card)
    kernels.append(kernel_entry(
        "ragged_decode_attention", SOURCE,
        gpt2["launches"]["ragged_decode_attention"], decode["float32"],
        decode["bfloat16"], card, splits=decode["splits"],
        span_sq1_ms=decode["float32"]["span_sq1_ms"],
        span_sq1_ms_bf16=decode["bfloat16"]["span_sq1_ms"]))
    kernels += fused_entries(fused, bert["launches"], bert["launches_bf16"],
                             gpt2_train, card)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
