"""Kernel times and errors of this checkout against another one, on one
card.

    python3 -m mxnet_tpu_torch.tools.compare_kernels OTHER_ROOT [PART ...]

OTHER_ROOT is the root of another checkout of the port (for example the
parent commit unpacked with `git archive`). Each run is a fresh process
that imports `mxnet_tpu_torch` from one root, builds its kernels and
measures, through the public entry points, on chip_smoke.py's inputs
(its helpers `make_pool`, `time_ms`: CUDA events, a 64 MB L2 flush
before each of 25 launches, the median):

  * span: the span kernels over float pages (float32 q on the CUDA
    cores, bfloat16 q on the tensor cores) at chip_smoke's kernel cell
    and the serve's decode cell: ms and the error against the plain
    version (float32 absolute, bfloat16 over the largest plain value);
  * nan_page: the smallest input of a poisoned key page (one slot, one
    head, D = 64, page 16, one key, NaN, one query row; float32 and
    bfloat16, span and decode kernels): how many output elements are
    NaN through the kernel and through the plain version;
  * int8_tc: the int8 span kernel on the tensor cores (bfloat16 q) at
    chip_smoke's kernel cell and the serve's decode cell: ms, and its
    largest error against the plain version over the largest plain
    value;
  * int8_search: the smallest input (fewest keys; one slot, one head,
    D = 64, page 16, one query row, seeds 0-31 each) on which that error
    exceeds INT8_TOL, the tolerance chip_smoke now holds it to, with the
    error of this root's kernel on the same input;
  * decode: ragged_decode_attention at chip_smoke's decode cell, float32
    and bfloat16: ms and the error against the plain version;
  * fused_bwd: the float32 fused backward at the BERT-base cell (BTHD,
    B=32, T=512, H=12, D=64, key padding, dropout 0.1): ms and the
    largest gradient error over the largest plain gradient;
  * fused_fwd: the fused forward on the CUDA-core route
    (csrc/fused_attention.cu) at chip_smoke's four cells of that kernel:
    float32 BERT-base BTHD and BHTD (key padding, dropout 0.1), float32
    GPT-2 774M causal (B=8, T=1024, H=20, D=64, dropout 0.1), bfloat16
    BERT-base BTHD at D = 40 on rows 44 elements apart: ms, and the
    largest error against the plain version (float32 absolute, bfloat16
    over the largest plain value);
  * nms: ops.detection.nms_keep on SSD.detect's arguments at phase
    ssd512's B = 32, 512x512 (SSD_BENCH, SSD_DETECT: nms 0.45,
    threshold 0.01, topk 400) from a bfloat16 ssd_512_resnet50_v1_voc
    (Xavier, seed 0) on seeded images (the first run saves them under
    build/, every later run times those same tensors), and on every
    NMS_EDGES case: whether the keep mask equals the plain version's,
    the launches counted, ms, and the bound (nms_work); detect's peak
    device memory (the net's weights included). In this checkout's run
    also the kernel built with clusters of NMS_CLUSTERS blocks (each
    case checked and timed) and built with -DNMS_PROBE on
    NMS_PROBE_CASES: each phase's clock64 cycles in the images' leader
    blocks (median, largest) and the images that took the global path.
    The inputs and helpers come from this checkout's chip_smoke.py on
    both sides.

PARTs (default: all) pick which of span, nan_page, int8_tc,
int8_search, decode, fused_bwd, fused_fwd and nms run. The runs take
turns, other, this, this, other. Prints one JSON line per run, then the
medians of each side and the card's name and power limit; with
`--out DIR` all of it also goes to DIR/compare_kernels.json.
"""
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

THIS_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
INT8_TOL = 2e-3
SEARCH_KEYS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256)
SEARCH_SEEDS = 32
# chip_smoke.py's span cells (lengths, q_counts, pool seed) and its
# decode cell (lengths, pool seed)
SPAN_CELLS = {"kernel_cell": ([1, 1000, 3, 960, 500, 1, 1023, 64],
                              [1, 4, 64, 17, 0, 64, 1, 33], 0),
              "serve_decode": ([128, 103, 89, 62, 66, 36, 40, 33],
                               [1] * 8, 2)}
DECODE_CELL = ([1, 1000, 3, 960, 0, 2, 1024, 64], 1)
PARTS = ("span", "nan_page", "int8_tc", "int8_search", "decode",
         "fused_bwd", "fused_fwd", "nms")
NMS_CELL = os.path.join(THIS_ROOT, "build", "nms_detect_cell.pt")
NMS_VARIANTS = os.path.join(THIS_ROOT, "build", "nms_variants")
# the cluster sizes each built as the only one a launch takes (the
# kernel's own build picks one at run time), and the cases probed
NMS_CLUSTERS = (1, 2, 4, 8, 16)
NMS_PROBE_CASES = ("detect", "limit", "all_valid", "ids80")
NMS_PHASES = ("compact", "barrier", "mask", "walk", "keep")
# the fused forward's cells: (B, H, T, D, layout, causal, dtype, row pad,
# numpy seed, key padding)
FWD_CELLS = {"bert_bthd": (32, 12, 512, 64, "BTHD", False, "float32", 0,
                           20, True),
             "bert_bhtd": (32, 12, 512, 64, "BHTD", False, "float32", 0,
                           21, True),
             "gpt2_774m_causal": (8, 20, 1024, 64, "BTHD", True, "float32",
                                  0, 22, False),
             "bert_bthd_d40_unaligned": (32, 12, 512, 40, "BTHD", False,
                                         "bfloat16", 4, 21, True)}


def rel_err(got, ref):
    err = (got.float() - ref.float()).abs().max().item()
    top = ref.float().abs().max().item()
    return err / top if top else err


def int8_search(torch, cs, ra):
    """The first (keys, seed) in SEARCH_KEYS x seeds whose int8 kernel
    error exceeds INT8_TOL, or None; and the error of every (keys, seed),
    keyed "keys:seed"."""
    errs = {}
    first = None
    for n in SEARCH_KEYS:
        P = -(-n // 16)
        for seed in range(SEARCH_SEEDS):
            q, kp, vp, table, ks, vs = cs.make_pool(
                torch, 1, 1, 1, 64, 16, P, P + 1, torch.bfloat16, seed,
                quant=True)
            args = (q, kp, vp, table,
                    torch.tensor([n], dtype=torch.int32, device="cuda"))
            kw = dict(q_counts=torch.ones(1, dtype=torch.int32,
                                          device="cuda"),
                      k_scale=ks, v_scale=vs)
            assert ra.span_route(q, kp, vp) == "tensor_core"
            e = rel_err(ra.ragged_span_attention(*args, impl="auto", **kw),
                        ra.ragged_span_attention(*args, impl="torch", **kw))
            errs[f"{n}:{seed}"] = e
            if first is None and e > INT8_TOL:
                first = {"keys": n, "seed": seed, "rel_err": e}
    return first, errs


def fused_bwd(torch, cs, fa):
    import numpy as np
    B, H, T, D = 32, 12, 512, 64
    rng = np.random.default_rng(20)
    lens = [int(n) for n in np.random.default_rng(0).integers(
        T * 3 // 4, T + 1, B)]

    def leaf():
        return torch.tensor(rng.standard_normal((B, T, H, D)),
                            dtype=torch.float32,
                            device="cuda").requires_grad_(True)
    q, k, v = leaf(), leaf(), leaf()
    do = torch.tensor(rng.standard_normal((B, T, H, D)), dtype=torch.float32,
                      device="cuda")
    mask = torch.arange(T, device="cuda")[None, :] \
        < torch.tensor(lens, device="cuda")[:, None]
    words = torch.tensor([12345, -678], dtype=torch.int32, device="cuda")
    res = {}
    for impl in ("auto", "torch"):
        o = fa.fused_attention(q, k, v, mask=mask, dropout_p=0.1, seed=words,
                               layout="BTHD", impl=impl)
        res[impl] = (o, torch.autograd.grad(o, (q, k, v), do,
                                            retain_graph=True))
    o = res["auto"][0]
    return {"ms": cs.time_ms(torch, lambda: torch.autograd.grad(
                o, (q, k, v), do, retain_graph=True)),
            "grad_rel_err": max(rel_err(a, b) for a, b in zip(
                res["auto"][1], res["torch"][1]))}


def fused_fwd(torch, cs, fa):
    import numpy as np
    out = {}
    for cell, (B, H, T, D, layout, causal, dt, pad, seed,
               padded) in FWD_CELLS.items():
        rng = np.random.default_rng(seed)
        shape = (B, T, H, D + pad) if layout == "BTHD" else (B, H, T, D + pad)
        q, k, v = (torch.tensor(rng.standard_normal(shape),
                                dtype=getattr(torch, dt),
                                device="cuda")[..., :D] for _ in range(3))
        mask = None
        if padded:
            lens = np.random.default_rng(0).integers(T * 3 // 4, T + 1, B)
            mask = torch.arange(T, device="cuda")[None, :] \
                < torch.tensor(lens, device="cuda")[:, None]
        words = torch.tensor([12345, -678], dtype=torch.int32, device="cuda")
        assert fa.kernel_route(q, k, v, layout) == "cuda_core"

        def run(impl):
            return fa.fused_attention(q, k, v, mask=mask, causal=causal,
                                      dropout_p=0.1, seed=words,
                                      layout=layout, impl=impl)
        with torch.no_grad():
            got, ref = run("auto"), run("torch")
            err = (got.float() - ref.float()).abs().max().item()
            out[cell] = {"max_abs_err": err,
                         "rel_err": err / ref.float().abs().max().item(),
                         "ms": cs.time_ms(torch, lambda: run("auto"))}
        del q, k, v, got, ref
        torch.cuda.empty_cache()
    return out


def this_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "this_chip_smoke", os.path.join(THIS_ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def nms_detect_cell(torch, cs, det):
    """(nms_keep's five arguments as SSD.detect passes them, detect's
    peak and resident memory in GB) through this process's package."""
    from mxnet_tpu_torch.models import vision
    c = cs.SSD_BENCH
    net = vision.ssd_512_resnet50_v1_voc(device="cuda").to(
        torch.bfloat16).eval()
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(c["B"], 3, c["S"], c["S"], device="cuda",
                    generator=gen).to(torch.bfloat16)
    seen = []
    keep = det.nms_keep

    def capture(*args, **kw):
        seen.append(args[:5])
        return keep(*args, **kw)
    det.nms_keep = capture
    try:
        net.detect(x, **cs.SSD_DETECT)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        net.detect(x, **cs.SSD_DETECT)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    finally:
        det.nms_keep = keep
    return seen[-1], peak / 1e9, resident / 1e9


def nms_variants(_build):
    """csrc/nms.cu built with each cluster size of NMS_CLUSTERS and with
    the probe, all nvcc processes at once: {name: ctypes library}."""
    os.makedirs(NMS_VARIANTS, exist_ok=True)
    flags = {f"cluster {c}": [f"-DNMS_CLUSTER={c}"] for c in NMS_CLUSTERS}
    flags["probe"] = ["-DNMS_PROBE"]
    procs = {}
    for name, extra in flags.items():
        so = os.path.join(NMS_VARIANTS, f"nms_{name.replace(' ', '')}.so")
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *extra, "-o", so,
             str(_build.SOURCES["nms"])]))
    libs = {}
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name, (so, proc) in procs.items():
        if proc.wait():
            raise RuntimeError(f"nvcc failed for the nms {name} build")
        lib = ctypes.CDLL(so)
        lib.mxt_nms.argtypes = [ptr] * 7 + [i32, i32, ctypes.c_float, i32,
                                            ptr]
        lib.mxt_nms.restype = i32
        lib._mxt_bound = True
        libs[name] = lib
    libs["probe"].mxt_nms_probe.argtypes = [ptr]
    return libs


def nms_probe(torch, det, lib, ins, thr, force, slots=8):
    """One call through the probe build: the cluster size it took, each
    phase's cycles in the images' leader blocks (median, largest) and
    the images that took the global path."""
    import numpy as np
    B = ins[2].shape[0]
    buf = torch.zeros(B * max(NMS_CLUSTERS) * slots, dtype=torch.int64,
                      device="cuda")
    lib.mxt_nms_probe(buf.data_ptr())
    det.nms_keep(*ins, thr, force)
    torch.cuda.synchronize()
    lib.mxt_nms_probe(None)
    p = buf.view(-1, slots).cpu().numpy()
    C = int(p[0, 7])
    lead = p[:B * C:C]
    res = {"cluster": C, "global_images": int(lead[:, 6].sum())}
    for k, phase in enumerate(NMS_PHASES):
        d = lead[:, k + 1] - lead[:, k]
        res[phase] = [int(np.median(d)), int(d.max())]
    return res


def nms(torch, root):
    cs = this_chip_smoke()
    from mxnet_tpu_torch.ops import _build
    from mxnet_tpu_torch.ops import detection as det
    args, peak, resident = nms_detect_cell(torch, cs, det)
    if not os.path.exists(NMS_CELL):
        os.makedirs(os.path.dirname(NMS_CELL), exist_ok=True)
        torch.save([a.cpu() if torch.is_tensor(a) else a for a in args],
                   NMS_CELL)
    args = [a.cuda() if torch.is_tensor(a) else a
            for a in torch.load(NMS_CELL)]
    cases = {"detect": (args[:3], args[3], args[4])}
    for i, (B, N, thr, force, special) in enumerate(cs.NMS_EDGES):
        cases[f"edge{i} {special} force={force}"] = (
            cs.nms_edge_inputs(torch, B, N, special, seed=i), thr, force)
    out = {"detect_peak_gb": peak, "detect_resident_gb": resident,
           "cases": {}}
    wants = {}
    for name, (ins, thr, force) in cases.items():
        valid = ins[2].sum(dim=1)
        before = det.LAUNCHES["nms"]
        got = det.nms_keep(*ins, thr, force)
        launches = det.LAUNCHES["nms"] - before
        wants[name] = det.nms_keep(*ins, thr, force, impl="torch")
        nbytes, ops, pairs, same = cs.nms_work(ins[2], ins[1], force)
        b_ms, b_by = cs.bound(nbytes, ops, "float32")
        out["cases"][name] = {
            "B": ins[2].shape[0], "N": ins[2].shape[1], "thresh": thr,
            "force": force,
            "valid_per_image": [int(valid.min()), int(valid.max())],
            "kept": int(wants[name].sum()),
            "equal": bool(torch.equal(got, wants[name])),
            "launches": launches, "bound_ms": b_ms, "bound_by": b_by,
            "valid_pairs": pairs, "same_id_pairs": same,
            "ms": cs.time_ms(torch, lambda: det.nms_keep(*ins, thr,
                                                         force))}
    if os.path.abspath(root) != THIS_ROOT:
        return out
    libs = nms_variants(_build)
    own = det._nms_lib
    try:
        for c in NMS_CLUSTERS:
            det._nms_lib = lambda: libs[f"cluster {c}"]
            for name, (ins, thr, force) in cases.items():
                res = out["cases"][name]
                res.setdefault("cluster_equal", {})[c] = bool(torch.equal(
                    det.nms_keep(*ins, thr, force), wants[name]))
                res.setdefault("cluster_ms", {})[c] = cs.time_ms(
                    torch, lambda: det.nms_keep(*ins, thr, force))
        det._nms_lib = lambda: libs["probe"]
        out["probe"] = {
            name: nms_probe(torch, det, libs["probe"], ins, thr, force)
            for name, (ins, thr, force) in cases.items()
            if any(p in name for p in NMS_PROBE_CASES)}
    finally:
        det._nms_lib = own
    out["sm_clock"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    return out


def child(root, parts):
    sys.path.insert(0, root)
    sys.path.insert(1, THIS_ROOT)
    import torch
    import chip_smoke as cs
    from mxnet_tpu_torch.ops import _build
    from mxnet_tpu_torch.ops import fused_attention as fa
    from mxnet_tpu_torch.ops import ragged_attention as ra

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all(["nms"] if parts == ["nms"] else None)
    out = {"root": root, "span": {}, "int8_tc": {}, "decode": {}}
    if "span" in parts:
        for cell, (lengths, qcs, seed) in SPAN_CELLS.items():
            for dtype in (torch.float32, torch.bfloat16):
                q, kp, vp, table, _, _ = cs.make_pool(
                    torch, 8, 64, 20, 64, 64, 16, 128, dtype, seed)
                args = (q, kp, vp, table,
                        torch.tensor(lengths, dtype=torch.int32,
                                     device="cuda"))
                kw = dict(q_counts=torch.tensor(qcs, dtype=torch.int32,
                                                device="cuda"))
                got = ra.ragged_span_attention(*args, impl="auto", **kw)
                ref = ra.ragged_span_attention(*args, impl="torch", **kw)
                out["span"][f"{cell} {str(dtype).split('.')[-1]}"] = {
                    "max_abs_err": (got.float() - ref.float()).abs().max()
                    .item(),
                    "rel_err": rel_err(got, ref),
                    "ms": cs.time_ms(torch, lambda: ra.ragged_span_attention(
                        *args, impl="auto", **kw))}
    if "nan_page" in parts:
        out["nan_page"] = {}
        one = torch.ones(1, dtype=torch.int32, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            q, kp, vp, table, _, _ = cs.make_pool(
                torch, 1, 1, 1, 64, 16, 1, 1, dtype, 0)
            kp.fill_(float("nan"))
            name = str(dtype).split(".")[-1]
            for kind, fn, args, kw in (
                    ("span", ra.ragged_span_attention,
                     (q, kp, vp, table, one), dict(q_counts=one)),
                    ("decode", ra.ragged_decode_attention,
                     (q[:, 0].contiguous(), kp, vp, table, one), {})):
                got = fn(*args, impl="auto", **kw)
                ref = fn(*args, impl="torch", **kw)
                out["nan_page"][f"{kind} {name}"] = {
                    "kernel_nan": int(torch.isnan(got).sum()),
                    "plain_nan": int(torch.isnan(ref).sum()),
                    "elements": got.numel()}
    if "int8_tc" in parts:
        for cell, (lengths, qcs, seed) in SPAN_CELLS.items():
            q, kp, vp, table, ks, vs = cs.make_pool(
                torch, 8, 64, 20, 64, 64, 16, 128, torch.bfloat16, seed,
                quant=True)
            args = (q, kp, vp, table,
                    torch.tensor(lengths, dtype=torch.int32, device="cuda"))
            kw = dict(q_counts=torch.tensor(qcs, dtype=torch.int32,
                                            device="cuda"),
                      k_scale=ks, v_scale=vs)
            got = ra.ragged_span_attention(*args, impl="auto", **kw)
            ref = ra.ragged_span_attention(*args, impl="torch", **kw)
            out["int8_tc"][cell] = {
                "rel_err": rel_err(got, ref),
                "ms": cs.time_ms(torch, lambda: ra.ragged_span_attention(
                    *args, impl="auto", **kw))}
    if "int8_search" in parts:
        first, errs = int8_search(torch, cs, ra)
        out["int8_search"] = {"first_over_tol": first,
                              "worst": max(errs.values()), "errs": errs}
    if "decode" in parts:
        lengths, seed = DECODE_CELL
        for dtype in (torch.float32, torch.bfloat16):
            q4, kp, vp, table, _, _ = cs.make_pool(
                torch, 8, 1, 20, 64, 64, 16, 128, dtype, seed)
            args = (q4[:, 0].contiguous(), kp, vp, table,
                    torch.tensor(lengths, dtype=torch.int32, device="cuda"))
            got = ra.ragged_decode_attention(*args, impl="auto")
            ref = ra.ragged_decode_attention(*args, impl="torch")
            out["decode"][str(dtype).split(".")[-1]] = {
                "max_abs_err": (got.float() - ref.float()).abs().max()
                .item(),
                "rel_err": rel_err(got, ref),
                "ms": cs.time_ms(torch, lambda: ra.ragged_decode_attention(
                    *args, impl="auto"))}
    if "fused_bwd" in parts:
        out["fused_bwd"] = fused_bwd(torch, cs, fa)
    if "fused_fwd" in parts:
        out["fused_fwd"] = fused_fwd(torch, cs, fa)
    if "nms" in parts:
        out["nms"] = nms(torch, root)
    print(json.dumps(out), flush=True)


def main(argv):
    if len(argv) >= 3 and argv[1] == "--child":
        child(argv[2], argv[3:])
        return 0
    out_dir = None
    if "--out" in argv[:-1]:
        i = argv.index("--out")
        out_dir, argv = argv[i + 1], argv[:i] + argv[i + 2:]
    parts = argv[2:] or list(PARTS)
    if len(argv) < 2 or not os.path.isdir(
            os.path.join(argv[1], "mxnet_tpu_torch")) \
            or not set(parts) <= set(PARTS):
        print(__doc__, file=sys.stderr)
        return 2
    import numpy as np
    roots = {"other": os.path.abspath(argv[1]), "this": THIS_ROOT}
    if "nms" in parts and os.path.exists(NMS_CELL):
        os.remove(NMS_CELL)
    samples, search, errs, runs = {}, {}, {}, []
    for side in ("other", "this", "this", "other"):
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--child", roots[side], *parts],
                           capture_output=True, text=True, check=False)
        if r.returncode:
            print(r.stderr[-4000:], file=sys.stderr)
            return r.returncode
        run = json.loads(r.stdout.strip().splitlines()[-1])
        if "int8_search" in run:
            search[side] = run["int8_search"]["first_over_tol"]
            errs[side] = run["int8_search"].pop("errs")
        runs.append({"side": side, **run})
        print(json.dumps(runs[-1]), flush=True)
        for part in ("span", "int8_tc", "decode", "fused_fwd"):
            for cell, res in run.get(part, {}).items():
                samples.setdefault(f"{side} {part} {cell}", []).append(
                    res["ms"])
        if "fused_bwd" in run:
            samples.setdefault(f"{side} fused_bwd float32", []).append(
                run["fused_bwd"]["ms"])
        for case, res in run.get("nms", {}).get("cases", {}).items():
            samples.setdefault(f"{side} nms {case}", []).append(res["ms"])
            for c, ms in res.get("cluster_ms", {}).items():
                samples.setdefault(f"{side} nms {case} cluster {c}",
                                   []).append(ms)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    # each side's error on the input where the other side's first
    # exceeded the tolerance
    crossed = {side: {f"{f['keys']}:{f['seed']}": errs[o][
                   f"{f['keys']}:{f['seed']}"]}
               for side, o in (("other", "this"), ("this", "other"))
               for f in [search.get(side)] if f}
    summary = {"card": card, "int8_first_over_tol": search,
               "int8_error_there_on_the_other_side": crossed,
               "median_ms": {k: float(np.median(v))
                             for k, v in samples.items()}}
    if "nms" in parts:
        summary["nms_all_equal"] = all(
            res["equal"] and all(res.get("cluster_equal", {}).values())
            for run in runs for res in run["nms"]["cases"].values())
    print(json.dumps(summary), flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "compare_kernels.json"), "w") as fh:
            json.dump({"runs": runs, "summary": summary}, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
