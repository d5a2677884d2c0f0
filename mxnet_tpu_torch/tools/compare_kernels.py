"""Kernel times and errors of this checkout against another one, on one
card.

    python3 -m mxnet_tpu_torch.tools.compare_kernels OTHER_ROOT [PART ...]

OTHER_ROOT is the root of another checkout of the port (for example the
parent commit unpacked with `git archive`). Each run is a fresh process
that imports `mxnet_tpu_torch` from one root, builds its kernels and
measures, through the public entry points, on chip_smoke.py's inputs
(its helpers `make_pool`, `time_ms`: CUDA events, a 64 MB L2 flush
before each of 25 launches, the median):

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
    over the largest plain value).

PARTs (default: all) pick which of int8_tc, int8_search, decode,
fused_bwd and fused_fwd run. The runs take turns, other, this, this,
other. Prints one JSON line per
run, then the medians of each side and the card's name and power limit.
"""
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
PARTS = ("int8_tc", "int8_search", "decode", "fused_bwd", "fused_fwd")
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


def child(root, parts):
    sys.path.insert(0, root)
    sys.path.insert(1, THIS_ROOT)
    import torch
    import chip_smoke as cs
    from mxnet_tpu_torch.ops import _build
    from mxnet_tpu_torch.ops import fused_attention as fa
    from mxnet_tpu_torch.ops import ragged_attention as ra

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    out = {"root": root, "int8_tc": {}, "decode": {}}
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
    print(json.dumps(out), flush=True)


def main(argv):
    if len(argv) >= 3 and argv[1] == "--child":
        child(argv[2], argv[3:])
        return 0
    parts = argv[2:] or list(PARTS)
    if len(argv) < 2 or not os.path.isdir(
            os.path.join(argv[1], "mxnet_tpu_torch")) \
            or not set(parts) <= set(PARTS):
        print(__doc__, file=sys.stderr)
        return 2
    import numpy as np
    roots = {"other": os.path.abspath(argv[1]), "this": THIS_ROOT}
    samples, search, errs = {}, {}, {}
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
        print(json.dumps({"side": side, **run}), flush=True)
        for part in ("int8_tc", "decode", "fused_fwd"):
            for cell, res in run.get(part, {}).items():
                samples.setdefault(f"{side} {part} {cell}", []).append(
                    res["ms"])
        if "fused_bwd" in run:
            samples.setdefault(f"{side} fused_bwd float32", []).append(
                run["fused_bwd"]["ms"])
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
    print(json.dumps({"card": card, "int8_first_over_tol": search,
                      "int8_error_there_on_the_other_side": crossed,
                      "median_ms": {k: float(np.median(v))
                                    for k, v in samples.items()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
