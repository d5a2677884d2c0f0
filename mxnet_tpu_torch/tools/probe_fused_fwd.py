"""Probe of the fused attention forward's K/V staging, on one card.

    python3 -m mxnet_tpu_torch.tools.probe_fused_fwd

Builds `csrc/fused_fwd_probe.cu` and times fused_attention.cu's forward
kernel with one K/V stage and with two (`fused_fwd_kernel<T, DP,
STAGES>`; the package launches `FWD_STAGES`) at chip_smoke.py's fused
cells: float32 BERT-base BTHD and BHTD (B = 32, T = 512, H = 12, D = 64,
key padding from valid lengths U[384, 512], dropout 0.1), float32 GPT-2
774M causal (B = 8, T = 1024, H = 20, D = 64, dropout 0.1, BTHD), and
bfloat16 BERT-base BTHD at D = 40 on rows 44 elements apart. Inputs as
chip_smoke's `fused_case` makes them (numpy seeds 20, 21, 22, 21). Per
cell and stage count: the median ms of 25 launches (chip_smoke's
`time_ms`: CUDA events, a 64 MB L2 flush before each) and the largest
error against the plain version (float32 absolute, bfloat16 over the
largest plain value); then the card's name and power limit.
"""
import ctypes
import json
import os
import sys

THIS_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# (B, H, T, D, layout, causal, dropout, dtype, pad, seed, key padding)
CELLS = {"bert_bthd": (32, 12, 512, 64, "BTHD", False, 0.1, "float32", 0,
                       20, True),
         "bert_bhtd": (32, 12, 512, 64, "BHTD", False, 0.1, "float32", 0,
                       21, True),
         "gpt2_774m_causal": (8, 20, 1024, 64, "BTHD", True, 0.1, "float32",
                              0, 22, False),
         "bert_bthd_d40_unaligned": (32, 12, 512, 40, "BTHD", False, 0.1,
                                     "bfloat16", 4, 21, True)}


def main():
    sys.path.insert(0, THIS_ROOT)
    import numpy as np
    import torch
    import chip_smoke as cs
    from mxnet_tpu_torch.ops import _build
    from mxnet_tpu_torch.ops import fused_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.SOURCES.setdefault("fused_fwd_probe",
                              _build._CSRC / "fused_fwd_probe.cu")
    fn = _build.load("fused_fwd_probe").mxt_probe_fused_fwd
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [i32] + [ptr] * 10 + [i32] * 5 \
        + [f32, f32, ctypes.c_uint32] + [i32] * 3 + [ptr]
    fn.restype = i32
    out = {"card": cs.smi()}
    for cell, (B, H, T, D, layout, causal, p, dt, pad, seed,
               padded) in CELLS.items():
        dtype = getattr(torch, dt)
        rng = np.random.default_rng(seed)
        shape = (B, T, H, D + pad) if layout == "BTHD" else (B, H, T, D + pad)
        q, k, v = (torch.tensor(rng.standard_normal(shape), dtype=dtype,
                                device="cuda")[..., :D] for _ in range(3))
        lens = [int(n) for n in np.random.default_rng(0).integers(
            T * 3 // 4, T + 1, B)] if padded else None
        mask = None if lens is None else (
            torch.arange(T, device="cuda")[None, :]
            < torch.tensor(lens, device="cuda")[:, None])
        bias = fa._key_bias(mask, B, T, q.device)
        words = torch.tensor([12345, -678], dtype=torch.int32, device="cuda")
        scale = 1.0 / D ** 0.5
        ref = fa._fused_reference(q, k, v, bias, words, scale, p, causal,
                                  layout)
        o = torch.empty_like(q)
        o32 = None if dtype == torch.float32 else \
            torch.empty_like(q, dtype=torch.float32)
        stats = torch.empty((2, B, H, T), dtype=torch.float32, device="cuda")
        strides = fa._strides((q, k, v, o), layout)
        res = {"B": B, "H": H, "T": T, "D": D, "layout": layout,
               "causal": causal, "dtype": dt, "row_pad": pad}
        for stages in (1, 2):
            def run():
                err = fn(stages, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         bias.data_ptr(), words.data_ptr(), o.data_ptr(),
                         None if o32 is None else o32.data_ptr(),
                         stats[0].data_ptr(), stats[1].data_ptr(), strides,
                         B, H, T, T, D, scale, 1.0 / (1.0 - p),
                         fa._threshold(p), 1, int(causal),
                         fa._DTYPES[dtype],
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{cell} stages={stages}: "
                                       f"cudaError {err}")
            o.zero_()
            run()
            torch.cuda.synchronize()
            err = (o.float() - ref.float()).abs().max().item()
            res[f"stages_{stages}"] = {
                "ms": cs.time_ms(torch, run),
                "max_abs_err": err,
                "rel_err": err / ref.float().abs().max().item()}
        out[cell] = res
        del q, k, v, o, o32, ref, stats
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
