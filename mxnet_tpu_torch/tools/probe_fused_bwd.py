"""Probe of two designs for the float32 fused attention backward, on one
card.

    python3 -m mxnet_tpu_torch.tools.probe_fused_bwd

Builds `csrc/fused_bwd_probe.cu` and times its two dQ kernels (design
"fma": register-tiled CUDA-core FMAs; design "tf32x3": the port's
fused_bwd_dq_kernel<float, 64>, split TF32 on the tensor cores) on the
dQ pass of BERT-base attention (T = 512, D = 64, key padding, no
dropout): one (b, h) cell, then the whole BERT-base batch (B = 32,
H = 12, valid lengths U[384, 512] from numpy seed 0). Inputs are float32
from numpy seed 0; m, l and O come from a float32 forward in PyTorch,
the reference dQ from a float64 one. Prints, per cell and design, the
median ms of 25 launches (chip_smoke.py's `time_ms`: CUDA events, a 64 MB
L2 flush before each) and the largest |dQ - reference| over the largest
|reference|, then the card's name and power limit.
"""
import ctypes
import json
import os
import sys

THIS_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELLS = {"one_cell": (1, 1), "bert_base": (32, 12)}
T, D = 512, 64
DESIGNS = ("fma", "tf32x3")


def main():
    sys.path.insert(0, THIS_ROOT)
    import numpy as np
    import torch
    import chip_smoke as cs
    from mxnet_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.SOURCES.setdefault("fused_bwd_probe",
                              _build._CSRC / "fused_bwd_probe.cu")
    lib = _build.load("fused_bwd_probe")
    fn = lib.mxt_probe_fused_bwd_dq
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 12 \
        + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = {"card": cs.smi()}
    scale = 1.0 / D ** 0.5
    for cell, (B, H) in CELLS.items():
        rng = np.random.default_rng(0)
        lens = [int(n) for n in np.random.default_rng(0).integers(
            T * 3 // 4, T + 1, B)]
        q, k, v, do = (torch.tensor(rng.standard_normal((B, T, H, D)),
                                    dtype=torch.float32, device="cuda")
                       for _ in range(4))
        bias = torch.where(torch.arange(T, device="cuda")[None, :]
                           < torch.tensor(lens, device="cuda")[:, None],
                           0.0, -1e30).float().contiguous()
        # the forward's statistics and output, (B, H, T) and (B, T, H, D)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale \
            + bias[:, None, None, :]
        m = s.amax(-1)
        e = torch.exp(s - m[..., None])
        l = e.sum(-1)
        o32 = torch.einsum("bhqk,bkhd->bqhd", e / l[..., None], v)
        # the float64 reference dQ
        s64 = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) \
            * scale + bias.double()[:, None, None, :]
        p64 = torch.softmax(s64, -1)
        dp64 = torch.einsum("bqhd,bkhd->bhqk", do.double(), v.double())
        o64 = torch.einsum("bhqk,bkhd->bqhd", p64, v.double())
        dr64 = (do.double() * o64).sum(-1).transpose(1, 2)[..., None]
        ref = torch.einsum("bhqk,bkhd->bqhd", p64 * (dp64 - dr64) * scale,
                           k.double())
        del s, e, s64, p64, dp64
        m, l = m.contiguous(), l.contiguous()
        rowbuf = torch.empty((2, B, H, T), dtype=torch.float32,
                             device="cuda")
        seed = torch.zeros(2, dtype=torch.int32, device="cuda")
        dq = torch.empty_like(q)
        flat = [x for t in (q, k, v, o32, do, dq)
                for x in (t.stride(0), t.stride(1), t.stride(2))]
        strides = (ctypes.c_longlong * len(flat))(*flat)
        res = {"B": B, "H": H, "T": T, "D": D, "valid_lengths": lens}
        for design, code in zip(DESIGNS, range(2)):
            def run():
                err = fn(code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         o32.data_ptr(), do.data_ptr(), bias.data_ptr(),
                         seed.data_ptr(), m.data_ptr(), l.data_ptr(),
                         rowbuf.data_ptr(), dq.data_ptr(), strides, B, H, T,
                         T, scale, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{design}: cudaError {err}")
            dq.zero_()
            run()
            torch.cuda.synchronize()
            rel = ((dq.double() - ref).abs().max()
                   / ref.abs().max()).item()
            res[design] = {"ms": cs.time_ms(torch, run), "rel_err": rel}
        out[cell] = res
        del q, k, v, do, o32, ref, dq
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
