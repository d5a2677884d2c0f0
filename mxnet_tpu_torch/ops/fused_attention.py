"""Fused attention for training: softmax(Q·Kᵀ·s + bias) → dropout → ·V,
with its backward.

Counterpart of the training half of mxnet_tpu/ops/pallas_attention.py
(`fused_attention`, `supported`, `MAX_FUSED_T`, `_software_bits`).
Hand-written CUDA kernels replace the four Pallas bodies
`_fwd_kernel_packed`/`_bwd_kernel_packed` (layout "BTHD") and
`_fwd_kernel`/`_bwd_kernel` (layout "BHTD"): they take element strides
for (batch, time, head), so both layouts are views of one kernel. Two
kernel families, chosen per call by `kernel_route` before anything is
launched:

  * "tensor_core" (`csrc/fused_attention_tc.cu`): bfloat16 q/k/v whose
    rows the 16-byte async copies can stage — head dim D % 8 == 0, every
    (batch, time, head) element stride of q, k, v (and of the gradient,
    which the backward copies if it is not) a multiple of 8, every base
    address 16-byte aligned. wgmma products, float32 accumulators.
  * "cuda_core" (`csrc/fused_attention.cu`): float32, and bfloat16 that
    the rule above refuses (D = 12, a misaligned stride or base). Rows
    staged by cp.async at whatever width they allow; every product on
    the tensor cores by mma.sync in split TF32 (each float32 operand as
    hi + lo TF32 terms, three products; bfloat16 operands take one),
    which keeps float32's accuracy where plain TF32 would not meet the
    1e-5 forward and 1e-4 gradient checks. The route keeps the name of
    its first design, scalar FMAs on the CUDA cores.

A plain PyTorch version of the same function sits beside them
(`_fused_reference`); torch autograd differentiates it.

The dropout keep mask is the reference's interpret-mode counter hash
(`software_bits`): bit for bit the same mask as the JAX package's
interpret-mode kernels for the same two seed words, in the plain version
and in both kernel families alike. Seeds are two int32 words in a (2,)
tensor on q's device, as the Pallas kernel's `seed`; the cell index
b·H + h is folded into the second.

impl="auto" takes the plain version for a tensor on the CPU and a kernel
for a tensor on a CUDA card; a CUDA call the kernels cannot take raises.
impl="torch" takes the plain version anywhere. Each launch adds one to
LAUNCHES["fused_attention_fwd"] / ["fused_attention_bwd"] (CUDA-core
kernels) or ["fused_attention_fwd_tc"] / ["fused_attention_bwd_tc"]
(tensor-core kernels).
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..base import MXNetError
from . import _build

__all__ = ["fused_attention", "supported", "kernel_route", "software_bits",
           "MAX_FUSED_T", "NEG_INF", "LAUNCHES", "reset_launches"]

NEG_INF = -1e30
# The reference's whole-row limit (its Pallas tile holds a whole row),
# exported for parity. Nothing here routes on it: the CUDA kernel is
# tiled and takes any T.
MAX_FUSED_T = 1024

LAUNCHES = {"fused_attention_fwd": 0, "fused_attention_bwd": 0,
            "fused_attention_fwd_tc": 0, "fused_attention_bwd_tc": 0}

_MAX_D = 128                 # head dim limit of the kernel
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_IMPLS = ("auto", "torch")
_LAYOUTS = ("BHTD", "BTHD")
_U32 = 0xFFFFFFFF


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# the dropout hash (port of _software_bits)
# ---------------------------------------------------------------------------

def _mul32(x, c):
    """(x * c) mod 2**32 for int64 x in [0, 2**32), without int64
    overflow: the high half of c contributes only its low 16 bits."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _mix(x):
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def software_bits(s0, s1, shape, device=None):
    """The reference's counter hash: uint32 `mix(mix(pos ^ s0) ^ s1)`
    with pos = row * shape[1] + col, as int64 values in [0, 2**32).
    s0/s1 are ints or int tensors (their low 32 bits are used) and
    broadcast against the (rows, cols) grid."""
    rows, cols = shape
    pos = (torch.arange(rows, dtype=torch.int64, device=device)[:, None]
           * cols
           + torch.arange(cols, dtype=torch.int64, device=device)[None, :]
           ) & _U32
    s0 = torch.as_tensor(s0, dtype=torch.int64, device=device) & _U32
    s1 = torch.as_tensor(s1, dtype=torch.int64, device=device) & _U32
    return _mix(_mix(pos ^ s0) ^ s1)


def _threshold(p_drop):
    return min(int(p_drop * 2.0 ** 32), 2 ** 32 - 1)


def _keep_mask(seed, p_drop, B, H, tq, tk):
    """(B, H, tq, tk) bool: the reference's per-(b, h) cell masks."""
    seed = seed.to(torch.int64)
    cell = torch.arange(B * H, dtype=torch.int64,
                        device=seed.device).reshape(B, H, 1, 1)
    bits = software_bits(seed[0], seed[1] ^ cell, (tq, tk),
                         device=seed.device)
    return bits >= _threshold(p_drop)


# ---------------------------------------------------------------------------
# routing gate and argument preparation
# ---------------------------------------------------------------------------

def _is_key_padding(mask, tk):
    """True for masks shaped (B, Tk) or (B, 1, 1, Tk)."""
    if mask.dim() == 2:
        return mask.shape[-1] == tk
    if mask.dim() == 4:
        return (mask.shape[1] == 1 and mask.shape[2] == 1
                and mask.shape[-1] == tk)
    return False


def supported(q, k, mask, layout="BHTD"):
    """Can the fused kernel take this call? float32/bfloat16, head dim
    at most 128, and a key-padding mask (or none); any T. Dropout works
    on every supported shape. Unlike the reference's TPU kernels, the
    CUDA kernel needs no whole row in one tile and no head dim multiple
    of 64."""
    Tk = k.shape[-2 if layout == "BHTD" else -3]
    if q.dtype not in _DTYPES or not 1 <= q.shape[-1] <= _MAX_D:
        return False
    if mask is not None and not _is_key_padding(mask, Tk):
        return False
    return True


def _key_bias(mask, B, Tk, device):
    """Additive float32 key bias (B, Tk): 0 where the key-padding mask
    is True, NEG_INF where it is False; zeros without a mask."""
    if mask is None:
        return torch.zeros((B, Tk), dtype=torch.float32, device=device)
    m2 = mask.reshape(mask.shape[0], mask.shape[-1]).to(device)
    bias = torch.where(m2, 0.0, NEG_INF).to(torch.float32)
    if bias.shape[0] == 1 and B > 1:
        bias = bias.expand(B, Tk)
    return bias.contiguous()


# ---------------------------------------------------------------------------
# the plain version (the reference's kernel math, whole rows, float32)
# ---------------------------------------------------------------------------

def _fused_reference(q, k, v, bias, seed, scale, p_drop, causal, layout):
    if layout == "BTHD":
        q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    B, H, Tq, _ = q.shape
    Tk = k.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s = s + bias[:, None, None, :]
    if causal:
        qpos = torch.arange(Tq, device=q.device)[:, None]
        kpos = torch.arange(Tk, device=q.device)[None, :]
        s = torch.where(qpos + (Tk - Tq) >= kpos, s,
                        torch.full_like(s, NEG_INF))
    # the output does not depend on the shift m: no gradient through it
    # (with no key at all every row is fully masked)
    m = s.detach().amax(dim=-1, keepdim=True) if Tk else \
        torch.full_like(s[..., :1], NEG_INF)
    # fully masked rows (m == NEG_INF) contribute zeros, not exp(0)
    e = torch.where(m <= NEG_INF / 2, torch.zeros_like(s), torch.exp(s - m))
    l = e.sum(dim=-1, keepdim=True)
    inv_keep = 1.0
    if p_drop > 0.0:
        keep = _keep_mask(seed, p_drop, B, H, Tq, Tk)
        e = torch.where(keep, e, torch.zeros_like(e))
        inv_keep = 1.0 / (1.0 - p_drop)
    if v.dtype != torch.float32:
        # P·V takes the probabilities rounded to v's dtype, as the
        # reference's kernel does; its backward differentiates the
        # unrounded ones (straight through the rounding)
        e = e + (e.to(v.dtype).float() - e).detach()
    o = torch.matmul(e, v.float())
    o = (o * (inv_keep / l.clamp_min(1e-30))).to(q.dtype)
    return o.transpose(1, 2) if layout == "BTHD" else o


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

def _lib(route):
    """The (forward, backward) C entries of a kernel family, bound. The
    CUDA-core entries take a dtype code before the stream, the
    tensor-core ones do not."""
    tc = route == "tensor_core"
    lib = _build.load("fused_attention_tc" if tc else "fused_attention")
    prefix = "mxt_fused_attention_tc" if tc else "mxt_fused_attention"
    fwd, bwd = getattr(lib, prefix + "_fwd"), getattr(lib, prefix + "_bwd")
    if not getattr(lib, "_mxt_bound", False):
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        flags = [i32] * (2 if tc else 3)     # dropout, causal[, dtype]
        fwd.argtypes = ([ptr] * 10 + [i32] * 5
                        + [f32, f32, ctypes.c_uint32] + flags + [ptr])
        # both backwards also take the row statistics and keep-bit scratch
        bwd.argtypes = ([ptr] * 15 + [i32] * 5
                        + [f32, f32, ctypes.c_uint32] + flags + [ptr])
        fwd.restype = bwd.restype = i32
        lib._mxt_bound = True
    return fwd, bwd


def _bth(x, layout):
    """Element strides of x for (batch, time, head); its head dim must
    be contiguous."""
    if layout == "BTHD":
        return x.stride(0), x.stride(1), x.stride(2)
    return x.stride(0), x.stride(2), x.stride(1)


def _strides(tensors, layout):
    flat = [s for x in tensors for s in _bth(x, layout)]
    return (ctypes.c_longlong * len(flat))(*flat)


def _geometry(q, k, layout):
    if layout == "BTHD":
        B, Tq, H, D = q.shape
        Tk = k.shape[1]
    else:
        B, H, Tq, D = q.shape
        Tk = k.shape[2]
    return B, H, Tq, Tk, D


def _stageable(x, layout):
    """Can 16-byte async copies stage x's rows: its base 16-byte aligned
    and its (batch, time, head) element strides multiples of 8?"""
    return x.data_ptr() % 16 == 0 and all(
        s % 8 == 0 for s in _bth(x, layout))


def kernel_route(q, k, v, layout="BHTD"):
    """The kernel family a CUDA call with these tensors takes, decided
    before any launch: "tensor_core" for bfloat16 with a head dim that is
    a multiple of 8 and rows that `_stageable` accepts for each of q, k
    and v; "cuda_core" for everything else the kernels take (float32,
    other bfloat16 calls). Reads only dtypes, shapes, strides and
    addresses, so it also answers for CPU tensors."""
    if q.dtype == torch.bfloat16 and q.shape[-1] % 8 == 0 \
            and all(_stageable(x, layout) for x in (q, k, v)):
        return "tensor_core"
    return "cuda_core"


def _check_kernel_args(q, k, v, bias, seed, layout):
    name = "fused_attention"
    if any(t.device != q.device for t in (k, v, bias, seed)):
        raise MXNetError(f"{name}: every tensor must be on {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise MXNetError(f"{name}: the CUDA kernel takes float32 or "
                         f"bfloat16 q/k/v of one dtype, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    B, H, Tq, Tk, D = _geometry(q, k, layout)
    if not 1 <= D <= _MAX_D:
        raise MXNetError(f"{name}: head dim {D} exceeds {_MAX_D}")
    if k.shape != v.shape or k.dim() != 4 or q.dim() != 4 \
            or _geometry(k, k, layout)[:2] != (B, H) \
            or k.shape[-1] != D:
        raise MXNetError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)} "
                         f"and v {tuple(v.shape)} do not match ({layout})")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise MXNetError(f"{name}: the kernel needs the head dim "
                         "contiguous")
    if bias.shape != (B, Tk) or seed.shape != (2,) \
            or seed.dtype != torch.int32:
        raise MXNetError(f"{name}: bias must be (B, Tk) float32 and seed "
                         "(2,) int32")


def _use_kernel(impl, q):
    return impl == "auto" and q.is_cuda


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


class _FusedAttention(torch.autograd.Function):
    """The CUDA forward and backward of one kernel family (`kernel_route`,
    decided in the forward, kept by the backward). The forward saves the
    row max m and the pre-dropout denominator l (float32, (B, H, Tq)) and
    the output in float32 (for bfloat16 a float32 copy the kernel writes
    beside it); the backward recomputes the probabilities and the keep
    mask from them."""

    @staticmethod
    def forward(ctx, q, k, v, bias, seed, scale, p_drop, causal, layout):
        B, H, Tq, Tk, D = _geometry(q, k, layout)
        ctx.empty = q.numel() == 0 or k.numel() == 0
        if ctx.empty:
            # nothing to attend to: the reference's fully masked rows
            # are zeros, and so are their gradients; no launch
            ctx.save_for_backward(q, k, v)
            return torch.zeros_like(q)
        route = kernel_route(q, k, v, layout)
        tc = route == "tensor_core"
        o = torch.empty_like(q)
        o32 = None if q.dtype == torch.float32 else \
            torch.empty_like(q, dtype=torch.float32)
        stats = torch.empty((2, B, H, Tq), dtype=torch.float32,
                            device=q.device)
        inv_keep = 1.0 / (1.0 - p_drop) if p_drop > 0.0 else 1.0
        dtype = () if tc else (_DTYPES[q.dtype],)
        with torch.cuda.device(q.device):
            err = _lib(route)[0](
                q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                seed.data_ptr(), o.data_ptr(),
                None if o32 is None else o32.data_ptr(), stats[0].data_ptr(),
                stats[1].data_ptr(), _strides((q, k, v, o), layout),
                B, H, Tq, Tk, D, scale, inv_keep,
                _threshold(p_drop) if p_drop > 0.0 else 0,
                int(p_drop > 0.0), int(causal), *dtype, _stream(q))
        if err:
            raise MXNetError(f"fused_attention forward: kernel launch "
                             f"failed (cudaError {err})")
        LAUNCHES["fused_attention_fwd_tc" if tc else "fused_attention_fwd"] \
            += 1
        ctx.save_for_backward(q, k, v, o if o32 is None else o32, bias,
                              seed, stats)
        ctx.args = (scale, p_drop, causal, layout, inv_keep, route)
        return o

    @staticmethod
    def backward(ctx, do):
        if ctx.empty:
            return (*map(torch.zeros_like, ctx.saved_tensors),
                    None, None, None, None, None, None)
        q, k, v, o32, bias, seed, stats = ctx.saved_tensors
        scale, p_drop, causal, layout, inv_keep, route = ctx.args
        tc = route == "tensor_core"
        B, H, Tq, Tk, D = _geometry(q, k, layout)
        # the kernels read the gradient with its own strides, but need its
        # head dim contiguous (an expanded gradient is not); the
        # tensor-core kernels also need its rows stageable
        if do.stride(-1) != 1 or (tc and not _stageable(do, layout)):
            do = do.clone(memory_format=torch.contiguous_format)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
            torch.empty_like(v)
        # scratch: the row's log2-domain logsumexp and d_row, and with
        # dropout the keep bits the dQ kernel hands to the dK/dV kernel
        # (32 keys a word)
        rowbuf = torch.empty((2, B, H, Tq), dtype=torch.float32,
                             device=q.device)
        keep = torch.empty((B, H, Tq, (Tk + 31) // 32), dtype=torch.int32,
                           device=q.device) if p_drop > 0.0 else None
        dtype = () if tc else (_DTYPES[q.dtype],)
        with torch.cuda.device(q.device):
            err = _lib(route)[1](
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o32.data_ptr(),
                do.data_ptr(), bias.data_ptr(), seed.data_ptr(),
                stats[0].data_ptr(), stats[1].data_ptr(),
                rowbuf.data_ptr(), None if keep is None else keep.data_ptr(),
                dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(),
                _strides((q, k, v, o32, do, dq, dk, dv), layout),
                B, H, Tq, Tk, D, scale, inv_keep,
                _threshold(p_drop) if p_drop > 0.0 else 0,
                int(p_drop > 0.0), int(causal), *dtype, _stream(q))
        if err:
            raise MXNetError(f"fused_attention backward: kernel launch "
                             f"failed (cudaError {err})")
        LAUNCHES["fused_attention_bwd_tc" if tc else "fused_attention_bwd"] \
            += 1
        return dq, dk, dv, None, None, None, None, None, None


def fused_attention(q, k, v, mask=None, scale=None, causal=False,
                    dropout_p=0.0, seed=None, layout="BHTD", impl="auto"):
    """Fused softmax(QKᵀ·s + bias) → dropout → ·V, differentiable in q,
    k and v. layout "BHTD" takes (B, H, T, D) tensors, "BTHD" takes
    (B, T, H, D) straight from the head-split reshape; the output has
    q's layout and dtype.

    mask: optional key-padding mask, (B, Tk) or (B, 1, 1, Tk), True =
    attend. Fully masked rows yield zeros.
    seed: (2,) int32 tensor of the dropout mask's seed words (required
    when dropout_p > 0); the same words give the same mask.
    """
    if layout not in _LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}")
    if impl not in _IMPLS:
        raise ValueError(f"unknown fused attention impl {impl!r}")
    B, H, Tq, Tk, D = _geometry(q, k, layout)
    s = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    if mask is not None and not _is_key_padding(mask, Tk):
        raise MXNetError(f"fused_attention: mask {tuple(mask.shape)} is "
                         "not a key-padding mask")
    bias = _key_bias(mask, B, Tk, q.device)
    p_drop = float(dropout_p)
    if p_drop > 0.0:
        if seed is None:
            raise ValueError("dropout_p > 0 requires seed words")
        seed = torch.as_tensor(seed, dtype=torch.int32, device=q.device)
    else:
        seed = torch.zeros(2, dtype=torch.int32, device=q.device)
    if not _use_kernel(impl, q):
        return _fused_reference(q, k, v, bias, seed, s, p_drop,
                                bool(causal), layout)
    _check_kernel_args(q, k, v, bias, seed, layout)
    return _FusedAttention.apply(q, k, v, bias, seed, s, p_drop,
                                 bool(causal), layout)
