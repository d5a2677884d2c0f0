"""Ragged paged attention: the serving engine's attention over KV pages.

Counterpart of the ragged half of mxnet_tpu/ops/pallas_attention.py.
Two functions, each with a hand-written CUDA kernel
(`csrc/ragged_attention.cu`) and a plain PyTorch version of the same
math in this module:

  * ragged_span_attention   — up to Sq query rows per slot, q_counts[b]
    of them live (decode 1, prefill chunk C, idle 0). Replaces the
    Pallas `_ragged_span_kernel`. Every engine dispatch runs it.
  * ragged_decode_attention — one query row per slot. Replaces the
    Pallas `_ragged_decode_kernel`.

impl="auto" takes the plain version for a tensor on the CPU and the
kernel for a tensor on a CUDA card; a call the kernel cannot take
raises there — there is no fallback from kernel to plain version.
impl="torch" takes the plain version on any device (the reference the
kernels are held to on the card).

Every kernel launch adds one to LAUNCHES[<function name>]; nothing else
touches the counts.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..base import MXNetError
from . import _build

__all__ = ["ragged_span_attention", "ragged_decode_attention",
           "ragged_supported", "LAUNCHES", "reset_launches", "NEG_INF"]

NEG_INF = -1e30

# launches of each kernel since the last reset_launches()
LAUNCHES = {"ragged_span_attention": 0, "ragged_decode_attention": 0}

# mirrors of the kernel's compile-time constants (csrc/ragged_attention.cu)
_MAX_D = 128
_SPAN_ROWS = 16
_DEC_WARPS = 4
_MAX_SMEM = 232448          # bytes of shared memory a Hopper block may use
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_IMPLS = ("auto", "torch")


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _span_smem(D, S):
    return 4 * (_SPAN_ROWS * D + S * (D + 1) + S * D + _SPAN_ROWS * S)


def _decode_smem(D, S):
    return 4 * (D + S * (D + 1) + S * D + S + _DEC_WARPS)


def ragged_supported(q, k_pages):
    """Can the CUDA kernels take this call? q (B, H, D) or (B, Sq, H, D)
    and one layer's pool (N, S, H, D): float32 or bfloat16, the pool in
    q's dtype, head dim at most 128, and the per-page staging within a
    Hopper block's shared memory."""
    D, S = q.shape[-1], k_pages.shape[1]
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype:
        return False
    if not 1 <= D <= _MAX_D or S < 1:
        return False
    return max(_span_smem(D, S), _decode_smem(D, S)) <= _MAX_SMEM


# ---------------------------------------------------------------------------
# plain versions (ports of _ragged_reference / _ragged_mq_reference /
# _ragged_span_reference): gather the whole per-slot view through the
# table, mask, softmax in f32
# ---------------------------------------------------------------------------

def _gather_view(pages, page_table):
    g = pages[page_table.long()]                       # (B, P, S, H, D)
    B, P, S = g.shape[:3]
    return g.reshape(B, P * S, *g.shape[3:])           # (B, T, H, D)


def _masked_softmax(s, mask):
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    # fully masked rows (m == NEG_INF) contribute zeros, not exp(0)
    e = torch.where(m <= NEG_INF / 2, torch.zeros_like(s), torch.exp(s - m))
    return e / e.sum(dim=-1, keepdim=True).clamp_min(1e-30)


def _ragged_reference(q, k_pages, v_pages, page_table, lengths, scale):
    """Plain version of the decode kernel: q (B, H, D) -> (B, H, D)."""
    k = _gather_view(k_pages, page_table).float()
    v = _gather_view(v_pages, page_table).float()
    T = k.shape[1]
    s = torch.einsum("bhd,bthd->bht", q.float(), k) * scale
    pos = torch.arange(T, device=q.device)
    mask = (pos[None, :] < lengths[:, None])[:, None, :]
    w = _masked_softmax(s, mask)
    return torch.einsum("bht,bthd->bhd", w, v).to(q.dtype)


def _ragged_mq_reference(q, k_pages, v_pages, page_table, lengths, scale):
    """Every query row live: row j of slot b attends keys < lengths[b]+j.
    q (B, Sq, H, D) -> (B, Sq, H, D)."""
    Sq = q.shape[1]
    k = _gather_view(k_pages, page_table).float()
    v = _gather_view(v_pages, page_table).float()
    T = k.shape[1]
    s = torch.einsum("bjhd,bthd->bjht", q.float(), k) * scale
    limit = lengths[:, None] + torch.arange(Sq, device=q.device)[None, :]
    pos = torch.arange(T, device=q.device)
    mask = (pos[None, None, :] < limit[:, :, None])[:, :, None, :]
    w = _masked_softmax(s, mask)
    return torch.einsum("bjht,bthd->bjhd", w, v).to(q.dtype)


def _ragged_span_reference(q, k_pages, v_pages, page_table, lengths,
                           q_counts, scale):
    """Plain version of the span kernel: the multi-query math with rows
    >= q_counts[b] dead (exact zeros)."""
    out = _ragged_mq_reference(q, k_pages, v_pages, page_table, lengths,
                               scale)
    rows = torch.arange(q.shape[1], device=q.device)[None, :] \
        < q_counts[:, None]
    return torch.where(rows[:, :, None, None], out, torch.zeros_like(out))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _lib():
    lib = _build.load("ragged_attention")
    if not getattr(lib, "_mxt_bound", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.mxt_ragged_span.argtypes = [ptr] * 7 + [i32] * 6 + [
            ctypes.c_float, i32, ptr]
        lib.mxt_ragged_span.restype = i32
        lib.mxt_ragged_decode.argtypes = [ptr] * 6 + [i32] * 5 + [
            ctypes.c_float, i32, ptr]
        lib.mxt_ragged_decode.restype = i32
        lib._mxt_bound = True
    return lib


def _check_kernel_args(name, q, k_pages, v_pages, ints):
    tensors = (q, k_pages, v_pages) + tuple(ints.values())
    if any(t.device != q.device for t in tensors):
        raise MXNetError(f"{name}: every tensor must be on {q.device}")
    if not ragged_supported(q, k_pages) or v_pages.dtype != q.dtype \
            or v_pages.shape != k_pages.shape:
        raise MXNetError(
            f"{name}: the CUDA kernel does not take q {tuple(q.shape)} "
            f"{q.dtype} over pages {tuple(k_pages.shape)} "
            f"{k_pages.dtype}/{v_pages.dtype}")
    if k_pages.shape[2:] != q.shape[-2:]:
        raise MXNetError(f"{name}: pages {tuple(k_pages.shape)} do not "
                         f"match q's heads {tuple(q.shape[-2:])}")
    for label, t in ints.items():
        if t.dtype != torch.int32:
            raise MXNetError(f"{name}: {label} must be int32, got {t.dtype}")
        if t.dim() != (2 if label == "page_table" else 1) \
                or t.shape[0] != q.shape[0]:
            raise MXNetError(f"{name}: {label} {tuple(t.shape)} does not "
                             f"match batch {q.shape[0]}")
    for t in tensors:
        if not t.is_contiguous():
            raise MXNetError(f"{name}: the kernel needs contiguous tensors")


def _use_kernel(impl, q):
    if impl not in _IMPLS:
        raise ValueError(f"unknown ragged attention impl {impl!r}")
    return impl == "auto" and q.is_cuda


def ragged_span_attention(q, k_pages, v_pages, page_table, lengths,
                          q_counts=None, scale=None, impl="auto"):
    """Span ragged paged attention: one fixed-shape call for mixed
    prefill-chunk / decode / idle rows.

    q:               (B, Sq, H, D), already written to the cache at
                     positions lengths-1 .. lengths+q_counts-2.
    k_pages/v_pages: (N, S, H, D), ONE layer's pools, q's dtype.
    page_table:      (B, P) int32, physical pages per slot; entries must
                     lie in [0, N) (the kernel reads them unchecked —
                     PagedKVCache.create and the engine's PagePool
                     guarantee it).
    lengths:         (B,) int32, live keys through query 0 (its own
                     position included); query j attends keys
                     < lengths[b] + j.
    q_counts:        (B,) int32, live query rows per slot; rows past the
                     count are exact zeros. None means every row is live.
    Returns (B, Sq, H, D) in q's dtype.
    """
    name = "ragged_span_attention"
    B, Sq, H, D = q.shape
    s = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    if q_counts is None:
        q_counts = torch.full((B,), Sq, dtype=torch.int32, device=q.device)
    if not _use_kernel(impl, q):
        return _ragged_span_reference(q, k_pages, v_pages, page_table,
                                      lengths, q_counts, s)
    _check_kernel_args(name, q, k_pages, v_pages,
                       {"page_table": page_table, "lengths": lengths,
                        "q_counts": q_counts})
    S, P = k_pages.shape[1], page_table.shape[1]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _lib().mxt_ragged_span(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), lengths.data_ptr(), q_counts.data_ptr(),
            out.data_ptr(), B, Sq, H, D, S, P, s, _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise MXNetError(f"{name}: kernel launch failed (cudaError {err})")
    LAUNCHES[name] += 1
    return out


def ragged_decode_attention(q, k_pages, v_pages, page_table, lengths,
                            scale=None, impl="auto"):
    """Ragged paged attention for one query row per slot.

    q:               (B, H, D), the current token's query per slot.
    k_pages/v_pages: (N, S, H, D), ONE layer's pools, q's dtype.
    page_table:      (B, P) int32, entries in [0, N) as above.
    lengths:         (B,) int32, live keys per slot including the token
                     just written; a slot with length 0 yields zeros.
    Returns (B, H, D) in q's dtype.
    """
    name = "ragged_decode_attention"
    B, H, D = q.shape
    s = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    if not _use_kernel(impl, q):
        return _ragged_reference(q, k_pages, v_pages, page_table, lengths,
                                 s)
    _check_kernel_args(name, q, k_pages, v_pages,
                       {"page_table": page_table, "lengths": lengths})
    S, P = k_pages.shape[1], page_table.shape[1]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _lib().mxt_ragged_decode(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            B, H, D, S, P, s, _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise MXNetError(f"{name}: kernel launch failed (cudaError {err})")
    LAUNCHES[name] += 1
    return out
