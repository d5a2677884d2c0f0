"""Ragged paged attention: the serving engine's attention over KV pages.

Counterpart of the ragged half of mxnet_tpu/ops/pallas_attention.py.
Two functions, with hand-written CUDA kernels and a plain PyTorch
version of the same math in this module:

  * ragged_span_attention   — up to Sq query rows per slot, q_counts[b]
    of them live (decode 1, prefill chunk C, idle 0). Over float pools
    it replaces the Pallas `_ragged_span_kernel`; over int8 pools with
    per-(page, head) float32 scales (k_scale=, v_scale=) it replaces
    `_ragged_span_quant_kernel`. Every engine dispatch runs one of them.
    Two kernel families, chosen per call by `span_route` before
    anything is launched:
      - "tensor_core" (`csrc/ragged_attention_tc.cu`, wgmma): bfloat16 q
        over bfloat16 or int8 pages, D % 8 == 0, S % 16 == 0 and
        S <= 256, 16-byte aligned bases;
      - "cuda_core" (`csrc/ragged_attention.cu`, float32 FMAs): float32
        q, and the bfloat16 calls the rule refuses.
    Both split a slot's pages over several blocks when the grid would
    otherwise leave SMs idle (`span_split_plan`, static shapes only)
    and combine the splits' partials in split order inside the same
    launch.
  * ragged_decode_attention — one query row per slot, float pools
    (`csrc/ragged_attention.cu`). Replaces the Pallas
    `_ragged_decode_kernel`. It splits a slot's pages over blocks by
    `decode_split_plan` (static shapes only) and combines the splits'
    partials as the span kernels do.

impl="auto" takes the plain version for a tensor on the CPU and the
kernel for a tensor on a CUDA card; a call the kernel cannot take
raises there — there is no fallback from kernel to plain version.
impl="torch" takes the plain version on any device (the reference the
kernels are held to on the card).

Every kernel launch adds one to LAUNCHES[<key>]: the span kernels count
under "ragged_span_attention" + "_int8" for int8 pages + "_tc" on the
tensor-core route, the decode kernel under "ragged_decode_attention";
nothing else touches the counts.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..base import MXNetError
from . import _build

__all__ = ["ragged_span_attention", "ragged_decode_attention",
           "ragged_supported", "span_route", "span_split_plan",
           "decode_split_plan", "span_launch_key", "LAUNCHES",
           "reset_launches", "NEG_INF"]

NEG_INF = -1e30

# launches of each kernel since the last reset_launches()
LAUNCHES = {"ragged_span_attention": 0, "ragged_span_attention_int8": 0,
            "ragged_span_attention_tc": 0,
            "ragged_span_attention_int8_tc": 0,
            "ragged_decode_attention": 0}

# mirrors of the kernels' compile-time constants (csrc/span_split.cuh,
# csrc/ragged_attention.cu, csrc/ragged_attention_tc.cu)
_MAX_D = 128
_SPAN_TILE = 64             # query rows of a span block
_MAX_SPLITS = 16            # page splits of a query tile at most
# the split plan's target, in blocks an SM: unsplit, a block walks its
# (slot, head)'s pages in series. At the 774M kernel cell four blocks
# an SM beat two by 10-20% on every span kernel, and the two tie at the
# serve's decode cell (PERF.md section 6)
_BLOCKS_PER_SM = 4
_TC_STAGES = 3              # key tiles in flight on the tensor-core route
_TC_MAX_S = 256             # page sizes the tensor-core route takes
_DEC_WARPS = 4
_DEC_CHUNK = 32             # keys of a decode ring slot, one a lane
_DEC_RING_BYTES = 73728     # a decode ring of 8 slots at most
# the decode plan's target, in blocks an SM: a decode block holds one
# row, so its splits are short (PERF.md section 6)
_DEC_BLOCKS_PER_SM = 16
_MAX_SMEM = 232448          # bytes of shared memory a Hopper block may use
# span_combine's static shared memory: the split weights and a flag
_STATIC_SMEM = 4 * _MAX_SPLITS * _SPAN_TILE + 16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_IMPLS = ("auto", "torch")


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _k_stride(row_bytes):
    """ragged_attention.cu k_stride: an odd count of 16-byte words."""
    return 16 * ((-(-row_bytes // 16) + 1) | 1)


def _span_smem(D, S, itemsize, stages):
    """ragged_attention.cu span_smem_bytes: q as f32, each row's m, l
    and alpha, `stages` K and V page stages in the pools' dtype, the
    probabilities as f32."""
    row = D * itemsize
    return 4 * _SPAN_TILE * (((D + 3) & ~3) + 3) \
        + stages * S * (_k_stride(row) + -(-row // 16) * 16) \
        + 4 * _SPAN_TILE * S


def _tc_smem(D, quant):
    """ragged_attention_tc.cu tc_smem_bytes: the Q tile and the key ring
    (bfloat16 tiles; or int8 codes, their scales and one widened K and V
    tile), with 1024 bytes of alignment slack."""
    dp = 64 if D <= 64 else 128
    tile = _SPAN_TILE * dp * 2
    ring = 2 * tile + _TC_STAGES * (tile + 2 * _SPAN_TILE * 4) if quant \
        else _TC_STAGES * 2 * tile
    return 1024 + tile + ring


def _decode_slots(D, itemsize, S, pps):
    """ragged_attention.cu decode_slots: the chunk slots of a decode
    block's ring — every 32-key chunk of a split of `pps` pages where 8
    slots fit in _DEC_RING_BYTES, else at most 4."""
    row = D * itemsize
    slot = _DEC_CHUNK * (_k_stride(row) + -(-row // 16) * 16)
    cap = 8 if 8 * slot <= _DEC_RING_BYTES else _DEC_WARPS
    return min(-(-pps * S // _DEC_CHUNK), cap)


def _decode_smem(D, itemsize, nc):
    """ragged_attention.cu decode_smem_bytes: q as f32, `nc` chunk
    slots of K and V rows in the pools' dtype, the warps' m, l and
    accumulators."""
    row = D * itemsize
    return 4 * ((D + 3) & ~3) \
        + nc * _DEC_CHUNK * (_k_stride(row) + -(-row // 16) * 16) \
        + 4 * _DEC_WARPS * (2 + D)


def span_route(q, k_pages, v_pages=None):
    """The span kernel family a CUDA call with these tensors takes,
    decided before any launch: "tensor_core" for bfloat16 q over
    bfloat16 or int8 pages with a head dim that is a multiple of 8 (the
    16-byte and 8-byte async copies), a page size that is a multiple of
    16 up to 256, every base 16-byte aligned and the staging within a
    block's shared memory; "cuda_core" for everything else."""
    D, S = q.shape[-1], k_pages.shape[1]
    quant = k_pages.dtype == torch.int8
    bases = (q, k_pages) + (() if v_pages is None else (v_pages,))
    if q.dtype == torch.bfloat16 \
            and k_pages.dtype in (torch.bfloat16, torch.int8) \
            and D % 8 == 0 and D <= _MAX_D \
            and S % 16 == 0 and S <= _TC_MAX_S \
            and all(t.data_ptr() % 16 == 0 for t in bases) \
            and _tc_smem(D, quant) + _STATIC_SMEM <= _MAX_SMEM:
        return "tensor_core"
    return "cuda_core"


def span_launch_key(route, quant):
    """The LAUNCHES key of a span launch on `route` over int8 (`quant`)
    or float pages."""
    return "ragged_span_attention" + ("_int8" if quant else "") \
        + ("_tc" if route == "tensor_core" else "")


def span_split_plan(B, H, Sq, P, sms):
    """How many page splits a span launch takes, from static shapes only
    (no device value is read, so no sync): enough that the grid puts
    about _BLOCKS_PER_SM blocks on each of the card's `sms` SMs, never
    fewer than two pages a split and at most _MAX_SPLITS; no split left
    empty."""
    if not all(type(x) is int for x in (B, H, Sq, P, sms)):
        raise TypeError("span_split_plan takes static shapes (int), "
                        "never a tensor")
    tiles = B * H * -(-Sq // _SPAN_TILE)
    if tiles == 0 or P < 2:
        return 1
    n = max(1, min(-(-_BLOCKS_PER_SM * sms // tiles), P // 2, _MAX_SPLITS))
    pps = -(-P // n)
    return -(-P // pps)


def decode_split_plan(B, H, P, sms):
    """How many page splits a decode launch takes, from static shapes
    only: enough that the grid puts about _DEC_BLOCKS_PER_SM blocks on
    each of the card's `sms` SMs, at least one page a split and at most
    _MAX_SPLITS; no split left empty."""
    if not all(type(x) is int for x in (B, H, P, sms)):
        raise TypeError("decode_split_plan takes static shapes (int), "
                        "never a tensor")
    if B * H == 0 or P < 2:
        return 1
    n = max(1, min(-(-_DEC_BLOCKS_PER_SM * sms // (B * H)), P, _MAX_SPLITS))
    pps = -(-P // n)
    return -(-P // pps)


def ragged_supported(q, k_pages, v_pages=None):
    """Can the CUDA kernels take this call? q (B, H, D) or (B, Sq, H, D)
    and one layer's pools (N, S, H, D): q float32 or bfloat16, the pools
    in q's dtype or int8 (the span kernels with scales), k and v alike,
    head dim at most 128, and the staging of the span route's kernel
    (and, for float pools, the decode kernel's) within a Hopper block's
    shared memory."""
    D, S = q.shape[-1], k_pages.shape[1]
    if q.dtype not in _DTYPES or k_pages.dtype not in (q.dtype, torch.int8):
        return False
    if v_pages is not None and v_pages.dtype != k_pages.dtype:
        return False
    if not 1 <= D <= _MAX_D or S < 1:
        return False
    # the CUDA-core kernel stages pages twice where that fits, else once
    if span_route(q, k_pages, v_pages) == "cuda_core" and \
            _span_smem(D, S, k_pages.element_size(), 1) + _STATIC_SMEM \
            > _MAX_SMEM:
        return False
    # the decode kernel at its largest ring: a split of 256 pages holds
    # at least 8 chunks of 32 keys whatever the page size
    item = k_pages.element_size()
    return k_pages.dtype == torch.int8 or _decode_smem(
        D, item, _decode_slots(D, item, S, 8 * _DEC_CHUNK)) \
        + _STATIC_SMEM <= _MAX_SMEM


# ---------------------------------------------------------------------------
# plain versions (ports of _ragged_reference / _ragged_mq_reference /
# _ragged_span_reference): gather the whole per-slot view through the
# table (int8 pools: widened to f32 and multiplied by each page's
# per-head scale), mask, softmax in f32
# ---------------------------------------------------------------------------

def _gather_view(pages, page_table, scale=None):
    tbl = page_table.long()
    g = pages[tbl]                                     # (B, P, S, H, D)
    if scale is not None:
        g = g.float() * scale[tbl][:, :, None, :, None]
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


def _ragged_mq_reference(q, k_pages, v_pages, page_table, lengths, scale,
                         k_scale=None, v_scale=None):
    """Every query row live: row j of slot b attends keys < lengths[b]+j.
    q (B, Sq, H, D) -> (B, Sq, H, D). With k_scale/v_scale (N, H) the
    pools are int8 codes, dequantized on the gathered view."""
    Sq = q.shape[1]
    k = _gather_view(k_pages, page_table, k_scale).float()
    v = _gather_view(v_pages, page_table, v_scale).float()
    T = k.shape[1]
    s = torch.einsum("bjhd,bthd->bjht", q.float(), k) * scale
    limit = lengths[:, None] + torch.arange(Sq, device=q.device)[None, :]
    pos = torch.arange(T, device=q.device)
    mask = (pos[None, None, :] < limit[:, :, None])[:, :, None, :]
    w = _masked_softmax(s, mask)
    return torch.einsum("bjht,bthd->bjhd", w, v).to(q.dtype)


def _ragged_span_reference(q, k_pages, v_pages, page_table, lengths,
                           q_counts, scale, k_scale=None, v_scale=None):
    """Plain version of the span kernels: the multi-query math with rows
    >= q_counts[b] dead (exact zeros)."""
    out = _ragged_mq_reference(q, k_pages, v_pages, page_table, lengths,
                               scale, k_scale, v_scale)
    rows = torch.arange(q.shape[1], device=q.device)[None, :] \
        < q_counts[:, None]
    return torch.where(rows[:, :, None, None], out, torch.zeros_like(out))


def _ragged_span_split_reference(q, k_pages, v_pages, page_table, lengths,
                                 q_counts, scale, n_split, k_scale=None,
                                 v_scale=None):
    """Plain version of the span kernels' split over pages
    (csrc/span_split.cuh): for each (slot, 64-row query tile), the key
    range that its last live row sees is cut into page splits of
    ceil(P / n_split) pages; each split with live keys forms float32
    partials (running max m, denominator l, unnormalised accumulator)
    over its keys alone, and the partials are combined in split order.
    Equal to _ragged_span_reference up to float32 rounding."""
    B, Sq, H, D = q.shape
    S, P = k_pages.shape[1], page_table.shape[1]
    k = _gather_view(k_pages, page_table, k_scale).float()
    v = _gather_view(v_pages, page_table, v_scale).float()
    s = torch.einsum("bjhd,bthd->bjht", q.float(), k) * scale
    pos = torch.arange(P * S, device=q.device)
    out = torch.zeros(B, Sq, H, D, dtype=torch.float32, device=q.device)
    span = -(-P // n_split) * S                      # keys of a split
    for b in range(B):
        length, qc = int(lengths[b]), int(q_counts[b])
        for row0 in range(0, Sq, _SPAN_TILE):
            row_end = min(row0 + _SPAN_TILE, qc, Sq)
            if row_end <= row0:
                continue                             # dead tile: zeros
            kmax = min(max(length + row_end - 1, 0), P * S)
            rows = torch.arange(row0, row_end, device=q.device)
            see = pos[None, :] < (length + rows)[:, None]        # (R, T)
            parts = []
            for k0 in range(0, kmax, span):
                keys = see & (pos >= k0) & (pos < min(k0 + span, kmax))
                x = torch.where(keys[:, None, :], s[b, row0:row_end],
                                torch.full_like(s[b, row0:row_end], NEG_INF))
                m = x.amax(dim=-1)                                # (R, H)
                e = torch.where(m[..., None] <= NEG_INF / 2,
                                torch.zeros_like(x),
                                torch.exp(x - m[..., None]))
                parts.append((m, e.sum(dim=-1),
                              torch.einsum("rht,thd->rhd", e, v[b])))
            if not parts:
                continue                             # no key: zeros
            M = torch.stack([m for m, _, _ in parts]).amax(dim=0)
            L = torch.zeros_like(M)
            A = torch.zeros(row_end - row0, H, D, device=q.device)
            for m, l, a in parts:
                wt = torch.where(m <= NEG_INF / 2, torch.zeros_like(m),
                                 torch.exp(m - M))
                L = L + wt * l
                A = A + wt[..., None] * a
            out[b, row0:row_end] = A / L.clamp_min(1e-30)[..., None]
    return out.to(q.dtype)


def _ragged_decode_split_reference(q, k_pages, v_pages, page_table,
                                   lengths, scale, n_split):
    """Plain version of the decode kernel's split over pages: the span
    kernels' split (`_ragged_span_split_reference`) at Sq = 1 with one
    live row a slot — splits of ceil(P / n_split) pages, each with float32
    partials over its keys alone, combined in split order. q (B, H, D)
    -> (B, H, D); equal to _ragged_reference up to float32 rounding."""
    ones = torch.ones(q.shape[0], dtype=torch.int32, device=q.device)
    return _ragged_span_split_reference(q[:, None], k_pages, v_pages,
                                        page_table, lengths, ones, scale,
                                        n_split)[:, 0]


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_SPAN_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _lib():
    lib = _build.load("ragged_attention")
    if not getattr(lib, "_mxt_bound", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.mxt_ragged_span.argtypes = _SPAN_ARGTYPES
        lib.mxt_ragged_span.restype = i32
        lib.mxt_ragged_decode.argtypes = [ptr] * 9 + [i32] * 6 + [
            ctypes.c_float, i32, ptr]
        lib.mxt_ragged_decode.restype = i32
        lib._mxt_bound = True
    return lib


def _tc_lib():
    lib = _build.load("ragged_attention_tc")
    if not getattr(lib, "_mxt_bound", False):
        lib.mxt_ragged_span_tc.argtypes = _SPAN_ARGTYPES
        lib.mxt_ragged_span_tc.restype = ctypes.c_int
        lib._mxt_bound = True
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


# per (device, stream): the split counters, zero between launches (the
# last split of each tile resets its own); a launch uses the first
# `tiles` of them
_COUNTERS = {}


def _counters(device, tiles):
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    c = _COUNTERS.get(key)
    if c is None or c.numel() < tiles:
        c = torch.zeros(max(tiles, 2 * (0 if c is None else c.numel())),
                        dtype=torch.int32, device=device)
        _COUNTERS[key] = c
    return c


def _check_kernel_args(name, q, k_pages, v_pages, ints, scales=()):
    """Refuse, before a launch, what the kernel does not take. `scales`
    is (k_scale, v_scale) for int8 pools, () for float pools."""
    tensors = (q, k_pages, v_pages) + tuple(ints.values()) + tuple(scales)
    if any(t.device != q.device for t in tensors):
        raise MXNetError(f"{name}: every tensor must be on {q.device}")
    want = torch.int8 if scales else q.dtype
    if not ragged_supported(q, k_pages, v_pages) \
            or k_pages.dtype != want or v_pages.shape != k_pages.shape:
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
    for label, t in zip(("k_scale", "v_scale"), scales):
        # one f32 per (page, head); rows past N (the cache's trash page)
        # are allowed and never read
        if t.dtype != torch.float32 or t.dim() != 2 \
                or t.shape[0] < k_pages.shape[0] \
                or t.shape[1] != k_pages.shape[2]:
            raise MXNetError(
                f"{name}: {label} must be float32 (>= {k_pages.shape[0]}, "
                f"{k_pages.shape[2]}), got {tuple(t.shape)} {t.dtype}")
    for t in tensors:
        if not t.is_contiguous():
            raise MXNetError(f"{name}: the kernel needs contiguous tensors")


def _use_kernel(impl, q):
    if impl not in _IMPLS:
        raise ValueError(f"unknown ragged attention impl {impl!r}")
    return impl == "auto" and q.is_cuda


def ragged_span_attention(q, k_pages, v_pages, page_table, lengths,
                          q_counts=None, scale=None, impl="auto",
                          k_scale=None, v_scale=None):
    """Span ragged paged attention: one fixed-shape call for mixed
    prefill-chunk / decode / idle rows.

    q:               (B, Sq, H, D), already written to the cache at
                     positions lengths-1 .. lengths+q_counts-2.
    k_pages/v_pages: (N, S, H, D), ONE layer's pools, q's dtype (or int8
                     with k_scale/v_scale).
    page_table:      (B, P) int32, physical pages per slot; entries must
                     lie in [0, N) (the kernel reads them unchecked —
                     PagedKVCache.create and the engine's PagePool
                     guarantee it).
    lengths:         (B,) int32, live keys through query 0 (its own
                     position included); query j attends keys
                     < lengths[b] + j.
    q_counts:        (B,) int32, live query rows per slot; rows past the
                     count are exact zeros. None means every row is live.
    k_scale/v_scale: (>= N, H) float32, per-(page, head) dequant scales of
                     int8 pools; both or neither. With them q keeps its
                     own dtype (float32 or bfloat16) and the scales are
                     applied where each page is read.
    Returns (B, Sq, H, D) in q's dtype.
    """
    name = "ragged_span_attention"
    B, Sq, H, D = q.shape
    s = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    if (k_scale is None) != (v_scale is None):
        raise MXNetError(f"{name}: pass both k_scale and v_scale or neither")
    quant = k_scale is not None
    if (k_pages.dtype == torch.int8) != quant:
        raise MXNetError(f"{name}: int8 pools need k_scale and v_scale; "
                         f"{k_pages.dtype} pools take none")
    if q_counts is None:
        q_counts = torch.full((B,), Sq, dtype=torch.int32, device=q.device)
    if not _use_kernel(impl, q):
        return _ragged_span_reference(q, k_pages, v_pages, page_table,
                                      lengths, q_counts, s, k_scale,
                                      v_scale)
    _check_kernel_args(name, q, k_pages, v_pages,
                       {"page_table": page_table, "lengths": lengths,
                        "q_counts": q_counts},
                       (k_scale, v_scale) if quant else ())
    route = span_route(q, k_pages, v_pages)
    S, P = k_pages.shape[1], page_table.shape[1]
    n_split = span_split_plan(B, H, Sq, P, _sm_count(q.device.index))
    out = torch.empty_like(q)
    part = ml = counters = None
    if n_split > 1:
        tiles = B * H * -(-Sq // _SPAN_TILE)
        rows = tiles * n_split * _SPAN_TILE
        part = torch.empty(rows * D, dtype=torch.float32, device=q.device)
        ml = torch.empty(rows * 2, dtype=torch.float32, device=q.device)
        counters = _counters(q.device, tiles)

    def ptr(t):
        return None if t is None else t.data_ptr()
    with torch.cuda.device(q.device):
        fn = _tc_lib().mxt_ragged_span_tc if route == "tensor_core" \
            else _lib().mxt_ragged_span
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 ptr(k_scale), ptr(v_scale), page_table.data_ptr(),
                 lengths.data_ptr(), q_counts.data_ptr(), out.data_ptr(),
                 ptr(part), ptr(ml), ptr(counters), B, Sq, H, D, S, P,
                 n_split, s, _DTYPES[q.dtype], int(quant),
                 torch.cuda.current_stream(q.device).cuda_stream)
    key = span_launch_key(route, quant)
    if err:
        raise MXNetError(f"{key}: kernel launch failed (cudaError {err})")
    LAUNCHES[key] += 1
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
    n_split = decode_split_plan(B, H, P, _sm_count(q.device.index))
    out = torch.empty_like(q)
    part = ml = counters = None
    if n_split > 1:
        rows = B * H * n_split
        part = torch.empty(rows * D, dtype=torch.float32, device=q.device)
        ml = torch.empty(rows * 2, dtype=torch.float32, device=q.device)
        counters = _counters(q.device, B * H)

    def ptr(t):
        return None if t is None else t.data_ptr()
    with torch.cuda.device(q.device):
        err = _lib().mxt_ragged_decode(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            ptr(part), ptr(ml), ptr(counters), B, H, D, S, P, n_split, s,
            _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise MXNetError(f"{name}: kernel launch failed (cudaError {err})")
    LAUNCHES[name] += 1
    return out
