// Ragged paged attention for the serving engine on the CUDA cores: the
// span kernel (any number of live query rows per slot) over float32,
// bfloat16 or int8 page pools, and the single-query decode kernel over
// float pools. bfloat16 span calls that the route rule accepts run on
// the tensor cores instead (ragged_attention_tc.cu); this span kernel
// takes float32 q, and bfloat16 that the rule refuses.
//
// Replaces the Pallas TPU kernels of mxnet_tpu/ops/pallas_attention.py:
//   ragged_span_kernel<T, T>      <- _ragged_span_kernel
//                                    (ragged_span_attention)
//   ragged_span_kernel<T, int8_t> <- _ragged_span_quant_kernel
//                                    (ragged_span_attention(k_scale=,
//                                    v_scale=))
//   ragged_decode_kernel          <- _ragged_decode_kernel
//                                    (ragged_decode_attention)
//
// Layouts (all contiguous):
//   q          (B, Sq, H, D) span, (B, H, D) decode
//   k/v pages  (N, S, H, D)   one layer's page pool
//   page_table (B, P) int32   physical page of each slot's logical page
//   lengths    (B,) int32     live keys of query row 0, its own included
//   q_counts   (B,) int32     live query rows per slot (span only)
//   k/v scale  (>= N, H) f32  int8 pools only: the dequant scale of each
//                             (physical page, head); row N and beyond
//                             (the cache's trash page) are never read
//   out        like q, in q's dtype
// Query row j of slot b attends key positions < lengths[b] + j. Rows at
// or past q_counts[b] are dead and come out as exact zeros; a slot with
// q_counts 0 (span) or length 0 (decode) reads no page at all. The
// softmax runs online over the slot's pages in float32 with the
// reference's constants: masked scores are -1e30, a row whose running
// maximum is still masked contributes e = 0 (not exp(0)), and the
// denominator is clamped at 1e-30.
//
// What bounds the span kernel on an H100: bytes and latency. Each
// (slot, head) must read its live K and V pages once and does 2*D
// multiply-adds per (query row, visible key) pair: at decode (one row)
// 0.5 flop per byte of f32 K/V, at a 64-row prefill chunk about 32,
// both far below the card's ~295 flop/byte ridge. float32 is held to
// 1e-5 absolute, which TF32 cannot meet, so the products stay on float32
// FMAs. Design:
//   * one block (8 warps) per (slot, head, 64-row query tile, page
//     split): each live page is read once per 64-row chunk, and its
//     scores, softmax and P.V run as block-wide passes over the live
//     rows only, so that one live row (a decode dispatch) spreads over
//     the block as 64 do;
//   * pages are staged by cp.async in 16-byte copies (8 or 4 where the
//     row's bytes or the pool's base allow no more; element copies only
//     for rows of a size 4 bytes do not divide), double-buffered: page
//     p + 1 is in flight while page p is multiplied. Each thread copies
//     one fixed column of rows t / cpr + k * rpp, so the copy loop has no
//     division; K rows are padded to an odd count of 16-byte words so
//     that the lanes' 16-byte reads of different keys miss each other's
//     banks;
//   * the split over pages, its partials and their combine are
//     span_split.cuh's, shared with the tensor-core kernel.
// int8 pools: the codes are staged at one byte an element and stay
// codes in shared memory; each is widened to f32 times its (page, head)
// scale where the products read it, the plain version's dequantized
// value bit for bit, and the products keep the float kernel's order of
// operations: float32 streams on int8 pages are compared token for token
// with the plain path's, and int8 codes written later amplify any
// difference in rounding. The scales are looked up through the page
// table (the physical page), as the Pallas kernel does with its remapped
// page index. q keeps its own dtype; it is never cast to the pool's.
//
// The decode kernel (one block per (slot, head)) stages each page
// widened to float32 and runs the same online softmax.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>
#include <type_traits>

#include "span_split.cuh"
#include "wgmma.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int MAX_D = 128;                 // head dim limit

constexpr int SPAN_THREADS = 256;          // 8 warps
constexpr int SPAN_WARPS = SPAN_THREADS / 32;
constexpr int ROW_GROUP = 4;               // rows a thread multiplies at once
// rows of a thread's P.V columns: 64 / (256 / D) at D <= 128
constexpr int PV_ROWS = SPAN_TILE / (SPAN_THREADS / MAX_D);

constexpr int DEC_THREADS = 128;
constexpr int DEC_WARPS = DEC_THREADS / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared-memory bytes of a staged K row: the row rounded up to 16 bytes,
// then to an odd count of 16-byte words (lanes reading 16 bytes of
// neighbouring keys then fall in different banks). V rows are read
// along the row and need no padding.
__host__ __device__ __forceinline__ int k_stride(int row_bytes) {
  const int w = (row_bytes + 15) / 16 + 1;
  return 16 * (w | 1);
}
__host__ __device__ __forceinline__ int v_stride(int row_bytes) {
  return (row_bytes + 15) / 16 * 16;
}

// 16 bytes of a staged row as floats.
template <typename TP> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const uint8_t* p, float* x) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const uint8_t* p, float* x) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&u[i]));
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
};
template <> struct Vec<int8_t> {
  static constexpr int N = 16;
  __device__ __forceinline__ static void load(const uint8_t* p, float* x) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 16; ++i)
      x[i] = (float)(int8_t)(u[i >> 2] >> (8 * (i & 3)));
  }
};

// Copies the (S, D) slices of head h of one page of the K and V pools
// into a ring stage: thread t moves `unit` bytes at column t % cpr of
// rows t / cpr + k * rpp. unit is 16, 8 or 4 (cp.async; the caller
// commits) or the element size (plain loads, for rows of a size 4 bytes
// do not divide).
struct PageCopier {
  int unit, col, r0, rpp;
  size_t gstride;   // bytes between two rows of a page
  bool active;

  __device__ __forceinline__ PageCopier(int unit_, int row_bytes, int H) {
    unit = unit_;
    const int cpr = row_bytes / unit;
    rpp = SPAN_THREADS / cpr;
    col = (threadIdx.x % cpr) * unit;
    r0 = threadIdx.x / cpr;
    active = threadIdx.x < rpp * cpr;
    gstride = (size_t)H * row_bytes;
  }

  __device__ __forceinline__ void copy(const uint8_t* src, uint8_t* dst,
                                       int dstride, int S) const {
    if (!active) return;
    src += (size_t)r0 * gstride + col;
    dst += r0 * dstride + col;
    const uint32_t d = smem_u32(dst);
    for (int r = r0; r < S; r += rpp) {
      const uint32_t o = (uint32_t)((r - r0) * dstride);
      if (unit == 16) {
        cp_async16(d + o, src, 16);
      } else if (unit == 8) {
        cp_async8(d + o, src, 8);
      } else if (unit == 4) {
        cp_async4(d + o, src, 4);
      } else if (unit == 2) {
        *reinterpret_cast<uint16_t*>(dst + o) =
            *reinterpret_cast<const uint16_t*>(src);
      } else {
        dst[o] = *src;
      }
      src += rpp * gstride;
    }
  }
};

// One block per (slot, head, 64-row query tile, page split) of
// span_split.cuh. Each page is worked in three block-wide passes, so
// that a tile with one live row (a decode dispatch) spreads over as many
// threads as one with 64:
//   1. scores: thread t takes key t % S of rows t / S + k * (256 / S)
//      (four rows at a time, one K read for the four), each dot product
//      summed along d in order;
//   2. softmax: warp w takes rows w + 8k, lanes over keys lane + 32k,
//      the running max m, denominator l and rescale alpha of each row
//      in shared memory;
//   3. P.V: thread t takes column t % D of rows t / D + k * (256 / D),
//      summed along the keys in order, and keeps those rows' outputs in
//      registers: acc = acc * alpha + P.V.
// Every sum runs in the order of a one-warp-per-row kernel (dot
// products along d, the denominator over lanes' partial sums, P.V along
// the keys, then acc * alpha + P.V), the order the float32 streams of
// the serving path were first held to the plain path with. T is q's and
// the output's type, TP the pools' (T itself, or int8_t with scales).
template <typename T, typename TP>
__global__ void __launch_bounds__(SPAN_THREADS) ragged_span_kernel(
    const T* __restrict__ q, const TP* __restrict__ k_pages,
    const TP* __restrict__ v_pages, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ page_table,
    const int* __restrict__ lengths, const int* __restrict__ q_counts,
    T* __restrict__ out, float* __restrict__ part,
    float2* __restrict__ ml, int* __restrict__ counters, int Sq, int H,
    int D, int S, int P, int pps, int n_split, int unit, int stages,
    float scale) {
  constexpr bool QUANT = std::is_same<TP, int8_t>::value;
  constexpr int VN = Vec<TP>::N;
  SpanWork w = span_block(Sq, H);
  // the physical pages of the split's first two pages, requested before
  // the row state is known (the reads are clamped to the table; a table
  // of no page is never read)
  const int* table_b = page_table + (size_t)w.b * P;
  const int p_lo = blockIdx.y * pps;
  auto page_of = [&](int p) { return P ? table_b[min(p, P - 1)] : 0; };
  int pg_cur = page_of(p_lo), pg_nxt = page_of(p_lo + 1);
  span_live(w, lengths, q_counts, Sq, S, P, pps);
  if (w.n_live == 0) {
    // no live row sees a key: exact zeros, no page read
    if (blockIdx.y == 0) span_zero_rows(w, out, w.row0, Sq, H, D);
    return;
  }
  if ((int)blockIdx.y >= w.n_live) return;   // past the live pages

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row_bytes = D * (int)sizeof(TP);
  const int kst = k_stride(row_bytes), vst = v_stride(row_bytes);
  const int qs = (D + 3) & ~3;
  extern __shared__ __align__(16) uint8_t span_smem[];
  float* q_s = reinterpret_cast<float*>(span_smem);       // 64 x qs
  float* m_s = q_s + SPAN_TILE * qs;                       // 64
  float* l_s = m_s + SPAN_TILE;                            // 64
  float* a_s = l_s + SPAN_TILE;                            // 64
  // stages x S x kst, stages x S x vst, 64 x S
  uint8_t* k_s = reinterpret_cast<uint8_t*>(a_s + SPAN_TILE);
  uint8_t* v_s = k_s + stages * S * kst;
  float* p_s = reinterpret_cast<float*>(v_s + stages * S * vst);

  const int live = w.row_end - w.row0;   // live rows of the tile
  const int p_hi = (w.k1 + S - 1) / S;
  const PageCopier pc(unit, row_bytes, H);
  const size_t head = (size_t)w.h * row_bytes;
  // stage physical page pg into ring stage st
  auto stage = [&](int pg, int st) {
    const size_t page = (size_t)pg * S * H * row_bytes + head;
    pc.copy(reinterpret_cast<const uint8_t*>(k_pages) + page,
            k_s + st * S * kst, kst, S);
    pc.copy(reinterpret_cast<const uint8_t*>(v_pages) + page,
            v_s + st * S * vst, vst, S);
  };
  if (stages == 2) stage(pg_cur, 0);
  cp_async_commit();
  span_dead_rows(w, out, Sq, H, D);
  // int8: the scales of page p, and those of page p + 1 requested one
  // page ahead, like the table entry of page p + 2
  float kscale = 1.f, vscale = 1.f;
  if constexpr (QUANT) {
    kscale = __ldg(k_scale + (size_t)pg_cur * H + w.h);
    vscale = __ldg(v_scale + (size_t)pg_cur * H + w.h);
  }

  // q rows as f32 (dead rows 0), each warp its own rows; the row state
  for (int i = 0; i < SPAN_TILE / SPAN_WARPS; ++i) {
    const int r = warp + SPAN_WARPS * i, row = w.row0 + r;
    const T* qr = q + span_row(w, min(row, Sq - 1), Sq, H, D);
    for (int d = lane; d < qs; d += 32)
      q_s[r * qs + d] = r < live && d < D ? to_f32(qr[d]) : 0.f;
  }
  if (tid < SPAN_TILE) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  // pass 1: key kc (+ 256 k) of rows kslot + kn * i
  const int kw = min(S, SPAN_THREADS), kn = SPAN_THREADS / kw;
  const int kc = tid % kw, kslot = tid / kw;
  // pass 3: column vd of rows vslot + vn * j, j < PV_ROWS
  const int vn = SPAN_THREADS / D, vd = tid % D, vslot = tid / D;
  float acc[PV_ROWS];
#pragma unroll
  for (int j = 0; j < PV_ROWS; ++j) acc[j] = 0.f;

  for (int p = p_lo; p < p_hi; ++p) {
    // two stages: page p + 1 is copied while page p is multiplied; one
    // (a page too large to stage twice): page p is copied here
    const int st = stages == 2 ? (p - p_lo) & 1 : 0;
    __syncthreads();   // every warp is done with the stage to refill
    if (stages == 1)
      stage(pg_cur, 0);
    else if (p + 1 < p_hi)
      stage(pg_nxt, st ^ 1);
    cp_async_commit();
    const int pg_after = page_of(p + 2);
    float kscale_nxt = 1.f, vscale_nxt = 1.f;
    if constexpr (QUANT) {
      kscale_nxt = __ldg(k_scale + (size_t)pg_nxt * H + w.h);
      vscale_nxt = __ldg(v_scale + (size_t)pg_nxt * H + w.h);
    }
    if (stages == 1)
      cp_async_wait<0>();
    else
      cp_async_wait<1>();
    __syncthreads();   // page p (and at p_lo, q) is in shared memory
    const uint8_t* ks = k_s + st * S * kst;
    const uint8_t* vs = v_s + st * S * vst;
    // int8: each code is widened and scaled where it is read,
    // code * scale in f32 as the plain version's dequantized view
    const int col0 = p * S;

    // pass 1: scores (NEG_INF past the row's window) into p_s
    if (kslot < kn)
      for (int c = kc; c < S; c += SPAN_THREADS) {
        const uint8_t* kr = ks + c * kst;
        for (int r0 = kslot; r0 < live; r0 += ROW_GROUP * kn) {
          int rr[ROW_GROUP];
#pragma unroll
          for (int i = 0; i < ROW_GROUP; ++i)
            rr[i] = min(r0 + i * kn, SPAN_TILE - 1);
          float dot[ROW_GROUP] = {};
          int d = 0;
          if (D % VN == 0) {
            for (; d < D; d += VN) {
              float kv[VN];
              Vec<TP>::load(kr + d * sizeof(TP), kv);
              if constexpr (QUANT) {
#pragma unroll
                for (int e = 0; e < VN; ++e) kv[e] *= kscale;
              }
#pragma unroll
              for (int i = 0; i < ROW_GROUP; ++i) {
                const float* qr = q_s + rr[i] * qs + d;
#pragma unroll
                for (int e = 0; e < VN; e += 4) {
                  const float4 qv = *reinterpret_cast<const float4*>(qr + e);
                  dot[i] = fmaf(qv.x, kv[e], dot[i]);
                  dot[i] = fmaf(qv.y, kv[e + 1], dot[i]);
                  dot[i] = fmaf(qv.z, kv[e + 2], dot[i]);
                  dot[i] = fmaf(qv.w, kv[e + 3], dot[i]);
                }
              }
            }
          }
          for (; d < D; ++d) {
            const float kv =
                to_f32(reinterpret_cast<const TP*>(kr)[d]) * kscale;
#pragma unroll
            for (int i = 0; i < ROW_GROUP; ++i)
              dot[i] = fmaf(q_s[rr[i] * qs + d], kv, dot[i]);
          }
#pragma unroll
          for (int i = 0; i < ROW_GROUP; ++i) {
            const int r = r0 + i * kn;
            if (r >= live) break;
            const int lim = min(w.length + w.row0 + r, w.k1);
            p_s[r * S + c] = col0 + c < lim ? dot[i] * scale : NEG_INF;
          }
        }
      }
    __syncthreads();

    // pass 2: the online softmax of each live row, in place
    for (int r = warp; r < live; r += SPAN_WARPS) {
      float* pr = p_s + r * S;
      const float m_old = m_s[r], l_old = l_s[r];
      float mx = NEG_INF;
      for (int c = lane; c < S; c += 32) mx = fmaxf(mx, pr[c]);
      const float m_new = fmaxf(m_old, warp_max(mx));
      const bool masked = m_new <= NEG_INF * 0.5f;
      float sum = 0.f;
      for (int c = lane; c < S; c += 32) {
        const float e = masked ? 0.f : expf(pr[c] - m_new);
        pr[c] = e;
        sum += e;
      }
      const float alpha = masked ? 1.f : expf(m_old - m_new);
      sum = warp_sum(sum);
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_old * alpha + sum;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // pass 3: acc = acc * alpha + P.V for this thread's column and rows
    if (vslot < vn) {
      const TP* vc = reinterpret_cast<const TP*>(vs) + vd;
#pragma unroll
      for (int j0 = 0; j0 < PV_ROWS; j0 += ROW_GROUP) {
        if (vslot + j0 * vn >= live) break;
        int rr[ROW_GROUP];
#pragma unroll
        for (int i = 0; i < ROW_GROUP; ++i)
          rr[i] = min(vslot + (j0 + i) * vn, SPAN_TILE - 1);
        float pv[ROW_GROUP] = {};
        for (int c = 0; c < S; ++c) {
          const float v =
              to_f32(*reinterpret_cast<const TP*>(
                  reinterpret_cast<const uint8_t*>(vc) + c * vst)) *
              vscale;
#pragma unroll
          for (int i = 0; i < ROW_GROUP; ++i)
            pv[i] = fmaf(p_s[rr[i] * S + c], v, pv[i]);
        }
#pragma unroll
        for (int i = 0; i < ROW_GROUP; ++i)
          acc[j0 + i] = acc[j0 + i] * a_s[rr[i]] + pv[i];
      }
    }
    pg_cur = pg_nxt;
    pg_nxt = pg_after;
    kscale = kscale_nxt;
    vscale = vscale_nxt;
  }
  cp_async_wait<0>();
  __syncthreads();   // the last page's l_s

  if (w.n_live == 1) {
    // the only live split: the output itself, dead rows exact zeros
    if (vslot < vn) {
#pragma unroll
      for (int j = 0; j < PV_ROWS; ++j) {
        const int r = vslot + j * vn;
        if (r >= SPAN_TILE || w.row0 + r >= Sq) break;
        const float o =
            r < live ? acc[j] * (1.f / fmaxf(l_s[r], 1e-30f)) : 0.f;
        out[span_row(w, w.row0 + r, Sq, H, D) + vd] = span_cast<T>(o);
      }
    }
    return;
  }
  // partials of the live rows, then the combine in the last split
  const size_t p0 = part_index(w, blockIdx.y, n_split);
  if (vslot < vn) {
#pragma unroll
    for (int j = 0; j < PV_ROWS; ++j) {
      const int r = vslot + j * vn;
      if (r >= live) break;
      part[(p0 + r) * D + vd] = acc[j];
    }
  }
  if (tid < live) ml[p0 + tid] = make_float2(m_s[tid], l_s[tid]);
  if (span_arrive(w, counters))
    span_combine(w, part, ml, out, Sq, H, D, n_split);
}

// Stage one page's (S, D) slices of head h into shared memory as f32
// (the decode kernel's staging). K rows are padded to D + 1 floats so
// that lanes reading different rows at the same column hit different
// banks. Loads are scalar, so any D (40 included) needs no tail.
template <typename T>
__device__ __forceinline__ void stage_page(
    const T* __restrict__ k_pages, const T* __restrict__ v_pages,
    int page, int h, int S, int H, int D, float* k_s, float* v_s,
    int tid, int nthreads) {
  const size_t base = ((size_t)page * S * H + h) * D;
  const size_t row_stride = (size_t)H * D;
  for (int i = tid; i < S * D; i += nthreads) {
    const int s = i / D, d = i - s * D;
    const size_t g = base + (size_t)s * row_stride + d;
    k_s[s * (D + 1) + d] = to_f32(k_pages[g]);
    v_s[s * D + d] = to_f32(v_pages[g]);
  }
}

// Block-wide reduction through `red` (DEC_WARPS floats); every thread
// gets the result. Two barriers: `red` may be reused right after.
template <bool IS_MAX>
__device__ __forceinline__ float block_reduce(float v, float* red, int lane,
                                              int warp) {
  v = IS_MAX ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < DEC_WARPS; ++w) r = IS_MAX ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();
  return r;
}

// One block per (slot b, head h) for a single query row per slot.
template <typename T>
__global__ void __launch_bounds__(DEC_THREADS) ragged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ page_table,
    const int* __restrict__ lengths, T* __restrict__ out, int H, int D,
    int S, int P, float scale) {
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int length = lengths[b];

  extern __shared__ float smem[];
  float* q_s = smem;                  // D
  float* k_s = q_s + D;               // S x (D + 1)
  float* v_s = k_s + S * (D + 1);     // S x D
  float* p_s = v_s + S * D;           // S
  float* red = p_s + S;               // DEC_WARPS

  const T* qb = q + ((size_t)b * H + h) * D;
  for (int d = tid; d < D; d += DEC_THREADS) q_s[d] = to_f32(qb[d]);

  float m = NEG_INF, l = 0.f, acc = 0.f;  // acc: column d = tid
  const int n_pages = length > 0 ? min((length + S - 1) / S, P) : 0;
  const int* table_b = page_table + (size_t)b * P;

  for (int p = 0; p < n_pages; ++p) {
    __syncthreads();
    stage_page<T>(k_pages, v_pages, table_b[p], h, S, H, D, k_s, v_s, tid,
                  DEC_THREADS);
    __syncthreads();
    const int col0 = p * S;
    float mx = NEG_INF;
    for (int c = tid; c < S; c += DEC_THREADS) {
      float sc = NEG_INF;
      if (col0 + c < length) {
        const float* kr = k_s + c * (D + 1);
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(q_s[d], kr[d], dot);
        sc = dot * scale;
      }
      p_s[c] = sc;
      mx = fmaxf(mx, sc);
    }
    mx = block_reduce<true>(mx, red, lane, warp);
    const float m_new = fmaxf(m, mx);
    const bool masked = m_new <= NEG_INF * 0.5f;
    float sum = 0.f;
    for (int c = tid; c < S; c += DEC_THREADS) {
      const float e = masked ? 0.f : expf(p_s[c] - m_new);
      p_s[c] = e;
      sum += e;
    }
    sum = block_reduce<false>(sum, red, lane, warp);  // also publishes p_s
    const float alpha = masked ? 1.f : expf(m - m_new);
    l = l * alpha + sum;
    m = m_new;
    if (tid < D) {
      float pv = 0.f;
      for (int c = 0; c < S; ++c) pv = fmaf(p_s[c], v_s[c * D + tid], pv);
      acc = acc * alpha + pv;
    }
  }
  if (tid < D)
    out[((size_t)b * H + h) * D + tid] = span_cast<T>(acc / fmaxf(l, 1e-30f));
}

// Dynamic shared memory of a span block with `stages` page stages: q as
// f32, each row's m, l and alpha, the K and V stages in the pools'
// dtype, the probabilities as f32.
// Two stages where they fit beside span_combine's static weights, else
// one.
size_t span_smem_bytes(int D, int S, int itemsize, int stages) {
  const int row_bytes = D * itemsize;
  return (size_t)SPAN_TILE * (((D + 3) & ~3) + 3) * 4 +
         stages * (size_t)S * (k_stride(row_bytes) + v_stride(row_bytes)) +
         (size_t)SPAN_TILE * S * 4;
}

constexpr size_t MAX_SMEM = 232448;   // a Hopper block's shared memory
constexpr size_t STATIC_SMEM = sizeof(float) * SPAN_MAX_SPLITS * SPAN_TILE +
                               16;   // span_combine's weights and flag

size_t decode_smem_bytes(int D, int S) {
  return sizeof(float) * ((size_t)D + (size_t)S * (D + 1) + (size_t)S * D +
                          (size_t)S + DEC_WARPS);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, typename TP>
int launch_span(const void* q, const void* k_pages, const void* v_pages,
                const void* k_scale, const void* v_scale,
                const void* page_table, const void* lengths,
                const void* q_counts, void* out, void* part, void* ml,
                void* counters, int B, int Sq, int H, int D, int S, int P,
                int n_split, float scale, cudaStream_t stream) {
  if (D < 1 || D > MAX_D || S < 1 || n_split < 1 ||
      n_split > SPAN_MAX_SPLITS || (n_split > 1 && !counters))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || H == 0) return (int)cudaSuccess;
  const int stages =
      span_smem_bytes(D, S, sizeof(TP), 2) + STATIC_SMEM <= MAX_SMEM ? 2 : 1;
  const size_t smem = span_smem_bytes(D, S, sizeof(TP), stages);
  cudaError_t err = allow_smem(ragged_span_kernel<T, TP>, smem);
  if (err != cudaSuccess) return (int)err;
  // the widest copy that the row's bytes and both pools' bases allow
  const int row_bytes = D * (int)sizeof(TP);
  const uintptr_t base = reinterpret_cast<uintptr_t>(k_pages) |
                         reinterpret_cast<uintptr_t>(v_pages);
  int unit = (int)sizeof(TP);
  for (int u = 16; u >= 4; u >>= 1)
    if (row_bytes % u == 0 && base % u == 0) {
      unit = u;
      break;
    }
  const dim3 grid(B * H * ((Sq + SPAN_TILE - 1) / SPAN_TILE), n_split);
  ragged_span_kernel<T, TP><<<grid, SPAN_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const TP*>(k_pages),
      static_cast<const TP*>(v_pages), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale),
      static_cast<const int*>(page_table), static_cast<const int*>(lengths),
      static_cast<const int*>(q_counts), static_cast<T*>(out),
      static_cast<float*>(part), static_cast<float2*>(ml),
      static_cast<int*>(counters), Sq, H, D, S, P,
      (P + n_split - 1) / n_split, n_split, unit, stages, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_decode(const void* q, const void* k_pages, const void* v_pages,
                  const int* page_table, const int* lengths, void* out,
                  int B, int H, int D, int S, int P, float scale,
                  cudaStream_t stream) {
  if (D < 1 || D > DEC_THREADS || S < 1) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return (int)cudaSuccess;
  const size_t smem = decode_smem_bytes(D, S);
  cudaError_t err = allow_smem(ragged_decode_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  ragged_decode_kernel<T><<<B * H, DEC_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), page_table, lengths,
      static_cast<T*>(out), H, D, S, P, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes. dtype: 0 = float32, 1 = bfloat16.
// Each returns the cudaError_t of the launch (0 = launched). The
// shared-memory sizes above are mirrored by ops/ragged_attention.py,
// which refuses shapes whose staging does not fit.
extern "C" {

// The span kernel. quant = 1: int8 pools with (>= N, H) f32 scales,
// else pools in q's dtype (the scales null). With n_split > 1, part
// (tiles * n_split * 64 * D floats), ml (as many float2 per row) and
// counters (one int per tile, all 0, left 0) are the wrapper's scratch;
// tiles = B * H * ceil(Sq / 64).
int mxt_ragged_span(const void* q, const void* k_pages, const void* v_pages,
                    const void* k_scale, const void* v_scale,
                    const void* page_table, const void* lengths,
                    const void* q_counts, void* out, void* part, void* ml,
                    void* counters, int B, int Sq, int H, int D, int S,
                    int P, int n_split, float scale, int dtype, int quant,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MXT_SPAN(T, TP)                                                     \
  return launch_span<T, TP>(q, k_pages, v_pages, k_scale, v_scale,         \
                            page_table, lengths, q_counts, out, part, ml,  \
                            counters, B, Sq, H, D, S, P, n_split, scale, st)
  if (dtype == 0 && !quant) MXT_SPAN(float, float);
  if (dtype == 1 && !quant) MXT_SPAN(__nv_bfloat16, __nv_bfloat16);
  if (dtype == 0 && quant) MXT_SPAN(float, int8_t);
  if (dtype == 1 && quant) MXT_SPAN(__nv_bfloat16, int8_t);
#undef MXT_SPAN
  return (int)cudaErrorInvalidValue;
}

int mxt_ragged_decode(const void* q, const void* k_pages,
                      const void* v_pages, const void* page_table,
                      const void* lengths, void* out, int B, int H, int D,
                      int S, int P, float scale, int dtype, void* stream) {
  const int* tbl = static_cast<const int*>(page_table);
  const int* lens = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_decode<float>(q, k_pages, v_pages, tbl, lens, out, B, H, D,
                                S, P, scale, st);
  if (dtype == 1)
    return launch_decode<__nv_bfloat16>(q, k_pages, v_pages, tbl, lens, out,
                                        B, H, D, S, P, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
