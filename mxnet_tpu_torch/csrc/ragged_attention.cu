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
// The decode kernel: one query row per (slot, head) over float32 or
// bfloat16 pools, 0.5 flop a byte of K/V, so bytes bound it, and at the
// serve's shapes the latency of reading them: a long slot's pages read
// one after another by one block leave most of the card idle. Design:
//   * split over pages as a span call with Sq = 1 (span_split.cuh, the
//     host's decode_split_plan): a long slot's pages spread over several
//     blocks, whose float32 partials (m, l, acc) are combined in split
//     order inside the launch;
//   * 16-byte cp.async copies of the keys' K and V rows into a ring of
//     32-key chunks in the pools' dtype (no float32 re-staging), every
//     chunk of a split in flight before the first product;
//   * a chunk a warp, a key a lane: per-warp online softmax with shuffle
//     reductions, the warps merged once at the end; no block barrier per
//     page. GEMV-shaped work: CUDA cores, no tensor cores.
// It keeps P in float32 (the Pallas body rounds P to bfloat16 over
// bfloat16 pages; the XLA reference and the plain version do not), and
// its sums run in another order than the span kernel's: in float32 it
// is not bit-identical with the span kernel at Sq = 1.

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
constexpr int DEC_CHUNK = 32;              // keys of a decode chunk: a lane each
constexpr int DEC_RING_BYTES = 73728;      // a decode ring of 8 slots at most

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

// cp.async.wait_group with a count known only at run time (0..7).
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// Copies the K and V rows of keys [kc0, kc0 + 32) of head h, each row
// from the page the slot's table maps it to, into a chunk slot of the
// decode ring: thread t moves `unit` bytes at column t % cpr of rows
// t / cpr + k * rpp (cp.async for 16, 8 or 4; the caller commits; plain
// loads for rows of a size 4 bytes do not divide). Rows at or past k1
// are zero-filled, so that a masked key's V row adds 0 · 0.
struct ChunkCopier {
  int unit, col, r0, rpp;
  bool active;

  __device__ __forceinline__ ChunkCopier(int unit_, int row_bytes) {
    unit = unit_;
    const int cpr = row_bytes / unit;
    rpp = DEC_THREADS / cpr;
    col = (threadIdx.x % cpr) * unit;
    r0 = threadIdx.x / cpr;
    active = threadIdx.x < rpp * cpr;
  }

  __device__ __forceinline__ void copy(const uint8_t* pool,
                                       const int* table_b, size_t head,
                                       int kc0, int k1, int S,
                                       size_t row_pitch, uint8_t* dst,
                                       int dstride) const {
    if (!active) return;
    for (int r = r0; r < DEC_CHUNK; r += rpp) {
      const int key = kc0 + r;
      const bool in = key < k1;
      const uint8_t* src = pool;
      if (in) {
        const int p = key / S;
        src += ((size_t)table_b[p] * S + (key - p * S)) * row_pitch + head +
               col;
      }
      uint8_t* d = dst + r * dstride + col;
      const uint32_t ds = smem_u32(d);
      if (unit == 16) {
        cp_async16(ds, src, in ? 16 : 0);
      } else if (unit == 8) {
        cp_async8(ds, src, in ? 8 : 0);
      } else if (unit == 4) {
        cp_async4(ds, src, in ? 4 : 0);
      } else {
        // 2-byte elements (bfloat16 rows of an odd head dim)
        *reinterpret_cast<uint16_t*>(d) =
            in ? *reinterpret_cast<const uint16_t*>(src) : (uint16_t)0;
      }
    }
  }
};

// CW columns of a staged V row, as floats: lane l holds columns
// [l * CW, l * CW + CW) (fewer at the head dim's end).
template <typename T, int CW>
__device__ __forceinline__ void load_cols(const uint8_t* row, int c0,
                                          int D, float* x) {
  const T* e = reinterpret_cast<const T*>(row) + c0;
  if (c0 + CW <= D) {
    if constexpr (std::is_same<T, float>::value && CW == 4) {
      const float4 v = *reinterpret_cast<const float4*>(e);
      x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
      return;
    } else if constexpr (std::is_same<T, float>::value && CW == 2) {
      const float2 v = *reinterpret_cast<const float2*>(e);
      x[0] = v.x; x[1] = v.y;
      return;
    } else if constexpr (!std::is_same<T, float>::value && CW >= 2) {
#pragma unroll
      for (int i = 0; i < CW; i += 2) {
        const float2 v =
            __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(e)[i / 2]);
        x[i] = v.x;
        x[i + 1] = v.y;
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < CW; ++i) x[i] = c0 + i < D ? to_f32(e[i]) : 0.f;
}

// One query row per (slot, head), split over pages like a span call with
// Sq = 1: block (b * H + h, sp) takes the slot's keys of split sp
// (span_split.cuh; one live row, partials of one row a tile). Its keys
// go through a ring of `nc` slots of 32-key chunks; chunk j is worked by
// warp j % 4, lane i on key 32 j + i:
//   * every chunk of the split (up to the ring) is requested by cp.async
//     before the first product; a chunk's rows each find their page
//     through the table, so a chunk may span pages and a page chunks;
//   * the lane's score is q . k over the head dim in float32 (q read as
//     a broadcast from shared memory, K converted where it is read);
//   * per-warp online softmax: the warp's running max m, denominator l
//     (shuffle reductions over the chunk's 32 keys) and its accumulator
//     (lane l: columns [l CW, l CW + CW)), acc = acc * alpha + sum_i e_i
//     v_i, e_i broadcast by shuffle, in key order;
//   * one merge of the four warps' (m, l, acc) through shared memory at
//     the end, in warp order; then the output, or the split's partial
//     and span_split.cuh's combine.
// P stays in float32: e multiplies V widened to float32 (the Pallas
// body rounds e to bfloat16 over bfloat16 pages; the XLA reference and
// the plain version here do not).
template <typename T, int CW>
__global__ void __launch_bounds__(DEC_THREADS) ragged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ page_table,
    const int* __restrict__ lengths, T* __restrict__ out,
    float* __restrict__ part, float2* __restrict__ ml,
    int* __restrict__ counters, int H, int D, int S, int P, int pps,
    int n_split, int unit, int nc, float scale) {
  constexpr int VN = Vec<T>::N;
  SpanWork w = span_block(1, H);
  span_live(w, lengths[w.b], 1, 1, S, P, pps);
  if (w.n_live == 0) {
    // length 0: exact zeros, no page read
    if (blockIdx.y == 0) span_zero_rows(w, out, 0, 1, H, D);
    return;
  }
  if ((int)blockIdx.y >= w.n_live) return;   // past the live pages

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row_bytes = D * (int)sizeof(T);
  const int kst = k_stride(row_bytes), vst = v_stride(row_bytes);
  const int qs = (D + 3) & ~3;
  extern __shared__ __align__(16) uint8_t dec_smem[];
  float* q_s = reinterpret_cast<float*>(dec_smem);          // qs
  uint8_t* ring = dec_smem + qs * 4;   // nc x (32 x kst, 32 x vst)
  const int slot = DEC_CHUNK * (kst + vst);
  float* m_s = reinterpret_cast<float*>(ring + nc * slot);  // 4
  float* l_s = m_s + DEC_WARPS;                             // 4
  float* a_s = l_s + DEC_WARPS;                             // 4 x D

  const int* table_b = page_table + (size_t)w.b * P;
  const ChunkCopier cc(unit, row_bytes);
  const size_t head = (size_t)w.h * row_bytes;
  const size_t pitch = (size_t)H * row_bytes;
  const int nch = (w.k1 - w.k0 + DEC_CHUNK - 1) / DEC_CHUNK;
  auto stage = [&](int j) {
    uint8_t* dst = ring + (j % nc) * slot;
    const int kc0 = w.k0 + j * DEC_CHUNK;
    cc.copy(reinterpret_cast<const uint8_t*>(k_pages), table_b, head, kc0,
            w.k1, S, pitch, dst, kst);
    cc.copy(reinterpret_cast<const uint8_t*>(v_pages), table_b, head, kc0,
            w.k1, S, pitch, dst + DEC_CHUNK * kst, vst);
    cp_async_commit();
  };
  int issued = 0;
  for (; issued < min(nc, nch); ++issued) stage(issued);

  const T* qr = q + ((size_t)w.b * H + w.h) * D;
  for (int d = tid; d < qs; d += DEC_THREADS)
    q_s[d] = d < D ? to_f32(qr[d]) : 0.f;

  float m = NEG_INF, l = 0.f, acc[CW];
#pragma unroll
  for (int c = 0; c < CW; ++c) acc[c] = 0.f;
  const int c0 = lane * CW;

  for (int g0 = 0; g0 < nch; g0 += DEC_WARPS) {
    const int gend = min(g0 + DEC_WARPS, nch);
    cp_async_wait_upto(issued - gend);   // chunks [0, gend) have landed
    __syncthreads();
    const int j = g0 + warp;
    if (j < nch) {
      const uint8_t* ks = ring + (j % nc) * slot;
      const uint8_t* vs = ks + DEC_CHUNK * kst;
      const int kc0 = w.k0 + j * DEC_CHUNK;
      const int n = min(DEC_CHUNK, w.k1 - kc0);   // live keys of the chunk
      float sc = NEG_INF;
      if (lane < n) {
        const uint8_t* kr = ks + lane * kst;
        float dot = 0.f;
        int d = 0;
        if (D % VN == 0) {
          for (; d < D; d += VN) {
            float kv[VN];
            Vec<T>::load(kr + d * sizeof(T), kv);
#pragma unroll
            for (int e = 0; e < VN; e += 4) {
              const float4 qv = *reinterpret_cast<const float4*>(q_s + d + e);
              dot = fmaf(qv.x, kv[e], dot);
              dot = fmaf(qv.y, kv[e + 1], dot);
              dot = fmaf(qv.z, kv[e + 2], dot);
              dot = fmaf(qv.w, kv[e + 3], dot);
            }
          }
        }
        for (; d < D; ++d)
          dot = fmaf(q_s[d], to_f32(reinterpret_cast<const T*>(kr)[d]), dot);
        sc = dot * scale;
      }
      const float m_new = fmaxf(m, warp_max(sc));
      const bool masked = m_new <= NEG_INF * 0.5f;
      const float e = masked ? 0.f : expf(sc - m_new);
      const float alpha = masked ? 1.f : expf(m - m_new);
      l = l * alpha + warp_sum(e);
      m = m_new;
      float pv[CW] = {};
      for (int i = 0; i < n; ++i) {
        const float p = __shfl_sync(0xffffffffu, e, i);
        float x[CW];
        if (c0 < D) {
          load_cols<T, CW>(vs + i * vst, c0, D, x);
#pragma unroll
          for (int c = 0; c < CW; ++c) pv[c] = fmaf(p, x[c], pv[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[c] = acc[c] * alpha + pv[c];
    }
    __syncthreads();   // the group's ring slots are free
    for (; issued < min(gend + nc, nch); ++issued) stage(issued);
  }

  // merge the warps' states, in warp order
  if (lane == 0) {
    m_s[warp] = m;
    l_s[warp] = l;
  }
#pragma unroll
  for (int c = 0; c < CW; ++c)
    if (c0 + c < D) a_s[warp * D + c0 + c] = acc[c];
  __syncthreads();
  float M = NEG_INF;
#pragma unroll
  for (int i = 0; i < DEC_WARPS; ++i) M = fmaxf(M, m_s[i]);
  float L = 0.f, A = 0.f;
#pragma unroll
  for (int i = 0; i < DEC_WARPS; ++i) {
    const float e = m_s[i] <= NEG_INF * 0.5f ? 0.f : expf(m_s[i] - M);
    L += e * l_s[i];
    if (tid < D) A += e * a_s[i * D + tid];
  }
  if (w.n_live == 1) {
    // the only live split: the output itself
    if (tid < D)
      out[((size_t)w.b * H + w.h) * D + tid] =
          span_cast<T>(A * (1.f / fmaxf(L, 1e-30f)));
    return;
  }
  const size_t p0 = part_index<1>(w, blockIdx.y, n_split);
  if (tid < D) part[p0 * D + tid] = A;
  if (tid == 0) ml[p0] = make_float2(M, L);
  if (span_arrive(w, counters))
    span_combine<1>(w, part, ml, out, 1, H, D, n_split);
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

// Dynamic shared memory of a decode block with `nc` chunk slots: q as
// f32, the ring of K and V chunks in the pools' dtype, the four warps'
// m, l and accumulators.
size_t decode_smem_bytes(int D, int itemsize, int nc) {
  const int row_bytes = D * itemsize;
  return (size_t)4 * ((D + 3) & ~3) +
         (size_t)nc * DEC_CHUNK * (k_stride(row_bytes) + v_stride(row_bytes)) +
         (size_t)4 * DEC_WARPS * (2 + D);
}

// Chunk slots of a decode block whose splits hold `pps` pages of S keys:
// every chunk of a split where that fits in DEC_RING_BYTES (8 slots at
// most), else 4 (the ring then refills one group of four while the next
// group is worked).
int decode_slots(int D, int itemsize, int S, int pps) {
  const int row_bytes = D * itemsize;
  const int slot = DEC_CHUNK * (k_stride(row_bytes) + v_stride(row_bytes));
  const int need = (int)(((long long)pps * S + DEC_CHUNK - 1) / DEC_CHUNK);
  const int cap = 8 * slot <= DEC_RING_BYTES ? 8 : DEC_WARPS;
  return need < cap ? need : cap;
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

template <typename T, int CW>
int launch_decode_cw(const void* q, const void* k_pages, const void* v_pages,
                     const int* page_table, const int* lengths, void* out,
                     void* part, void* ml, void* counters, int B, int H,
                     int D, int S, int P, int n_split, float scale,
                     cudaStream_t stream) {
  const int pps = (P + n_split - 1) / n_split;
  const int nc = decode_slots(D, sizeof(T), S, pps);
  const size_t smem = decode_smem_bytes(D, sizeof(T), nc);
  cudaError_t err = allow_smem(ragged_decode_kernel<T, CW>, smem);
  if (err != cudaSuccess) return (int)err;
  // the widest copy that the row's bytes and both pools' bases allow
  const int row_bytes = D * (int)sizeof(T);
  const uintptr_t base = reinterpret_cast<uintptr_t>(k_pages) |
                         reinterpret_cast<uintptr_t>(v_pages);
  int unit = (int)sizeof(T);
  for (int u = 16; u >= 4; u >>= 1)
    if (row_bytes % u == 0 && base % u == 0) {
      unit = u;
      break;
    }
  ragged_decode_kernel<T, CW><<<dim3(B * H, n_split), DEC_THREADS, smem,
                                stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), page_table, lengths,
      static_cast<T*>(out), static_cast<float*>(part),
      static_cast<float2*>(ml), static_cast<int*>(counters), H, D, S, P, pps,
      n_split, unit, nc, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_decode(const void* q, const void* k_pages, const void* v_pages,
                  const int* page_table, const int* lengths, void* out,
                  void* part, void* ml, void* counters, int B, int H, int D,
                  int S, int P, int n_split, float scale,
                  cudaStream_t stream) {
  if (D < 1 || D > MAX_D || S < 1 || n_split < 1 ||
      n_split > SPAN_MAX_SPLITS || (n_split > 1 && !counters))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return (int)cudaSuccess;
#define MXT_DEC(CW)                                                          \
  return launch_decode_cw<T, CW>(q, k_pages, v_pages, page_table, lengths,  \
                                 out, part, ml, counters, B, H, D, S, P,    \
                                 n_split, scale, stream)
  if (D <= 32) MXT_DEC(1);
  if (D <= 64) MXT_DEC(2);
  MXT_DEC(4);
#undef MXT_DEC
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

// The decode kernel, split like a span call with Sq = 1: with
// n_split > 1, part (B * H * n_split * D floats), ml (B * H * n_split
// float2) and counters (B * H ints, all 0, left 0) are the wrapper's
// scratch.
int mxt_ragged_decode(const void* q, const void* k_pages,
                      const void* v_pages, const void* page_table,
                      const void* lengths, void* out, void* part, void* ml,
                      void* counters, int B, int H, int D, int S, int P,
                      int n_split, float scale, int dtype, void* stream) {
  const int* tbl = static_cast<const int*>(page_table);
  const int* lens = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_decode<float>(q, k_pages, v_pages, tbl, lens, out, part,
                                ml, counters, B, H, D, S, P, n_split, scale,
                                st);
  if (dtype == 1)
    return launch_decode<__nv_bfloat16>(q, k_pages, v_pages, tbl, lens, out,
                                        part, ml, counters, B, H, D, S, P,
                                        n_split, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
