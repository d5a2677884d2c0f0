// The work split of the ragged span kernels (ragged_attention.cu on the
// CUDA cores, ragged_attention_tc.cu on the tensor cores) and the
// combine of its partial results. The decode kernel (ragged_attention.cu)
// takes the same split as a span call with Sq = 1 and one live row a
// slot, with partials of one row a tile.
//
// A block takes one (slot b, head h, 64-row query tile qt, page split
// sp): blockIdx.x = (b * H + h) * n_qt + qt, blockIdx.y = sp. The host
// picks the number of splits from static shapes alone
// (ops/ragged_attention.py `span_split_plan`); split sp covers logical
// pages [sp * pps, (sp + 1) * pps) of the slot. Which splits hold live
// keys depends on the device's lengths and q_counts, so every block
// works it out for itself:
//   * the tile's live rows are [row0, row_end), row_end = min(row0 + 64,
//     q_counts[b], Sq); its last live row sees keys < kmax = lengths[b]
//     + row_end - 1 (at most P * S);
//   * n_live splits hold keys below kmax; a split past them, and every
//     split of a tile without live keys, reads nothing (split 0 of such
//     a tile writes its exact zeros);
//   * one live split writes the output itself; with more, each writes
//     float32 partials (the unnormalised accumulator, the running max m
//     and the denominator l of each live row) and the last of them to
//     finish, found by a per-tile counter that it resets to 0, combines
//     them in split order, while split 0 has zeroed the dead rows. The result does not depend on which block
//     finishes last: two runs are bit for bit the same.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SPAN_TILE = 64;     // query rows of a block, both kernels
constexpr int SPAN_MAX_SPLITS = 16;
constexpr float SPAN_NEG_INF = -1e30f;

struct SpanWork {
  int b, h, tile;      // tile = blockIdx.x, the counter's index
  int row0, row_end;   // live rows [row0, row_end) of the slot
  int length;          // row j sees keys < length + j
  int k0, k1;          // this split's live keys [k0, k1)
  int n_live;          // splits of the tile that hold live keys
};

// The block's slot, head and tile, from blockIdx alone (no load).
__device__ __forceinline__ SpanWork span_block(int Sq, int H) {
  SpanWork w;
  const int n_qt = (Sq + SPAN_TILE - 1) / SPAN_TILE;
  w.tile = blockIdx.x;
  const int bh = blockIdx.x / n_qt;
  w.row0 = (blockIdx.x - bh * n_qt) * SPAN_TILE;
  w.b = bh / H;
  w.h = bh - w.b * H;
  return w;
}

// The tile's live rows and this split's live keys, from the slot's
// length and q_count.
__device__ __forceinline__ void span_live(SpanWork& w, int length,
                                          int q_count, int Sq, int S, int P,
                                          int pps) {
  w.length = length;
  w.row_end = min(w.row0 + SPAN_TILE, min(q_count, Sq));
  const int kmax = w.row_end > w.row0
                       ? min(max(w.length + w.row_end - 1, 0), P * S)
                       : 0;
  const int span = pps * S;   // keys of a split
  w.n_live = (kmax + span - 1) / span;
  w.k0 = blockIdx.y * span;
  w.k1 = min(w.k0 + span, kmax);
}
__device__ __forceinline__ void span_live(SpanWork& w,
                                          const int* __restrict__ lengths,
                                          const int* __restrict__ q_counts,
                                          int Sq, int S, int P, int pps) {
  span_live(w, lengths[w.b], q_counts[w.b], Sq, S, P, pps);
}

// Row `row` of (b, h) in a (B, Sq, H, D) tensor.
__device__ __forceinline__ size_t span_row(const SpanWork& w, int row,
                                           int Sq, int H, int D) {
  return ((size_t)(w.b * Sq + row) * H + w.h) * D;
}

template <typename T> __device__ __forceinline__ T span_cast(float x);
template <> __device__ __forceinline__ float span_cast<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
span_cast<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Exact zeros over rows [r0, min(row0 + 64, Sq)) of the tile, in
// 16-byte stores where a row's bytes allow (every row starts on a
// multiple of them: the output is a fresh allocation).
template <typename T>
__device__ void span_zero_rows(const SpanWork& w, T* __restrict__ out,
                               int r0, int Sq, int H, int D) {
  const int rows = min(w.row0 + SPAN_TILE, Sq) - r0;
  const int bytes = D * (int)sizeof(T);
  const int unit = bytes % 16 ? (int)sizeof(T) : 16;
  const int cpr = bytes / unit;   // stores a row
  for (int i = threadIdx.x; i < rows * cpr; i += blockDim.x) {
    const int r = i / cpr;
    uint8_t* p = reinterpret_cast<uint8_t*>(
                     out + span_row(w, r0 + r, Sq, H, D)) +
                 (i - r * cpr) * unit;
    if (unit == 16)
      *reinterpret_cast<uint4*>(p) = make_uint4(0, 0, 0, 0);
    else
      *reinterpret_cast<T*>(p) = span_cast<T>(0.f);
  }
}

// Partials of tile w.tile, split sp, start at row part_index(w, sp):
// acc (TILE, D) float32 and (m, l) (TILE,) float2 a split. TILE is the
// rows a tile keeps partials for: 64 in the span kernels, 1 in the
// decode kernel.
template <int TILE = SPAN_TILE>
__device__ __forceinline__ size_t part_index(const SpanWork& w, int sp,
                                             int n_split) {
  return ((size_t)w.tile * n_split + sp) * TILE;
}

// Called by every thread of a live split's block after it wrote its
// partials. Returns true in the block that must combine (the last of the
// tile's n_live splits to arrive); that block has reset the counter.
__device__ __forceinline__ bool span_arrive(const SpanWork& w,
                                            int* __restrict__ counters) {
  __shared__ int last;
  __threadfence();   // this thread's partials, before the count
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counters + w.tile, 1) == w.n_live - 1;
    if (last) counters[w.tile] = 0;   // ready for the next launch
  }
  __syncthreads();
  if (last) __threadfence();   // the other splits' partials, after it
  return last;
}

// Columns [d, d + V) of live row r of the combine: every live split's
// partial is requested before any is summed (one L2 round trip, not
// n_live), then summed in split order.
template <int V, int TILE, typename T>
__device__ __forceinline__ void combine_cols(
    const SpanWork& w, const float* __restrict__ part,
    const float (*wt)[TILE], T* __restrict__ out, size_t p0, int r,
    int d, int Sq, int H, int D) {
  float x[SPAN_MAX_SPLITS][V];
#pragma unroll
  for (int s = 0; s < SPAN_MAX_SPLITS; ++s)
    if (s < w.n_live) {
      const float* src = part + (p0 + s * TILE + r) * D + d;
      if constexpr (V == 4) {
        const float4 v = __ldcg(reinterpret_cast<const float4*>(src));
        x[s][0] = v.x; x[s][1] = v.y; x[s][2] = v.z; x[s][3] = v.w;
      } else {
        x[s][0] = __ldcg(src);
      }
    }
  float a[V] = {};
#pragma unroll
  for (int s = 0; s < SPAN_MAX_SPLITS; ++s)
    if (s < w.n_live)
#pragma unroll
      for (int v = 0; v < V; ++v) a[v] += wt[s][r] * x[s][v];
  T* o = out + span_row(w, w.row0 + r, Sq, H, D) + d;
#pragma unroll
  for (int v = 0; v < V; ++v) o[v] = span_cast<T>(a[v]);
}

// The combine: live row r of the tile is sum_s e_s acc_s / max(sum_s
// e_s l_s, 1e-30) over the live splits s in order, e_s = exp(m_s -
// max_s m_s), 0 for a split where the row saw no key (the weights, the
// denominator folded in, are formed first, one row a thread). The dead
// rows are split 0's to zero (span_dead_rows). Partials are read
// through L2 (__ldcg): other SMs wrote them.
template <int TILE = SPAN_TILE, typename T>
__device__ void span_combine(const SpanWork& w,
                             const float* __restrict__ part,
                             const float2* __restrict__ ml,
                             T* __restrict__ out, int Sq, int H, int D,
                             int n_split) {
  __shared__ float wt[SPAN_MAX_SPLITS][TILE];
  const int live = w.row_end - w.row0;
  const size_t p0 = part_index<TILE>(w, 0, n_split);
  for (int r = threadIdx.x; r < live; r += blockDim.x) {
    float2 v[SPAN_MAX_SPLITS];
    float M = SPAN_NEG_INF, L = 0.f;
#pragma unroll
    for (int s = 0; s < SPAN_MAX_SPLITS; ++s)
      if (s < w.n_live) v[s] = __ldcg(ml + p0 + s * TILE + r);
#pragma unroll
    for (int s = 0; s < SPAN_MAX_SPLITS; ++s)
      if (s < w.n_live) M = fmaxf(M, v[s].x);
#pragma unroll
    for (int s = 0; s < SPAN_MAX_SPLITS; ++s)
      if (s < w.n_live) {
        v[s].x = v[s].x <= SPAN_NEG_INF * 0.5f ? 0.f : expf(v[s].x - M);
        L += v[s].x * v[s].y;
      }
    const float inv = 1.f / fmaxf(L, 1e-30f);
#pragma unroll
    for (int s = 0; s < SPAN_MAX_SPLITS; ++s)
      if (s < w.n_live) wt[s][r] = v[s].x * inv;
  }
  __syncthreads();
  if (D % 4 == 0) {
    const int cw = D / 4;
    for (int i = threadIdx.x; i < live * cw; i += blockDim.x) {
      const int r = i / cw;
      combine_cols<4, TILE>(w, part, wt, out, p0, r, (i - r * cw) * 4, Sq,
                            H, D);
    }
  } else {
    for (int i = threadIdx.x; i < live * D; i += blockDim.x) {
      const int r = i / D;
      combine_cols<1, TILE>(w, part, wt, out, p0, r, i - r * D, Sq, H, D);
    }
  }
}

// With more than one live split, split 0 zeroes the tile's dead rows
// while its pages are in flight, off the combine's path.
template <typename T>
__device__ __forceinline__ void span_dead_rows(const SpanWork& w,
                                               T* __restrict__ out, int Sq,
                                               int H, int D) {
  if (w.n_live > 1 && blockIdx.y == 0)
    span_zero_rows(w, out, w.row_end, Sq, H, D);
}

}  // namespace
