// Pieces of the fused training attention that the split-TF32 kernels
// (fused_attention.cu) and the tensor-core kernels (fused_attention_tc.cu)
// share: the reference's dropout hash, strided addressing of (batch,
// time, head) rows, the launch geometry and host-side launch helpers;
// and the per-element work on a 64 x 64 score tile held as an
// accumulator fragment (wgmma.cuh's layout, which is also mma.sync's
// m16n8 layout over eight 8-column blocks): the forward's online softmax
// (bias, causal test, dropout), and the backward's probabilities, dS and
// the dropout keep bits that the dQ kernel hands to the dK/dV kernel.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BM = 64;        // query rows of a block
constexpr int BN = 64;        // keys per tile
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return x ^ (x >> 16);
}

struct Strides {
  long long b, t, h;
};

struct Geometry {
  int H, Tq, Tk, D;
  float scale, inv_keep;
  uint32_t threshold;
  int dropout, causal;
};

__device__ __forceinline__ long long at(const Strides& s, int b, int t,
                                        int h) {
  return (long long)b * s.b + (long long)t * s.t + (long long)h * s.h;
}

// The keep decision of (row, col) for cell seeds (s0, s1).
__device__ __forceinline__ bool keep_bit(uint32_t s0, uint32_t s1, int row,
                                         int col, int Tk,
                                         uint32_t threshold) {
  const uint32_t pos = (uint32_t)row * (uint32_t)Tk + (uint32_t)col;
  return mix32(mix32(pos ^ s0) ^ s1) >= threshold;
}

// Key tiles a query tile [r0, r0 + BM) must visit.
__device__ __forceinline__ int key_tiles(const Geometry& g, int r0) {
  const int nkt = (g.Tk + BN - 1) / BN;
  if (!g.causal) return nkt;
  const int last = min(r0 + BM, g.Tq) - 1 + (g.Tk - g.Tq);
  return last < 0 ? 0 : min(nkt, last / BN + 1);
}

// This thread's 16 columns of the key tile at c0 (c0 + frag_col(4 nb + e)
// -> bc[2 nb + e]): their bias, -inf past Tk (an absent key).
__device__ __forceinline__ void load_bias(float (&bc)[16],
                                          const float* __restrict__ bias_b,
                                          int c0, int Tk) {
  const float* p = bias_b + c0 + frag_col(0);
  if (c0 + BN <= Tk) {  // a whole tile (uniform): no bound tests
#pragma unroll
    for (int j = 0; j < 16; ++j) bc[j] = __ldg(p + 8 * (j >> 1) + (j & 1));
    return;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = c0 + frag_col(4 * (j >> 1) + (j & 1));
    bc[j] = col < Tk ? __ldg(bias_b + col) : -INFINITY;
  }
}

// One key tile of the forward's online softmax, in place: the scores s
// (Q·Kᵀ of columns c0..c0+63) become the probabilities before
// normalisation, dropout applied, unrounded; the running max m and this
// thread's partial denominators l (pre-dropout) move on; alpha is the
// factor the output accumulator must take for the new max.
__device__ __forceinline__ void softmax_tile(
    float (&s)[32], const float (&bc)[16], const Geometry& g, int c0,
    const int (&rows)[2], float (&m)[2], float (&l)[2], float (&alpha)[2],
    uint32_t s0, uint32_t s1) {
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int i = (j >> 1) & 1;
    float x = fmaf(s[j], g.scale, bc[2 * (j >> 2) + (j & 1)]);
    // causal keys take NEG_INF; an absent key stays -inf
    if (g.causal)
      x = rows[i] + (g.Tk - g.Tq) < c0 + frag_col(j) ? fminf(x, NEG_INF) : x;
    s[j] = x;
  }
  // a dead row's scaled max is +inf: its exponentials come out 0
  float ms[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m_new = fmaxf(m[i], row_max(s, i));
    const bool dead = m_new <= NEG_INF * 0.5f;
    alpha[i] = dead ? 1.f : ex2((m[i] - m_new) * LOG2E);
    m[i] = m_new;
    ms[i] = dead ? INFINITY : m_new * LOG2E;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int i = (j >> 1) & 1;
    const float e = ex2(fmaf(s[j], LOG2E, -ms[i]));
    sum[i] += e;
    s[j] = !g.dropout || keep_bit(s0, s1, rows[i], c0 + frag_col(j), g.Tk,
                                  g.threshold)
               ? e
               : 0.f;
  }
  // alpha is common to the four threads of a row, so l can stay a
  // per-thread partial sum until the end
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];
}

// dS of one key tile, in place of s (S = Q·Kᵀ); da = dO·Vᵀ. Rows carry
// lsq = log2(l / scale) + m·log2e (+inf for a dead row), so that
// ex2(x·log2e - lsq) = p·scale (0 on a dead row), and d_row (dr); absent
// keys have bias -inf, so p = 0 there too and nothing needs a select.
// dS·scale⁻¹ = p·(dP - d_row) with dP = dA / keep, or 0 where dropped:
// dS = (p·scale)·(kept ? dA·inv_keep - d_row : -d_row).
// With dropout, the keep decisions go to bits:
// bits[i][w] holds the element of row half i and key 32 w + 8 m + 2 c + e
// (c = this thread's column pair) at bit 8 m + e.
__device__ __forceinline__ void ds_tile(float (&s)[32], const float (&da)[32],
                                        const float (&bc)[16],
                                        const Geometry& g, int c0,
                                        const int (&rows)[2],
                                        const float (&lsq)[2],
                                        const float (&dr)[2], uint32_t s0,
                                        uint32_t s1, uint32_t (&bits)[2][2]) {
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int i = (j >> 1) & 1, col = c0 + frag_col(j);
    float x = fmaf(s[j], g.scale, bc[2 * (j >> 2) + (j & 1)]);
    if (g.causal) x = rows[i] + (g.Tk - g.Tq) < col ? NEG_INF : x;
    const float ps = ex2(fmaf(x, LOG2E, -lsq[i]));
    float t = fmaf(da[j], g.inv_keep, -dr[i]);
    if (g.dropout) {
      // computed unconditionally: a branch around the hash would diverge
      const bool keep = keep_bit(s0, s1, rows[i], col, g.Tk, g.threshold);
      t = keep ? t : -dr[i];
      bits[i][j >> 4] |= (uint32_t)keep << (8 * ((j >> 2) & 3) + (j & 1));
    }
    s[j] = ps * t;
  }
}

// Store the keep bits of key tile kt (ds_tile's `bits`) as words of 32
// keys: keep[(b·H + h)·Tq + row][2 kt + w], bit (key % 32). The four
// threads of a row OR their parts together; thread c stores row half
// c / 2, word c % 2.
__device__ __forceinline__ void store_keep(const uint32_t (&bits)[2][2],
                                           uint32_t* __restrict__ keep,
                                           const Geometry& g, long long row0,
                                           const int (&rows)[2], int kt) {
  const int c = threadIdx.x & 3;
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    w[k] = bits[k >> 1][k & 1] << (2 * c);
    w[k] |= __shfl_xor_sync(0xffffffffu, w[k], 1);
    w[k] |= __shfl_xor_sync(0xffffffffu, w[k], 2);
  }
  const uint32_t v = c == 0 ? w[0] : c == 1 ? w[1] : c == 2 ? w[2] : w[3];
  const int row = c < 2 ? rows[0] : rows[1];
  const int nw = (g.Tk + 31) / 32, wi = 2 * kt + (c & 1);
  if (row < g.Tq && wi < nw) keep[(row0 + row) * nw + wi] = v;
}

// Pᵀ (dropout applied and scaled, in place of s = Sᵀ) and dSᵀ (in place of
// da = dPᵀ) of one query tile; rows are keys, columns the tile's queries.
// The stage at sm holds the queries' lse and d_row·scale (64 each; see the
// dQ kernel) and, with dropout, their keep words (two a row: this block's
// keys 0-31 and 32-63); kbit[i] is this thread's bit of key half i in its
// warp's word. Rows past Tq read zeros and their Q and dO rows are zero,
// so they add nothing; keys past Tk get values that are never stored.
__device__ __forceinline__ void grads_tile(float (&s)[32], float (&da)[32],
                                           const float* sm,
                                           const float (&bkey)[2],
                                           const Geometry& g, int r0,
                                           const int (&keys)[2],
                                           const uint32_t (&kbit)[2]) {
  const uint32_t* words =
      reinterpret_cast<const uint32_t*>(sm + 2 * BM) + (threadIdx.x >> 6);
  const float iks = g.inv_keep * g.scale;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int i = (j >> 1) & 1, lr = frag_col(j);
    float x = fmaf(s[j], g.scale, bkey[i]);
    if (g.causal) x = r0 + lr + (g.Tk - g.Tq) < keys[i] ? NEG_INF : x;
    const float p = ex2(fmaf(x, LOG2E, -sm[lr]));
    const float drs = sm[BM + lr];
    // dS = p·scale·(dP - d_row), dP = dA / keep or 0 where dropped
    float t = fmaf(da[j], iks, -drs);
    float a = p;
    if (g.dropout) {
      const bool keep = words[2 * lr] & kbit[i];
      a = keep ? p * g.inv_keep : 0.f;
      t = keep ? t : -drs;
    }
    s[j] = a;
    da[j] = p * t;
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

Strides strides_at(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

Geometry geometry(int H, int Tq, int Tk, int D, float scale, float inv_keep,
                  uint32_t threshold, int dropout, int causal) {
  return Geometry{H, Tq, Tk, D, scale, inv_keep, threshold, dropout, causal};
}

}  // namespace
