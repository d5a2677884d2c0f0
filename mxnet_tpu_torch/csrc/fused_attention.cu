// Fused attention for training, forward and backward, float32 and
// bfloat16: O = dropout(softmax(Q·Kᵀ·scale + bias [+ causal])) · V.
//
// Replaces the Pallas TPU kernels of mxnet_tpu/ops/pallas_attention.py:
//   fused_fwd_kernel                      <- _fwd_kernel_packed (BTHD),
//                                            _fwd_kernel (BHTD)
//   fused_bwd_dq_kernel, fused_bwd_dkdv_kernel
//                                         <- _bwd_kernel_packed (BTHD),
//                                            _bwd_kernel (BHTD)
// Every tensor is addressed through element strides for (batch, time,
// head) with a contiguous head dim, so the packed (B, T, H·D) layout and
// the (B, H, T, D) layout are two views of one kernel.
//
// Semantics kept from the reference, literally:
//   * scores s = q·k·scale + bias[b][key] (bias 0 or -1e30, float32);
//     causal masks key > query + (Tk - Tq) with -1e30;
//   * a row whose running max is still <= -1e30/2 contributes e = 0
//     (checked at every rescale, so leading all-padding tiles are
//     harmless); the output is normalised by the pre-dropout sum l,
//     clamped at 1e-30, so fully masked rows come out as zeros;
//   * dropout keeps (row, key) iff mix(mix(pos ^ s0) ^ s1) >= threshold,
//     pos = row·Tk + key (uint32), s0 = seed[0], s1 = seed[1] ^ (b·H + h):
//     the reference's software hash, bit for bit, so the backward
//     regenerates the forward's mask and the port's masks equal the JAX
//     package's interpret-mode masks;
//   * bfloat16: the probabilities are rounded to bfloat16 before P·V
//     and dV, ds before dQ and dK, as the reference rounds them before
//     its MXU products; every sum is float32.
//
// Design. The Pallas kernels hold a whole (Tq, Tk) score tile in VMEM;
// at T = 1024 a float32 tile is 4 MB and a Hopper block has 227 KB of
// shared memory, so this is tiled, flash-attention style:
//   forward  one block per (b, h, 64-query tile); loops over 64-key
//            tiles staged in shared memory, keeps the online-softmax
//            state (m, l, a D-wide accumulator) in registers, writes O
//            and the row statistics m, l (float32, (B, H, Tq)).
//   backward d_row = rowsum(dO ⊙ O) (equal to the reference's Σ a·da),
//            read from a float32 O (for bfloat16 the forward writes a
//            float32 copy, so a row with one live key gets ds = 0
//            exactly, as in the reference, instead of the rounding of O),
//            then one block per (b, h, 64-query tile) for dQ, and one
//            block per (b, h, 64-key tile) that loops over query tiles
//            for dK and dV. No atomics: the results are deterministic.
//            The dQ kernel runs first and writes d_row for the second.
//   Causal tiles stop at the diagonal (forward, dQ) or start there (dK,
//   dV). 256 threads: 16 row groups of 4 rows x 16 lanes of 4 columns;
//   a row's 16 lanes are one half-warp, so row reductions are shuffles.
//
// What bounds it on an H100: operations. At BERT-base shapes (T = 512,
// D = 64) a (b, h) cell does 4·T²·D flops forward on 4·T·D values read
// or written and 10·T²·D backward on 7·T·D: 128 and ~180 flops per
// float32 byte, far above the float32 ridge (~20); in bfloat16 (256 and
// ~360 per byte) near the tensor cores' ridge (~295). The products here
// are scalar FMAs on float32 values staged in shared memory (rows
// padded to D + 1 floats against bank conflicts), far below the
// bfloat16 tensor core peak; wgmma, TMA and a pipelined K/V ring are
// later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int MAX_D = 128;
constexpr int BM = 64;               // query rows per tile
constexpr int BN = 64;               // keys per tile
constexpr int THREADS = 256;         // 16 row groups x 16 lanes
constexpr int RPT = 4;               // rows of a thread (BM / 16)
constexpr int CPT = 4;               // columns of a thread (BN / 16)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and back (identity for float32)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// reductions over the 16 lanes of a half-warp (one row group)
__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

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

// Stage rows [t0, t0 + 64) of head (b, h) into shared memory as f32 with
// row stride ld; rows past n are zero.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ x,
                                      const Strides& s, int b, int h,
                                      int t0, int n, int D, float* dst,
                                      int ld) {
  for (int i = threadIdx.x; i < 64 * D; i += THREADS) {
    const int r = i / D, d = i - r * D;
    const int t = t0 + r;
    dst[r * ld + d] =
        t < n ? to_f32(x[at(s, b, t, h) + d]) : 0.f;
  }
}

// The keep decision of (row, col) for cell seeds (s0, s1).
__device__ __forceinline__ bool keep_bit(uint32_t s0, uint32_t s1, int row,
                                         int col, int Tk,
                                         uint32_t threshold) {
  const uint32_t pos = (uint32_t)row * (uint32_t)Tk + (uint32_t)col;
  return mix32(mix32(pos ^ s0) ^ s1) >= threshold;
}

// The masked score of (row, col): scale and bias applied, causal keys
// set to NEG_INF. Columns past Tk are absent: -inf, ignored by the max.
__device__ __forceinline__ float masked_score(float dot, const Geometry& g,
                                              float bias, int row,
                                              int col) {
  if (col >= g.Tk) return -INFINITY;
  float x = dot * g.scale + bias;
  if (g.causal && row + (g.Tk - g.Tq) < col) x = NEG_INF;
  return x;
}

// Key tiles a query tile [r0, r0 + 64) must visit.
__device__ __forceinline__ int key_tiles(const Geometry& g, int r0) {
  const int nkt = (g.Tk + BN - 1) / BN;
  if (!g.causal) return nkt;
  const int last = min(r0 + BM, g.Tq) - 1 + (g.Tk - g.Tq);
  return last < 0 ? 0 : min(nkt, last / BN + 1);
}

// --------------------------------------------------------------------------
// forward
// --------------------------------------------------------------------------

template <typename T, int DJ>
__global__ void __launch_bounds__(THREADS) fused_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ bias,
    const int* __restrict__ seed, T* __restrict__ o, float* __restrict__ o32,
    float* __restrict__ m_out, float* __restrict__ l_out, Strides sq,
    Strides sk, Strides sv, Strides so, Geometry g) {
  const int bh = blockIdx.x;
  const int b = bh / g.H, h = bh - b * g.H;
  const int r0 = blockIdx.y * BM;
  const int tid = threadIdx.x, grp = tid >> 4, ln = tid & 15;
  const int D = g.D;
  const int ldq = D + 1, ldk = D + 1, ldv = D, ldp = BN + 1;

  extern __shared__ float smem[];
  float* q_s = smem;                 // BM x (D + 1)
  float* k_s = q_s + BM * ldq;       // BN x (D + 1)
  float* v_s = k_s + BN * ldk;       // BN x D
  float* p_s = v_s + BN * ldv;       // BM x (BN + 1)

  stage<T>(q, sq, b, h, r0, g.Tq, D, q_s, ldq);
  const uint32_t s0 = (uint32_t)seed[0];
  const uint32_t s1 = (uint32_t)seed[1] ^ (uint32_t)bh;
  const float* bias_b = bias + (long long)b * g.Tk;

  float m_i[RPT], l_i[RPT], acc[RPT][DJ];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int n_tiles = key_tiles(g, r0);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int c0 = kt * BN;
    __syncthreads();  // the previous tile is consumed
    stage<T>(k, sk, b, h, c0, g.Tk, D, k_s, ldk);
    stage<T>(v, sv, b, h, c0, g.Tk, D, v_s, ldv);
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = q_s[(grp * RPT + i) * ldq + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = k_s[(ln + 16 * j) * ldk + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    float bcol[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int col = c0 + ln + 16 * j;
      bcol[j] = col < g.Tk ? bias_b[col] : 0.f;
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int lr = grp * RPT + i;
      const int row = r0 + lr;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        s[i][j] = masked_score(s[i][j], g, bcol[j], row, c0 + ln + 16 * j);
        mx = fmaxf(mx, s[i][j]);
      }
      mx = half_max(mx);
      const float m_new = fmaxf(m_i[i], mx);
      const bool masked = m_new <= NEG_INF * 0.5f;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = c0 + ln + 16 * j;
        float e = (masked || col >= g.Tk) ? 0.f : expf(s[i][j] - m_new);
        sum += e;
        if (g.dropout && !keep_bit(s0, s1, row, col, g.Tk, g.threshold))
          e = 0.f;
        p_s[lr * ldp + ln + 16 * j] = round_to<T>(e);
      }
      sum = half_sum(sum);
      const float alpha = masked ? 1.f : expf(m_i[i] - m_new);
      l_i[i] = l_i[i] * alpha + sum;
      m_i[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) acc[i][jj] *= alpha;
    }
    __syncwarp();  // a row group's probabilities are in p_s

    for (int c = 0; c < BN; ++c) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = p_s[(grp * RPT + i) * ldp + c];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        const int d = ln + 16 * jj;
        const float vv = d < D ? v_s[c * ldv + d] : 0.f;
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][jj] = fmaf(pv[i], vv, acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = r0 + grp * RPT + i;
    if (row >= g.Tq) continue;
    const float f = g.inv_keep / fmaxf(l_i[i], 1e-30f);
    T* orow = o + at(so, b, row, h);
    float* o32row = o32 ? o32 + at(so, b, row, h) : nullptr;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      const int d = ln + 16 * jj;
      if (d < D) {
        orow[d] = from_f32<T>(acc[i][jj] * f);
        if (o32row) o32row[d] = acc[i][jj] * f;
      }
    }
    if (ln == 0) {
      m_out[(long long)bh * g.Tq + row] = m_i[i];
      l_out[(long long)bh * g.Tq + row] = l_i[i];
    }
  }
}

// --------------------------------------------------------------------------
// backward: dQ (and d_row)
// --------------------------------------------------------------------------

template <typename T, int DJ>
__global__ void __launch_bounds__(THREADS) fused_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ o32,
    const T* __restrict__ dout, const float* __restrict__ bias,
    const int* __restrict__ seed, const float* __restrict__ m_in,
    const float* __restrict__ l_in, float* __restrict__ d_row_out,
    T* __restrict__ dq, Strides sq, Strides sk, Strides sv, Strides so,
    Strides sdo, Strides sdq, Geometry g) {
  const int bh = blockIdx.x;
  const int b = bh / g.H, h = bh - b * g.H;
  const int r0 = blockIdx.y * BM;
  const int tid = threadIdx.x, grp = tid >> 4, ln = tid & 15;
  const int D = g.D;
  const int ld = D + 1, ldp = BN + 1;

  extern __shared__ float smem[];
  float* q_s = smem;                 // BM x (D + 1)
  float* do_s = q_s + BM * ld;       // BM x (D + 1)
  float* k_s = do_s + BM * ld;       // BN x (D + 1)
  float* v_s = k_s + BN * ld;        // BN x (D + 1)
  float* ds_s = v_s + BN * ld;       // BM x (BN + 1)

  stage<T>(q, sq, b, h, r0, g.Tq, D, q_s, ld);
  stage<T>(dout, sdo, b, h, r0, g.Tq, D, do_s, ld);
  __syncthreads();
  const uint32_t s0 = (uint32_t)seed[0];
  const uint32_t s1 = (uint32_t)seed[1] ^ (uint32_t)bh;
  const float* bias_b = bias + (long long)b * g.Tk;

  // per row: the max, the clamped denominator and d_row = Σ dO·O
  float m_i[RPT], lc_i[RPT], dr_i[RPT], acc[RPT][DJ];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int lr = grp * RPT + i;
    const int row = r0 + lr;
    float part = 0.f;
    m_i[i] = NEG_INF;
    lc_i[i] = 1.f;
    if (row < g.Tq) {
      m_i[i] = m_in[(long long)bh * g.Tq + row];
      lc_i[i] = fmaxf(l_in[(long long)bh * g.Tq + row], 1e-30f);
      const float* orow = o32 + at(so, b, row, h);
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        const int d = ln + 16 * jj;
        if (d < D) part = fmaf(do_s[lr * ld + d], orow[d], part);
      }
    }
    dr_i[i] = half_sum(part);
    if (row < g.Tq && ln == 0) d_row_out[(long long)bh * g.Tq + row] = dr_i[i];
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = 0.f;
  }

  const int n_tiles = key_tiles(g, r0);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int c0 = kt * BN;
    __syncthreads();
    stage<T>(k, sk, b, h, c0, g.Tk, D, k_s, ld);
    stage<T>(v, sv, b, h, c0, g.Tk, D, v_s, ld);
    __syncthreads();

    float s[RPT][CPT], da[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = da[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[RPT], dov[RPT], kv[CPT], vv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        qv[i] = q_s[(grp * RPT + i) * ld + d];
        dov[i] = do_s[(grp * RPT + i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        kv[j] = k_s[(ln + 16 * j) * ld + d];
        vv[j] = v_s[(ln + 16 * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          da[i][j] = fmaf(dov[i], vv[j], da[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int lr = grp * RPT + i;
      const int row = r0 + lr;
      const bool dead = m_i[i] <= NEG_INF * 0.5f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = c0 + ln + 16 * j;
        float ds = 0.f;
        if (!dead && col < g.Tk && row < g.Tq) {
          const float x = masked_score(s[i][j], g, bias_b[col], row, col);
          const float p = expf(x - m_i[i]) / lc_i[i];
          float dp = da[i][j] * g.inv_keep;
          if (g.dropout && !keep_bit(s0, s1, row, col, g.Tk, g.threshold))
            dp = 0.f;
          ds = round_to<T>(p * (dp - dr_i[i]) * g.scale);
        }
        ds_s[lr * ldp + ln + 16 * j] = ds;
      }
    }
    __syncwarp();

    for (int c = 0; c < BN; ++c) {
      float dsv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) dsv[i] = ds_s[(grp * RPT + i) * ldp + c];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        const int d = ln + 16 * jj;
        const float kv = d < D ? k_s[c * ld + d] : 0.f;
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][jj] = fmaf(dsv[i], kv, acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = r0 + grp * RPT + i;
    if (row >= g.Tq) continue;
    T* out = dq + at(sdq, b, row, h);
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      const int d = ln + 16 * jj;
      if (d < D) out[d] = from_f32<T>(acc[i][jj]);
    }
  }
}

// --------------------------------------------------------------------------
// backward: dK and dV
// --------------------------------------------------------------------------

// Thread layout transposed: a row group owns 4 keys, a lane 4 queries.
template <typename T, int DJ>
__global__ void __launch_bounds__(THREADS) fused_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ bias, const int* __restrict__ seed,
    const float* __restrict__ m_in, const float* __restrict__ l_in,
    const float* __restrict__ d_row, T* __restrict__ dk,
    T* __restrict__ dv, Strides sq, Strides sk, Strides sv, Strides sdo,
    Strides sdk, Strides sdv, Geometry g) {
  const int bh = blockIdx.x;
  const int b = bh / g.H, h = bh - b * g.H;
  const int c0 = blockIdx.y * BN;
  const int tid = threadIdx.x, grp = tid >> 4, ln = tid & 15;
  const int D = g.D;
  const int ld = D + 1, ldp = BM + 1;

  extern __shared__ float smem[];
  float* k_s = smem;                 // BN x (D + 1)
  float* v_s = k_s + BN * ld;        // BN x (D + 1)
  float* q_s = v_s + BN * ld;        // BM x (D + 1)
  float* do_s = q_s + BM * ld;       // BM x (D + 1)
  float* a_s = do_s + BM * ld;       // BN x (BM + 1)
  float* ds_s = a_s + BN * ldp;      // BN x (BM + 1)
  float* m_s = ds_s + BN * ldp;      // BM
  float* lc_s = m_s + BM;            // BM
  float* dr_s = lc_s + BM;           // BM

  stage<T>(k, sk, b, h, c0, g.Tk, D, k_s, ld);
  stage<T>(v, sv, b, h, c0, g.Tk, D, v_s, ld);
  const uint32_t s0 = (uint32_t)seed[0];
  const uint32_t s1 = (uint32_t)seed[1] ^ (uint32_t)bh;
  float bkey[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int col = c0 + grp * RPT + i;
    bkey[i] = col < g.Tk ? bias[(long long)b * g.Tk + col] : 0.f;
  }

  float dk_acc[RPT][DJ], dv_acc[RPT][DJ];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) dk_acc[i][jj] = dv_acc[i][jj] = 0.f;

  // causal: the first query that sees key c0 is c0 - (Tk - Tq)
  const int nqt = (g.Tq + BM - 1) / BM;
  int first = 0;
  if (g.causal) {
    const int r = c0 - (g.Tk - g.Tq);
    first = r <= 0 ? 0 : min(nqt, r / BM);
  }
  for (int qt = first; qt < nqt; ++qt) {
    const int r0 = qt * BM;
    __syncthreads();
    stage<T>(q, sq, b, h, r0, g.Tq, D, q_s, ld);
    stage<T>(dout, sdo, b, h, r0, g.Tq, D, do_s, ld);
    for (int i = threadIdx.x; i < BM; i += THREADS) {
      const int row = r0 + i;
      const bool in = row < g.Tq;
      m_s[i] = in ? m_in[(long long)bh * g.Tq + row] : NEG_INF;
      lc_s[i] = in ? fmaxf(l_in[(long long)bh * g.Tq + row], 1e-30f) : 1.f;
      dr_s[i] = in ? d_row[(long long)bh * g.Tq + row] : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT], da[RPT][CPT];   // [key][query]
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = da[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float kv[RPT], vv[RPT], qv[CPT], dov[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        kv[i] = k_s[(grp * RPT + i) * ld + d];
        vv[i] = v_s[(grp * RPT + i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        qv[j] = q_s[(ln + 16 * j) * ld + d];
        dov[j] = do_s[(ln + 16 * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          da[i][j] = fmaf(vv[i], dov[j], da[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int lc = grp * RPT + i;
      const int col = c0 + lc;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int lr = ln + 16 * j;
        const int row = r0 + lr;
        float a = 0.f, ds = 0.f;
        const float m = m_s[lr];
        if (col < g.Tk && row < g.Tq && m > NEG_INF * 0.5f) {
          const float x = masked_score(s[i][j], g, bkey[i], row, col);
          const float p = expf(x - m) / lc_s[lr];
          float dp = da[i][j] * g.inv_keep;
          a = g.dropout ? p * g.inv_keep : p;
          if (g.dropout && !keep_bit(s0, s1, row, col, g.Tk, g.threshold)) {
            a = 0.f;
            dp = 0.f;
          }
          ds = p * (dp - dr_s[lr]) * g.scale;
        }
        a_s[lc * ldp + lr] = round_to<T>(a);
        ds_s[lc * ldp + lr] = round_to<T>(ds);
      }
    }
    __syncwarp();

    for (int r = 0; r < BM; ++r) {
      float av[RPT], dsv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        av[i] = a_s[(grp * RPT + i) * ldp + r];
        dsv[i] = ds_s[(grp * RPT + i) * ldp + r];
      }
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        const int d = ln + 16 * jj;
        const float dov = d < D ? do_s[r * ld + d] : 0.f;
        const float qv = d < D ? q_s[r * ld + d] : 0.f;
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          dv_acc[i][jj] = fmaf(av[i], dov, dv_acc[i][jj]);
          dk_acc[i][jj] = fmaf(dsv[i], qv, dk_acc[i][jj]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int col = c0 + grp * RPT + i;
    if (col >= g.Tk) continue;
    T* ko = dk + at(sdk, b, col, h);
    T* vo = dv + at(sdv, b, col, h);
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      const int d = ln + 16 * jj;
      if (d < D) {
        ko[d] = from_f32<T>(dk_acc[i][jj]);
        vo[d] = from_f32<T>(dv_acc[i][jj]);
      }
    }
  }
}

size_t fwd_smem_bytes(int D) {
  return sizeof(float) * ((size_t)BM * (D + 1) + (size_t)BN * (D + 1) +
                          (size_t)BN * D + (size_t)BM * (BN + 1));
}

size_t dq_smem_bytes(int D) {
  return sizeof(float) *
         (4 * (size_t)64 * (D + 1) + (size_t)BM * (BN + 1));
}

size_t dkdv_smem_bytes(int D) {
  return sizeof(float) * (4 * (size_t)64 * (D + 1) +
                          2 * (size_t)BN * (BM + 1) + 3 * (size_t)BM);
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

template <typename T, int DJ>
int launch_fwd(const void* q, const void* k, const void* v,
               const float* bias, const int* seed, void* o, float* o32,
               float* m, float* l, const long long* st, int B, Geometry g,
               cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes(g.D);
  cudaError_t err = allow_smem(fused_fwd_kernel<T, DJ>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * g.H, (g.Tq + BM - 1) / BM);
  fused_fwd_kernel<T, DJ><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, seed, static_cast<T*>(o), o32, m, l,
      strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
      strides_at(st, 3), g);
  return (int)cudaGetLastError();
}

template <typename T, int DJ>
int launch_bwd(const void* q, const void* k, const void* v, const float* o32,
               const void* dout, const float* bias, const int* seed,
               const float* m, const float* l, float* d_row, void* dq,
               void* dk, void* dv, const long long* st, int B, Geometry g,
               cudaStream_t stream) {
  const size_t smem_q = dq_smem_bytes(g.D);
  const size_t smem_kv = dkdv_smem_bytes(g.D);
  cudaError_t err = allow_smem(fused_bwd_dq_kernel<T, DJ>, smem_q);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(fused_bwd_dkdv_kernel<T, DJ>, smem_kv);
  if (err != cudaSuccess) return (int)err;
  const Strides sq = strides_at(st, 0), sk = strides_at(st, 1),
                sv = strides_at(st, 2), so = strides_at(st, 3),
                sdo = strides_at(st, 4), sdq = strides_at(st, 5),
                sdk = strides_at(st, 6), sdv = strides_at(st, 7);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  // dQ first: it also writes d_row, which the dK/dV kernel reads
  fused_bwd_dq_kernel<T, DJ><<<dim3(B * g.H, (g.Tq + BM - 1) / BM), THREADS,
                               smem_q, stream>>>(
      qt, kt, vt, o32, dot, bias, seed, m, l, d_row,
      static_cast<T*>(dq), sq, sk, sv, so, sdo, sdq, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_bwd_dkdv_kernel<T, DJ><<<dim3(B * g.H, (g.Tk + BN - 1) / BN),
                                 THREADS, smem_kv, stream>>>(
      qt, kt, vt, dot, bias, seed, m, l, d_row, static_cast<T*>(dk),
      static_cast<T*>(dv), sq, sk, sv, sdo, sdk, sdv, g);
  return (int)cudaGetLastError();
}

Geometry geometry(int H, int Tq, int Tk, int D, float scale, float inv_keep,
                  uint32_t threshold, int dropout, int causal) {
  return Geometry{H, Tq, Tk, D, scale, inv_keep, threshold, dropout, causal};
}

}  // namespace

// C interface, bound with ctypes. dtype: 0 = float32, 1 = bfloat16.
// strides: host array of (batch, time, head) element strides, 3 per
// tensor, in argument order (forward q, k, v, o — o32, if given, has
// o's strides; backward q, k, v, o32, dout, dq, dk, dv). o32: the
// output in float32, which the backward's d_row reads (for float32 the
// output itself; the forward writes it only when the pointer is not
// null). m, l, d_row: float32 (B, H, Tq), contiguous. seed: (2,) int32
// on the device. Each returns the cudaError_t of its launches (0 =
// launched).
extern "C" {

int mxt_fused_attention_fwd(const void* q, const void* k, const void* v,
                            const void* bias, const void* seed, void* o,
                            void* o32, void* m, void* l,
                            const long long* strides,
                            int B, int H, int Tq, int Tk, int D, float scale,
                            float inv_keep, uint32_t threshold, int dropout,
                            int causal, int dtype, void* stream) {
  if (D < 1 || D > MAX_D) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || Tq == 0) return (int)cudaSuccess;
  const Geometry g =
      geometry(H, Tq, Tk, D, scale, inv_keep, threshold, dropout, causal);
  const float* bs = static_cast<const float*>(bias);
  const int* sd = static_cast<const int*>(seed);
  float* of = static_cast<float*>(o32);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = D > 64;
  if (dtype == 0)
    return wide ? launch_fwd<float, 8>(q, k, v, bs, sd, o, of, mf, lf,
                                       strides, B, g, st)
                : launch_fwd<float, 4>(q, k, v, bs, sd, o, of, mf, lf,
                                       strides, B, g, st);
  if (dtype == 1)
    return wide ? launch_fwd<__nv_bfloat16, 8>(q, k, v, bs, sd, o, of, mf, lf,
                                               strides, B, g, st)
                : launch_fwd<__nv_bfloat16, 4>(q, k, v, bs, sd, o, of, mf, lf,
                                               strides, B, g, st);
  return (int)cudaErrorInvalidValue;
}

int mxt_fused_attention_bwd(const void* q, const void* k, const void* v,
                            const void* o32, const void* dout,
                            const void* bias, const void* seed,
                            const void* m, const void* l, void* d_row,
                            void* dq, void* dk, void* dv,
                            const long long* strides, int B, int H, int Tq,
                            int Tk, int D, float scale, float inv_keep,
                            uint32_t threshold, int dropout, int causal,
                            int dtype, void* stream) {
  if (D < 1 || D > MAX_D) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || Tq == 0 || Tk == 0) return (int)cudaSuccess;
  const Geometry g =
      geometry(H, Tq, Tk, D, scale, inv_keep, threshold, dropout, causal);
  const float* bs = static_cast<const float*>(bias);
  const int* sd = static_cast<const int*>(seed);
  const float* mf = static_cast<const float*>(m);
  const float* lf = static_cast<const float*>(l);
  const float* of = static_cast<const float*>(o32);
  float* dr = static_cast<float*>(d_row);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = D > 64;
  if (dtype == 0)
    return wide ? launch_bwd<float, 8>(q, k, v, of, dout, bs, sd, mf, lf, dr,
                                       dq, dk, dv, strides, B, g, st)
                : launch_bwd<float, 4>(q, k, v, of, dout, bs, sd, mf, lf, dr,
                                       dq, dk, dv, strides, B, g, st);
  if (dtype == 1)
    return wide ? launch_bwd<__nv_bfloat16, 8>(q, k, v, of, dout, bs, sd, mf,
                                               lf, dr, dq, dk, dv, strides, B,
                                               g, st)
                : launch_bwd<__nv_bfloat16, 4>(q, k, v, of, dout, bs, sd, mf,
                                               lf, dr, dq, dk, dv, strides, B,
                                               g, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
