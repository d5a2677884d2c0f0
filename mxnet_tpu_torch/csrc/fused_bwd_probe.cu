// A probe of two designs for the float32 fused attention backward, on
// its dQ pass (S = Q·Kᵀ, dP = dO·Vᵀ, dS, dQ += dS·K: three of its five
// products), float32, D = 64, a key-padding bias, no dropout, not
// causal. Built and timed by mxnet_tpu_torch/tools/probe_fused_bwd.py;
// nothing in the package calls it.
//   design 0, "fma": register-tiled CUDA-core FMAs. 128 threads, each
//     8 rows x 4 columns of the 64 x 64 S and dP tiles and 8 rows x 4
//     columns of dQ, from 16-byte shared loads of unpadded rows whose
//     16-byte chunks are swizzled (chunk c of row r at c ^ (r / 4) % 16);
//     K and V double-buffered by cp.async; dS through shared memory.
//   design 1, "tf32x3": fused_attention.cu's fused_bwd_dq_kernel<float,
//     64> itself (split TF32 on the tensor cores), launched alone.
// Both read Q, K, V, dO, the float32 O and the forward's row max m and
// denominator l, and write dQ (and design 1 its row statistics).

#include "fused_attention.cu"

namespace {

constexpr int PD = 64;             // head dim of the probe
constexpr int PT = 128;            // threads of the FMA design
constexpr int TILE = 64 * PD;      // floats of a tile

// Offset in floats of 16-byte chunk c of row r in a swizzled tile.
__device__ __forceinline__ int sw(int r, int c) {
  return r * PD + ((c ^ ((r >> 2) & 15)) << 2);
}

// the sum over the 16 lanes of a half-warp
__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// rows [t0, t0 + 64) of head (b, h) into a swizzled tile; rows past n
// zero-filled; the caller commits
__device__ __forceinline__ void stage_tile(float* dst, const float* x,
                                           const Strides& s, int b, int h,
                                           int t0, int n) {
  for (int i = threadIdx.x; i < 64 * 16; i += PT) {
    const int r = i >> 4, c = i & 15;
    const bool in = t0 + r < n;
    const float* src = in ? x + at(s, b, t0 + r, h) + 4 * c : x;
    cp_async16(smem_u32(dst + sw(r, c)), src, in ? 16 : 0);
  }
}

__global__ void __launch_bounds__(PT) probe_dq_fma_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ o32,
    const float* __restrict__ dout, const float* __restrict__ bias,
    const float* __restrict__ m_in, const float* __restrict__ l_in,
    float* __restrict__ dq, Strides sq, Strides sk, Strides sv, Strides so,
    Strides sdo, Strides sdq, Geometry g) {
  extern __shared__ __align__(16) float psm[];
  float* q_s = psm;
  float* do_s = q_s + TILE;
  float* k_s = do_s + TILE;          // two stages
  float* v_s = k_s + 2 * TILE;       // two stages
  float* ds_s = v_s + 2 * TILE;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int nqt = (g.Tq + BM - 1) / BM;
  const int bh = blockIdx.x / nqt, r0 = (blockIdx.x - bh * nqt) * BM;
  const int b = bh / g.H, h = bh - b * g.H;
  const int nkt = (g.Tk + BN - 1) / BN;
  stage_tile(q_s, q, sq, b, h, r0, g.Tq);
  stage_tile(do_s, dout, sdo, b, h, r0, g.Tq);
  stage_tile(k_s, k, sk, b, h, 0, g.Tk);
  stage_tile(v_s, v, sv, b, h, 0, g.Tk);
  cp_async_commit();

  // rows ty * 8 + i: m, 1 / l and d_row (a half-warp's 16 lanes share
  // the rows; lane tx sums columns 4 tx .. 4 tx + 3)
  float m_i[8], il_i[8], dr_i[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = r0 + ty * 8 + i;
    const bool in = row < g.Tq;
    float part = 0.f;
    if (in) {
      const float4 a = *reinterpret_cast<const float4*>(
          dout + at(sdo, b, row, h) + 4 * tx);
      const float4 o = *reinterpret_cast<const float4*>(
          o32 + at(so, b, row, h) + 4 * tx);
      part = dot4(a, o, 0.f);
    }
    dr_i[i] = half_sum(part);
    m_i[i] = in ? m_in[(long long)bh * g.Tq + row] : NEG_INF;
    il_i[i] = 1.f / fmaxf(in ? l_in[(long long)bh * g.Tq + row] : 1.f,
                          1e-30f);
  }
  const float* bias_b = bias + (long long)b * g.Tk;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < nkt; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < nkt) {
      stage_tile(k_s + (st ^ 1) * TILE, k, sk, b, h, (kt + 1) * BN, g.Tk);
      stage_tile(v_s + (st ^ 1) * TILE, v, sv, b, h, (kt + 1) * BN, g.Tk);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* ks = k_s + st * TILE;
    const float* vs = v_s + st * TILE;
    float s[8][4], dp[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < 16; ++c) {
      float4 kb[4], vb[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kb[j] = *reinterpret_cast<const float4*>(ks + sw(4 * tx + j, c));
        vb[j] = *reinterpret_cast<const float4*>(vs + sw(4 * tx + j, c));
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 qa =
            *reinterpret_cast<const float4*>(q_s + sw(8 * ty + i, c));
        const float4 da =
            *reinterpret_cast<const float4*>(do_s + sw(8 * ty + i, c));
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = dot4(qa, kb[j], s[i][j]);
          dp[i][j] = dot4(da, vb[j], dp[i][j]);
        }
      }
    }
    // dS = p·(dP - d_row)·scale into shared memory (chunk tx of row)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float d[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kt * BN + 4 * tx + j;
        float x = col < g.Tk ? fmaf(s[i][j], g.scale, bias_b[col]) : -INFINITY;
        const float p = m_i[i] <= NEG_INF * 0.5f
                            ? 0.f
                            : expf(x - m_i[i]) * il_i[i];
        d[j] = p * (dp[i][j] - dr_i[i]) * g.scale;
      }
      *reinterpret_cast<float4*>(ds_s + sw(8 * ty + i, tx)) =
          make_float4(d[0], d[1], d[2], d[3]);
    }
    __syncthreads();
    // dQ += dS·K: columns 4 tx .. 4 tx + 3 of rows 8 ty + i
#pragma unroll 4
    for (int c = 0; c < 16; ++c) {
      float4 kb[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        kb[kk] = *reinterpret_cast<const float4*>(ks + sw(4 * c + kk, tx));
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 a =
            *reinterpret_cast<const float4*>(ds_s + sw(8 * ty + i, c));
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          acc[i][0] = fmaf(av[kk], kb[kk].x, acc[i][0]);
          acc[i][1] = fmaf(av[kk], kb[kk].y, acc[i][1]);
          acc[i][2] = fmaf(av[kk], kb[kk].z, acc[i][2]);
          acc[i][3] = fmaf(av[kk], kb[kk].w, acc[i][3]);
        }
      }
    }
    __syncthreads();  // stage st and ds_s are free
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = r0 + 8 * ty + i;
    if (row < g.Tq)
      *reinterpret_cast<float4*>(dq + at(sdq, b, row, h) + 4 * tx) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

}  // namespace

// design: 0 = fma, 1 = tf32x3. strides: (batch, time, head) element
// strides of q, k, v, o32, dout, dq (3 each); m, l, rowbuf as
// fused_attention.cu's backward. Every tensor float32 with D = 64 and
// 16-byte aligned rows. Returns the cudaError_t of the launch.
extern "C" int mxt_probe_fused_bwd_dq(
    int design, const void* q, const void* k, const void* v,
    const void* o32, const void* dout, const void* bias, const void* seed,
    const void* m, const void* l, void* rowbuf, void* dq,
    const long long* strides, int B, int H, int Tq, int Tk, float scale,
    void* stream) {
  const Geometry g = geometry(H, Tq, Tk, PD, scale, 1.f, 0u, 0, 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides sq = strides_at(strides, 0), sk = strides_at(strides, 1),
                sv = strides_at(strides, 2), so = strides_at(strides, 3),
                sdo = strides_at(strides, 4), sdq = strides_at(strides, 5);
  const unsigned blocks = (unsigned)((long long)B * H * ((Tq + BM - 1) / BM));
  if (design == 0) {
    const size_t smem = 7 * sizeof(float) * TILE;
    cudaError_t err = allow_smem(probe_dq_fma_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    probe_dq_fma_kernel<<<blocks, PT, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(o32),
        static_cast<const float*>(dout), static_cast<const float*>(bias),
        static_cast<const float*>(m), static_cast<const float*>(l),
        static_cast<float*>(dq), sq, sk, sv, so, sdo, sdq, g);
    return (int)cudaGetLastError();
  }
  const size_t smem = bwd_smem_bytes<float, 64>(false);
  cudaError_t err = allow_smem(fused_bwd_dq_kernel<float, 64>, smem);
  if (err != cudaSuccess) return (int)err;
  fused_bwd_dq_kernel<float, 64><<<blocks, THREADS, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o32),
      static_cast<const float*>(dout), static_cast<const float*>(bias),
      static_cast<const int*>(seed), static_cast<const float*>(m),
      static_cast<const float*>(l), static_cast<float*>(rowbuf), nullptr,
      static_cast<float*>(dq), sq, sk, sv, so, sdo, sdq,
      (long long)B * H * Tq, 16, g);
  return (int)cudaGetLastError();
}
