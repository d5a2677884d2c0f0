// Ragged paged attention for the serving engine: the span kernel (any
// number of live query rows per slot) and the single-query decode
// kernel, for float32 and bfloat16 page pools.
//
// Replaces the Pallas TPU kernels of mxnet_tpu/ops/pallas_attention.py:
//   ragged_span_kernel   <- _ragged_span_kernel   (ragged_span_attention)
//   ragged_decode_kernel <- _ragged_decode_kernel (ragged_decode_attention)
//
// Layouts (all contiguous):
//   q          (B, Sq, H, D) span, (B, H, D) decode
//   k/v pages  (N, S, H, D)   one layer's page pool
//   page_table (B, P) int32   physical page of each slot's logical page
//   lengths    (B,) int32     live keys of query row 0, its own included
//   q_counts   (B,) int32     live query rows per slot (span only)
//   out        like q, in q's dtype
// Query row j of slot b attends key positions < lengths[b] + j. Rows at
// or past q_counts[b] are dead and come out as exact zeros; a slot with
// q_counts 0 (span) or length 0 (decode) reads no page at all. The
// softmax runs online over the slot's pages in float32 with the
// reference's constants: masked scores are -1e30, a row whose running
// maximum is still masked contributes e = 0 (not exp(0)), and the
// denominator is clamped at 1e-30.
//
// What bounds these kernels on an H100: bytes. Each (slot, head) reads
// its live K and V pages once per query tile and does 2*D multiply-adds
// per (query row, key) pair; at decode (one row) that is 0.5 flop per
// byte of f32 K/V, and at a 64-row prefill chunk about 32, both far
// below the card's ~295 flop/byte ridge. The design therefore reads
// only what is live: the page loop ends at the furthest key the tile's
// last live row can see, dead tiles read nothing, and each page is
// staged once in shared memory and reused by every row of the tile.
// The products are plain FMA loops; wgmma, TMA, split-K over pages and
// vectorised loads are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int MAX_D = 128;                 // head dim limit (lane x 4)
constexpr int D_PER_LANE = MAX_D / 32;

constexpr int SPAN_THREADS = 128;          // 4 warps
constexpr int SPAN_WARPS = SPAN_THREADS / 32;
constexpr int SPAN_ROWS = 16;              // query rows per block
constexpr int ROWS_PER_WARP = SPAN_ROWS / SPAN_WARPS;

constexpr int DEC_THREADS = 128;
constexpr int DEC_WARPS = DEC_THREADS / 32;

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

// Stage one page's (S, D) slices of head h into shared memory as f32.
// K rows are padded to D + 1 floats so that lanes reading different
// rows at the same column hit different banks.
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

// One block per (slot b, head h, tile of SPAN_ROWS query rows); each
// warp owns ROWS_PER_WARP rows of the tile and keeps their running
// max, denominator and D-wide accumulator in registers.
template <typename T>
__global__ void __launch_bounds__(SPAN_THREADS) ragged_span_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ page_table,
    const int* __restrict__ lengths, const int* __restrict__ q_counts,
    T* __restrict__ out, int Sq, int H, int D, int S, int P,
    float scale) {
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int row0 = blockIdx.y * SPAN_ROWS;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int length = lengths[b];
  const int row_end = min(row0 + SPAN_ROWS, min(q_counts[b], Sq));

  if (row_end <= row0) {
    // every row of the tile is dead: exact zeros, no page read
    for (int i = tid; i < SPAN_ROWS * D; i += SPAN_THREADS) {
      const int r = row0 + i / D, d = i % D;
      if (r < Sq) out[((size_t)(b * Sq + r) * H + h) * D + d] = from_f32<T>(0.f);
    }
    return;
  }

  extern __shared__ float smem[];
  float* q_s = smem;                       // SPAN_ROWS x D
  float* k_s = q_s + SPAN_ROWS * D;        // S x (D + 1)
  float* v_s = k_s + S * (D + 1);          // S x D
  float* p_s = v_s + S * D;                // SPAN_ROWS x S

  for (int i = tid; i < SPAN_ROWS * D; i += SPAN_THREADS) {
    const int r = i / D, d = i - (i / D) * D;
    const int row = row0 + r;
    q_s[i] = row < row_end
                 ? to_f32(q[((size_t)(b * Sq + row) * H + h) * D + d])
                 : 0.f;
  }

  float m_i[ROWS_PER_WARP], l_i[ROWS_PER_WARP];
  float acc[ROWS_PER_WARP][D_PER_LANE];
#pragma unroll
  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    m_i[rr] = NEG_INF;
    l_i[rr] = 0.f;
#pragma unroll
    for (int j = 0; j < D_PER_LANE; ++j) acc[rr][j] = 0.f;
  }

  // the tile's last live row (row_end - 1) sees keys < length + row_end - 1
  const int n_pages = min((length + row_end - 1 + S - 1) / S, P);
  const int* table_b = page_table + (size_t)b * P;

  for (int p = 0; p < n_pages; ++p) {
    __syncthreads();  // the previous page is fully consumed
    stage_page<T>(k_pages, v_pages, table_b[p], h, S, H, D, k_s, v_s, tid,
                  SPAN_THREADS);
    __syncthreads();
    const int col0 = p * S;
#pragma unroll
    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
      const int r = warp * ROWS_PER_WARP + rr;
      const int row = row0 + r;
      const int limit = length + row;   // keys < limit are visible
      // a dead row, or a page wholly past the row's window, leaves the
      // row's state unchanged (e = 0 everywhere, alpha = 1): skip it
      if (row >= row_end || col0 >= limit) continue;
      float* prow = p_s + r * S;
      const float* qr = q_s + r * D;
      float mx = NEG_INF;
      for (int c = lane; c < S; c += 32) {
        float sc = NEG_INF;
        if (col0 + c < limit) {
          const float* kr = k_s + c * (D + 1);
          float dot = 0.f;
          for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
          sc = dot * scale;
        }
        prow[c] = sc;
        mx = fmaxf(mx, sc);
      }
      mx = warp_max(mx);
      const float m_new = fmaxf(m_i[rr], mx);
      const bool masked = m_new <= NEG_INF * 0.5f;
      float sum = 0.f;
      for (int c = lane; c < S; c += 32) {
        const float e = masked ? 0.f : expf(prow[c] - m_new);
        prow[c] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      const float alpha = masked ? 1.f : expf(m_i[rr] - m_new);
      l_i[rr] = l_i[rr] * alpha + sum;
      m_i[rr] = m_new;
      __syncwarp();  // every lane's probabilities are in prow
#pragma unroll
      for (int j = 0; j < D_PER_LANE; ++j) {
        const int d = lane + 32 * j;
        if (d < D) {
          float pv = 0.f;
          for (int c = 0; c < S; ++c) pv = fmaf(prow[c], v_s[c * D + d], pv);
          acc[rr][j] = acc[rr][j] * alpha + pv;
        }
      }
      __syncwarp();
    }
  }

#pragma unroll
  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    const int row = row0 + warp * ROWS_PER_WARP + rr;
    if (row >= Sq) continue;
    const bool live = row < row_end;
    const float inv = 1.f / fmaxf(l_i[rr], 1e-30f);
    T* o = out + ((size_t)(b * Sq + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D_PER_LANE; ++j) {
      const int d = lane + 32 * j;
      if (d < D) o[d] = from_f32<T>(live ? acc[rr][j] * inv : 0.f);
    }
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
    out[((size_t)b * H + h) * D + tid] = from_f32<T>(acc / fmaxf(l, 1e-30f));
}

size_t span_smem_bytes(int D, int S) {
  return sizeof(float) *
         ((size_t)SPAN_ROWS * D + (size_t)S * (D + 1) + (size_t)S * D +
          (size_t)SPAN_ROWS * S);
}

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

template <typename T>
int launch_span(const void* q, const void* k_pages, const void* v_pages,
                const int* page_table, const int* lengths,
                const int* q_counts, void* out, int B, int Sq, int H,
                int D, int S, int P, float scale, cudaStream_t stream) {
  if (D < 1 || D > MAX_D || S < 1) return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || H == 0) return (int)cudaSuccess;
  const size_t smem = span_smem_bytes(D, S);
  cudaError_t err = allow_smem(ragged_span_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (Sq + SPAN_ROWS - 1) / SPAN_ROWS);
  ragged_span_kernel<T><<<grid, SPAN_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), page_table, lengths, q_counts,
      static_cast<T*>(out), Sq, H, D, S, P, scale);
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

int mxt_ragged_span(const void* q, const void* k_pages, const void* v_pages,
                    const void* page_table, const void* lengths,
                    const void* q_counts, void* out, int B, int Sq, int H,
                    int D, int S, int P, float scale, int dtype,
                    void* stream) {
  const int* tbl = static_cast<const int*>(page_table);
  const int* lens = static_cast<const int*>(lengths);
  const int* qc = static_cast<const int*>(q_counts);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_span<float>(q, k_pages, v_pages, tbl, lens, qc, out, B, Sq,
                              H, D, S, P, scale, st);
  if (dtype == 1)
    return launch_span<__nv_bfloat16>(q, k_pages, v_pages, tbl, lens, qc, out,
                                      B, Sq, H, D, S, P, scale, st);
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
