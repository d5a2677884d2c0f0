// Ragged paged span attention on Hopper's tensor cores: bfloat16 q over
// bfloat16 pages or int8 pages with per-(page, head) float32 scales.
//
// Replaces, for bfloat16 q, the Pallas TPU kernels of
// mxnet_tpu/ops/pallas_attention.py:
//   ragged_span_tc_kernel<DP, false> <- _ragged_span_kernel
//                                       (ragged_span_attention)
//   ragged_span_tc_kernel<DP, true>  <- _ragged_span_quant_kernel
//                                       (ragged_span_attention(k_scale=,
//                                       v_scale=))
// float32 q keeps the CUDA-core kernel of ragged_attention.cu, and so do
// bfloat16 calls that the wrapper's route rule (ops/ragged_attention.py
// `span_route`) refuses: here D % 8 == 0 (padded to DP = 64 or 128 in
// shared memory), S % 16 == 0 and S <= 256, 16-byte aligned bases.
//
// Semantics and layouts are ragged_attention.cu's: row j of slot b sees
// keys < lengths[b] + j, masked scores are -1e30, a row whose running
// maximum is still masked takes e = 0 and alpha = 1, the denominator is
// clamped at 1e-30, dead rows and idle slots are exact zeros, and the
// split over pages and its combine are span_split.cuh's. Exponentials
// are ex2.approx of the log2e-scaled argument. Rounding of P, the A
// operand of P.V: over bfloat16 pages P is rounded once to bfloat16, as
// the Pallas float kernel does (e.astype(v.dtype)). The Pallas quant
// kernel keeps P in float32 against V dequantized to float32, and so
// does this kernel on int8 pages: P, with the page's v_scale folded in,
// is split into three bfloat16 terms (hi = bf16(p), mid = bf16(p - hi),
// lo = bf16(p - hi - mid), float32's 24 bits between them), and three
// RS wgmmas run against the same tile of V codes into one float32
// accumulator. The codes in [-127, 127] are exact in bfloat16, so V
// carries no rounding. (Two terms, 16 bits, still left outputs a
// bfloat16 rounding away from the plain version's on small inputs by
// more than 2e-3 of the largest value: PERF.md section 6.)
// The denominator sums the unscaled float32 e.
//
// What bounds it on an H100. A (slot, head) must read its live K and V
// pages once; at a 64-row prefill chunk that is about 32 flops a byte of
// bfloat16 K/V and at decode 0.5, below the tensor cores' ridge (~295):
// bytes, and at the serve's shapes (one to sixteen 16 KB pages a (slot,
// head)) the latency of reading them. Design:
//   * one warpgroup (128 threads) per (slot, head, 64-row query tile,
//     page split); the Q tile is staged once by cp.async into a 128-byte
//     swizzled tile (wgmma.cuh), rows at or past q_count zero-filled;
//   * keys in tiles of 64 consecutive positions of the slot, staged by
//     cp.async through a ring of three stages: every row finds its own
//     page through the table, so a tile spans pages when S < 64 and a
//     page spans tiles when S > 64. Two tiles are requested before the
//     loop and the third before the first product, so a slot of up to
//     three live pages (the serve's decode dispatches) has all of them
//     in flight at once;
//   * S = Q.K^T is a wgmma m64n64k16 with both operands in shared memory
//     (K-major); the causal-window mask and the online softmax run on the
//     float32 accumulator fragment in registers; P becomes the register A
//     operand of an RS wgmma against V read MN-major (bfloat16 pages: P
//     rounded; int8 pages: three wgmmas, one a bfloat16 term of P);
//   * int8 pages land as codes by cp.async at one byte an element (8-byte
//     copies) with their (page, head) scales beside them (one 4-byte copy
//     a key), and each thread widens the chunks it copied into the
//     swizzled bfloat16 K and V tiles: codes in [-127, 127] are exact in
//     bfloat16, so the widening is lossless. The scales stay out of the
//     products: the score fragment is multiplied by k_scale * softmax
//     scale of each key's page and P by its v_scale;
//   * a tile whose rows are all dead, and an idle slot, read no page.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "span_split.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BN = 64;        // keys of a tile
constexpr int THREADS = 128;  // one warpgroup
constexpr int STAGES = 3;     // key tiles in flight
constexpr float LOG2E = 1.4426950408889634f;

// Dynamic shared memory of one block (1024 bytes of alignment slack).
__host__ __device__ constexpr size_t tc_smem_bytes(int DP, bool quant) {
  return 1024 + (size_t)SPAN_TILE * DP * 2 +
         (quant ? 2 * (size_t)BN * DP * 2 +
                      STAGES * (2 * (size_t)BN * DP + 2 * BN * 4)
                : STAGES * 2 * (size_t)BN * DP * 2);
}

template <int DP, bool QUANT>
__global__ void __launch_bounds__(THREADS) ragged_span_tc_kernel(
    const bf16* __restrict__ q, const void* __restrict__ k_pages,
    const void* __restrict__ v_pages, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ page_table,
    const int* __restrict__ lengths, const int* __restrict__ q_counts,
    bf16* __restrict__ out, float* __restrict__ part,
    float2* __restrict__ ml, int* __restrict__ counters, int Sq, int H,
    int D, int S, int P, int pps, int n_split, float scale) {
  constexpr int NA = DP / 2;                  // accumulator floats of O
  constexpr int CPR = DP / 8;                 // 16-byte chunks of a row
  constexpr int RPP = THREADS / CPR;          // rows a pass covers
  constexpr int ROWS = BN / RPP;              // rows a thread copies
  constexpr uint32_t TB = BN * DP * 2;        // a bfloat16 tile
  constexpr uint32_t CB = BN * DP;            // a tile of int8 codes
  constexpr int PG = ROWS + QUANT;            // table entries a tile
  constexpr int PT = QUANT ? 3 : 1;           // bf16 terms of P in P.V
  const int tid = threadIdx.x;
  const int c = tid % CPR, r0 = tid / CPR;
  SpanWork w = span_block(Sq, H);
  const int* table_b = page_table + (size_t)w.b * P;
  // the physical page of each row this thread copies in tile t (and,
  // int8, of key tid % 64, whose scale it copies): requested one tile
  // ahead of the copy, the first two before the row state is known; the
  // reads are clamped to the table, and a table of no page is never read
  const int k0 = blockIdx.y * pps * S;
  auto page_of = [&](int key) {
    return P ? table_b[min(key / S, P - 1)] : 0;
  };
  auto fetch = [&](int t, int (&pg)[PG]) {
    const int kt0 = k0 + t * BN;
#pragma unroll
    for (int k = 0; k < ROWS; ++k) pg[k] = page_of(kt0 + r0 + k * RPP);
    if constexpr (QUANT) pg[ROWS] = page_of(kt0 + (tid & (BN - 1)));
  };
  int pg0[PG], pg1[PG], pg[PG];
  fetch(0, pg0);
  fetch(1, pg1);
  span_live(w, lengths, q_counts, Sq, S, P, pps);
  if (w.n_live == 0) {
    // no live row sees a key: exact zeros, no page read
    if (blockIdx.y == 0) span_zero_rows(w, out, w.row0, Sq, H, D);
    return;
  }
  if ((int)blockIdx.y >= w.n_live) return;   // past the live pages

  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* const smem = smem_raw + (q_s - smem_u32(smem_raw));
  // bfloat16 pages: K ring, V ring. int8 pages: the widened K and V
  // tiles, the code ring (K codes, V codes a stage), the scale ring
  // (64 k_scale, 64 v_scale a stage).
  const uint32_t k_ring = q_s + SPAN_TILE * DP * 2;
  const uint32_t v_ring = k_ring + (QUANT ? TB : STAGES * TB);
  const uint32_t code_ring = v_ring + TB;
  const uint32_t scale_ring = code_ring + STAGES * 2 * CB;
  const float* scale_s = reinterpret_cast<const float*>(
      smem + (scale_ring - q_s));

  const bool col = c * 8 < D;
  const int live = w.row_end - w.row0;
  const size_t head = (size_t)w.h * D + c * 8;   // elements into a row
  const int nt = (w.k1 - w.k0 + BN - 1) / BN;

  // Q: rows [row0, row0 + 64), dead ones zero-filled
  {
    const bf16* src = q + span_row(w, w.row0, Sq, H, D) + c * 8;
#pragma unroll
    for (int k = 0; k < SPAN_TILE / RPP; ++k) {
      const int r = r0 + k * RPP;
      const bool in = col && r < live;
      cp_async16(q_s + swizzled<SPAN_TILE>(r, c),
                 in ? src + (size_t)r * H * D : q, in ? 16 : 0);
    }
  }
  // key tile t (positions k0 + 64 t ...) into ring stage st, its pages
  // from fetch
  auto load = [&](int t, int st, const int (&pg)[PG]) {
    const int kt0 = w.k0 + t * BN;
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const int r = r0 + k * RPP, key = kt0 + r;
      const bool in = col && key < w.k1;
      size_t off = 0;   // elements of the row's chunk in the pools
      if (in)
        off = ((size_t)pg[k] * S + key % S) * H * D + head;
      if constexpr (QUANT) {
        const int8_t* kp = static_cast<const int8_t*>(k_pages);
        const int8_t* vp = static_cast<const int8_t*>(v_pages);
        const uint32_t dst = code_ring + st * 2 * CB + r * DP + c * 8;
        cp_async8(dst, kp + off, in ? 8 : 0);
        cp_async8(dst + CB, vp + off, in ? 8 : 0);
      } else {
        const bf16* kp = static_cast<const bf16*>(k_pages);
        const bf16* vp = static_cast<const bf16*>(v_pages);
        const uint32_t dst = swizzled<BN>(r, c);
        cp_async16(k_ring + st * TB + dst, kp + off, in ? 16 : 0);
        cp_async16(v_ring + st * TB + dst, vp + off, in ? 16 : 0);
      }
    }
    if constexpr (QUANT) {
      // thread t < 64 brings key t's k_scale, thread 64 + t its v_scale
      const int i = tid & (BN - 1), key = kt0 + i;
      const bool in = key < w.k1;
      const float* src = tid < BN ? k_scale : v_scale;
      if (in) src += (size_t)pg[ROWS] * H + w.h;
      cp_async4(scale_ring + (st * 2 * BN + tid) * 4, src, in ? 4 : 0);
    }
  };

  load(0, 0, pg0);
  cp_async_commit();   // Q and tile 0
  if (nt > 1) load(1, 1, pg1);
  cp_async_commit();
  if (nt > 2) fetch(2, pg);
  span_dead_rows(w, out, Sq, H, D);

  // this thread's rows (fragment halves 0 and 1) and their key limits
  int lim[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = frag_row(2 * i);
    lim[i] = r < live ? min(w.length + w.row0 + r, w.k1) : 0;
  }
  float m_i[2] = {SPAN_NEG_INF, SPAN_NEG_INF}, l_i[2] = {0.f, 0.f};
  float acc[NA], s[32];
#pragma unroll
  for (int j = 0; j < NA; ++j) acc[j] = 0.f;

  for (int t = 0; t < nt; ++t) {
    const int st = t % STAGES;
    if (t + 2 < nt) load(t + 2, (t + 2) % STAGES, pg);
    cp_async_commit();
    if (t + 3 < nt) fetch(t + 3, pg);
    cp_async_wait<2>();   // tile t (and at t = 0, Q)
    uint32_t kt = k_ring + st * TB, vt = v_ring + st * TB;
    if constexpr (QUANT) {
      // widen the chunks this thread copied into the bfloat16 tiles
      kt = k_ring;
      vt = v_ring;
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        const int r = r0 + k * RPP;
        const uint8_t* src = smem + (code_ring - q_s) + st * 2 * CB +
                             r * DP + c * 8;
#pragma unroll
        for (int kv = 0; kv < 2; ++kv) {
          const uint2 u = *reinterpret_cast<const uint2*>(src + kv * CB);
          const uint32_t x[2] = {u.x, u.y};
          uint32_t y[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const uint32_t word = x[e >> 1] >> (16 * (e & 1));
            y[e] = pack_bf16((float)(int8_t)(word & 0xff),
                             (float)(int8_t)(word >> 8));
          }
          *reinterpret_cast<uint4*>(smem + (kv ? vt : kt) - q_s +
                                    swizzled<BN>(r, c)) =
              make_uint4(y[0], y[1], y[2], y[3]);
        }
      }
    }
    fence_proxy_async();
    __syncthreads();   // tile t is in shared memory for every warp

    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss(s, kmajor_desc<SPAN_TILE>(q_s, kk), kmajor_desc<BN>(kt, kk),
               kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // per-key scales of this thread's 16 columns (2 nb + e)
    float ksc[16], vsc[16];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cl = frag_col(4 * nb + e);
        if constexpr (QUANT) {
          ksc[2 * nb + e] = scale_s[st * 2 * BN + cl] * scale;
          vsc[2 * nb + e] = scale_s[st * 2 * BN + BN + cl];
        } else {
          ksc[2 * nb + e] = scale;
          vsc[2 * nb + e] = 1.f;
        }
      }
    const int kt0 = w.k0 + t * BN;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int i = (j >> 1) & 1, e = 2 * (j >> 2) + (j & 1);
      s[j] = kt0 + frag_col(j) < lim[i] ? s[j] * ksc[e] : SPAN_NEG_INF;
    }
    // online softmax; a row whose max is still masked has a scaled max of
    // +inf, so its exponentials come out 0
    float alpha[2], ms[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m_i[i], row_max(s, i));
      const bool masked = m_new <= SPAN_NEG_INF * 0.5f;
      alpha[i] = masked ? 1.f : ex2((m_i[i] - m_new) * LOG2E);
      m_i[i] = m_new;
      ms[i] = masked ? INFINITY : m_new * LOG2E;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int i = (j >> 1) & 1, e = 2 * (j >> 2) + (j & 1);
      const float x = ex2(fmaf(s[j], LOG2E, -ms[i]));
      sum[i] += x;
      s[j] = x * vsc[e];
    }
    // alpha is common to a row's four threads: l stays a per-thread
    // partial sum until the end
#pragma unroll
    for (int i = 0; i < 2; ++i) l_i[i] = l_i[i] * alpha[i] + sum[i];
#pragma unroll
    for (int j = 0; j < NA; ++j) acc[j] *= alpha[(j >> 1) & 1];
    // float pages: P rounded once to bf16. int8 pages: P as PT bf16
    // terms, PT products against the same (exact) V tile into one
    // accumulator, issued and waited for together
    uint32_t pa[PT][4][4];
    to_a_frags_terms<PT>(s, pa);
    fence_regs(acc);
#pragma unroll
    for (int i = 0; i < PT; ++i) fence_regs(pa[i]);
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < PT; ++i)
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs(acc, pa[i][kk], mnmajor_desc<BN>(vt, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int i = 0; i < PT; ++i) fence_regs(pa[i]);
    __syncthreads();   // every warp is done with stage st (and the tiles)
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) l_i[i] = quad_sum(l_i[i]);
  if (w.n_live == 1) {
    // the only live split: the output itself, dead rows exact zeros
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = frag_row(2 * i), row = w.row0 + r;
      if (row >= Sq) continue;
      const bool dead = r >= live;
      const float f = 1.f / fmaxf(l_i[i], 1e-30f);
      bf16* o = out + span_row(w, row, Sq, H, D);
#pragma unroll
      for (int nb = 0; nb < NA / 4; ++nb) {
        const int d = frag_col(4 * nb);
        if (d >= D) continue;
        *reinterpret_cast<__nv_bfloat162*>(o + d) =
            dead ? __floats2bfloat162_rn(0.f, 0.f)
                 : __floats2bfloat162_rn(acc[4 * nb + 2 * i] * f,
                                         acc[4 * nb + 2 * i + 1] * f);
      }
    }
    return;
  }
  // partials of the live rows, then the combine in the last split
  const size_t p0 = part_index(w, blockIdx.y, n_split);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = frag_row(2 * i);
    if (r >= live) continue;
    float* a = part + (p0 + r) * D;
#pragma unroll
    for (int nb = 0; nb < NA / 4; ++nb) {
      const int d = frag_col(4 * nb);
      if (d < D)
        *reinterpret_cast<float2*>(a + d) =
            make_float2(acc[4 * nb + 2 * i], acc[4 * nb + 2 * i + 1]);
    }
    if ((tid & 3) == 0) ml[p0 + r] = make_float2(m_i[i], l_i[i]);
  }
  if (span_arrive(w, counters))
    span_combine(w, part, ml, out, Sq, H, D, n_split);
}

template <int DP, bool QUANT>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scale, const void* v_scale, const void* page_table,
           const void* lengths, const void* q_counts, void* out, void* part,
           void* ml, void* counters, int B, int Sq, int H, int D, int S,
           int P, int n_split, float scale, cudaStream_t stream) {
  auto kernel = ragged_span_tc_kernel<DP, QUANT>;
  const size_t smem = tc_smem_bytes(DP, QUANT);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H * ((Sq + SPAN_TILE - 1) / SPAN_TILE), n_split);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), k_pages, v_pages,
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int*>(page_table), static_cast<const int*>(lengths),
      static_cast<const int*>(q_counts), static_cast<bf16*>(out),
      static_cast<float*>(part), static_cast<float2*>(ml),
      static_cast<int*>(counters), Sq, H, D, S, P,
      (P + n_split - 1) / n_split, n_split, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes: the signature of ragged_attention.cu's
// mxt_ragged_span, for bfloat16 q (dtype 1) only. Returns the
// cudaError_t of the launch (0 = launched). tc_smem_bytes is mirrored by
// ops/ragged_attention.py.
extern "C" int mxt_ragged_span_tc(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* page_table,
    const void* lengths, const void* q_counts, void* out, void* part,
    void* ml, void* counters, int B, int Sq, int H, int D, int S, int P,
    int n_split, float scale, int dtype, int quant, void* stream) {
  if (dtype != 1 || D < 8 || D > 128 || D % 8 || S < 16 || S % 16 ||
      S > 256 || n_split < 1 || n_split > SPAN_MAX_SPLITS ||
      (n_split > 1 && !counters))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || H == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MXT_TC(DP, QUANT)                                                   \
  return launch<DP, QUANT>(q, k_pages, v_pages, k_scale, v_scale,          \
                           page_table, lengths, q_counts, out, part, ml,   \
                           counters, B, Sq, H, D, S, P, n_split, scale, st)
  if (D <= 64) {
    if (quant) MXT_TC(64, true);
    MXT_TC(64, false);
  }
  if (quant) MXT_TC(128, true);
  MXT_TC(128, false);
#undef MXT_TC
}
