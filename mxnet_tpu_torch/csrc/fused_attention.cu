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
//            tiles, keeps the online-softmax state (m, l, a DP-wide
//            accumulator) in registers, writes O and the row statistics
//            m, l (float32, (B, H, Tq)).
//   backward d_row = rowsum(dO ⊙ O) (equal to the reference's Σ a·da),
//            read from a float32 O (for bfloat16 the forward writes a
//            float32 copy, so a row with one live key gets ds = 0
//            exactly, as in the reference, instead of the rounding of O),
//            then one block per (b, h, 64-query tile) for dQ, and one
//            block per (b, h, 64-key tile) that loops over query tiles
//            for dK and dV. No atomics: the results are deterministic.
//            The dQ kernel runs first and writes the row statistics and,
//            with dropout, the keep bits that the second reads instead of
//            hashing again.
//   Causal tiles stop at the diagonal (forward, dQ) or start there (dK,
//   dV). Every kernel: 128 threads, four warps of 16 rows, the score
//   tiles in the accumulator layout of the tensor-core kernels, whose
//   per-element work (attention_common.cuh: softmax_tile, ds_tile,
//   grads_tile, store_keep) they share.
//
// What bounds it on an H100: operations. At BERT-base shapes (T = 512,
// D = 64) a (b, h) cell does 4·T²·D flops forward on 4·T·D values read
// or written and 10·T²·D backward on 7·T·D: 128 and ~180 flops per
// float32 byte, far above the float32 ridge (~20); in bfloat16 (256 and
// ~360 per byte) near the tensor cores' ridge (~295). float32 is held to
// 1e-5 (forward) and 1e-4 (gradients), which one TF32 rounding of the
// operands misses (~3e-4 of a product). So every product runs on the
// tensor cores as mma.sync m16n8k8 TF32 in split form: each float32
// operand is hi + lo TF32 terms and each product hi·hi + hi·lo + lo·hi,
// float32 sums, which keeps float32's accuracy at three tensor-core
// products a step (bfloat16 operands are exact in TF32 and take one);
// exponentials are ex2.approx of the log2e-scaled argument. Tiles are
// staged by cp.async (16-byte copies where rows, strides and bases
// allow, narrower ones else) with rows padded to 16 bytes past a
// multiple of 128, so every fragment load meets each bank once; S (and
// dS) stay in registers, and P·V, dS·K and Pᵀ·dO take them as A
// fragments as they stand (the fragment's k index permuted within each
// 8-key step). A probe against register-tiled CUDA-core FMAs on the dQ
// pass is in fused_bwd_probe.cu, one of the forward's K/V stage counts
// in fused_fwd_probe.cu.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_common.cuh"

namespace {

constexpr int MAX_D = 128;
constexpr int THREADS = 128;         // four warps, 16 rows of a tile each
// K/V stages of the forward: one at three blocks an SM hides a block's
// copies behind the others' products (fused_fwd_probe.cu times two)
constexpr int FWD_STAGES = 1;

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

// --------------------------------------------------------------------------
// products on the tensor cores in split TF32, and tile staging
// --------------------------------------------------------------------------

// A staged 64-row tile of DP columns: row stride DP + 4 floats or DP + 8
// bfloat16, 16 bytes past a multiple of 128, so that a fragment load (8
// rows x 4 columns, or 4 row pairs x 8 columns) meets 32 banks once.
template <typename T, int DP>
struct Tile {
  static constexpr int LD = DP + 16 / (int)sizeof(T);
  static constexpr int ELEMS = 64 * LD;
};

// x as TF32 terms, passed to mma.sync as raw float32 bits (the tensor
// cores read a TF32 operand's top 19 bits and ignore the 13 below): hi =
// x, read as x truncated to TF32, and with SPLIT lo = x - that truncation,
// exact in float32 and read truncated in turn (2^-21 of x at most lost).
// Two integer and float operations an element, where cvt.rna.tf32.f32
// for both terms was measurably slower.
template <bool SPLIT>
__device__ __forceinline__ void tf32_terms(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x);
  lo = SPLIT ? __float_as_uint(x - __uint_as_float(hi & 0xffffe000u)) : 0u;
}

// d (16 x 8, the accumulator layout) += a (16 x 8) · b (8 x 8).
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One k-step of 8: with SPLIT (float32 operands) the three products
// lo·hi + hi·lo + hi·hi of the operands' TF32 terms (the dropped lo·lo is
// 2^-20 of the product at most); without (bfloat16 operands, exact in
// TF32) hi·hi alone.
template <bool SPLIT>
__device__ __forceinline__ void mma_step(float* d, const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4],
                                         uint32_t bh0, uint32_t bh1,
                                         uint32_t bl0, uint32_t bl1) {
  if constexpr (SPLIT) {
    mma_tf32(d, al, bh0, bh1);
    mma_tf32(d, ah, bl0, bl1);
  }
  mma_tf32(d, ah, bh0, bh1);
}

// One k-step with the small terms kept apart (SPLIT only): c += lo·hi +
// hi·lo, d += hi·hi. The tensor cores truncate each sum they
// accumulate; summed into d, the two correction products would add two
// truncations at d's magnitude a step, while in c they truncate at
// 2^-10 of it.
__device__ __forceinline__ void mma_step_apart(float* d, float* c,
                                               const uint32_t (&ah)[4],
                                               const uint32_t (&al)[4],
                                               uint32_t bh0, uint32_t bh1,
                                               uint32_t bl0, uint32_t bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// acc (16 x 64) = X·Yᵀ over DP columns: X this warp's 16 rows of a staged
// tile, Y all 64 rows of another (S = Q·Kᵀ and dP = dO·Vᵀ; Sᵀ = K·Qᵀ and
// dPᵀ = V·dOᵀ in the dK/dV kernel). acc is in the accumulator layout
// (frag_row, frag_col), eight 8-column blocks. APART (the forward's S in
// float32, held to 1e-5) sums the correction products in 32 more
// registers (mma_step_apart).
template <typename T, int DP, bool APART = false>
__device__ __forceinline__ void product_xyt(float (&acc)[32], const T* x,
                                            const T* y) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr bool SEP = SPLIT && APART;
  float corr[SEP ? 32 : 1];
#pragma unroll
  for (int j = 0; j < (SEP ? 32 : 1); ++j) corr[j] = 0.f;
  constexpr int LD = Tile<T, DP>::LD;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const T* xr = x + (16 * (threadIdx.x >> 5) + g) * LD + t;
  const T* yr = y + g * LD + t;
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk) {
    uint32_t ah[4], al[4];
    tf32_terms<SPLIT>(to_f32(xr[8 * kk]), ah[0], al[0]);
    tf32_terms<SPLIT>(to_f32(xr[8 * LD + 8 * kk]), ah[1], al[1]);
    tf32_terms<SPLIT>(to_f32(xr[8 * kk + 4]), ah[2], al[2]);
    tf32_terms<SPLIT>(to_f32(xr[8 * LD + 8 * kk + 4]), ah[3], al[3]);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const T* yb = yr + 8 * nb * LD + 8 * kk;
      uint32_t bh0, bl0, bh1, bl1;
      tf32_terms<SPLIT>(to_f32(yb[0]), bh0, bl0);
      tf32_terms<SPLIT>(to_f32(yb[4]), bh1, bl1);
      if constexpr (SEP)
        mma_step_apart(acc + 4 * nb, corr + 4 * nb, ah, al, bh0, bh1, bl0,
                       bl1);
      else
        mma_step<SPLIT>(acc + 4 * nb, ah, al, bh0, bh1, bl0, bl1);
    }
  }
  if constexpr (SEP) {
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] += corr[j];
  }
}

// acc (16 x DP) += A·Y: A this warp's 16 x 64 tile in the accumulator
// layout (dS or P, in registers), Y a staged 64-row tile. Within each
// 8-key step the A fragment's columns t and t + 4 are keys 2t and 2t + 1,
// so that the accumulator registers are the fragment as they stand; the
// B fragment takes Y's rows of the same keys.
template <typename T, int DP>
__device__ __forceinline__ void product_ay(float (&acc)[DP / 2],
                                           const float (&a)[32],
                                           const T* y) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr int LD = Tile<T, DP>::LD;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const T* yr = y + 2 * t * LD + g;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    uint32_t ah[4], al[4];
    tf32_terms<SPLIT>(a[4 * kk], ah[0], al[0]);
    tf32_terms<SPLIT>(a[4 * kk + 2], ah[1], al[1]);
    tf32_terms<SPLIT>(a[4 * kk + 1], ah[2], al[2]);
    tf32_terms<SPLIT>(a[4 * kk + 3], ah[3], al[3]);
#pragma unroll
    for (int nb = 0; nb < DP / 8; ++nb) {
      const T* yb = yr + 8 * kk * LD + 8 * nb;
      uint32_t bh0, bl0, bh1, bl1;
      tf32_terms<SPLIT>(to_f32(yb[0]), bh0, bl0);
      tf32_terms<SPLIT>(to_f32(yb[LD]), bh1, bl1);
      mma_step<SPLIT>(acc + 4 * nb, ah, al, bh0, bh1, bl0, bl1);
    }
  }
}

// acc (16 x DP) = acc·alpha[row half] + A·Y: the forward's P·V of one key
// tile, with A (P) and Y (V) as in product_ay, but A·Y summed over this
// tile alone in fresh registers and then added in float32. The tensor
// cores truncate each sum they accumulate, so a running accumulator
// carried across every key tile took 3 truncations a k-step at the
// magnitude of the unnormalised output (up to l times the output),
// about 1e-5 of the output at BERT-base shapes; a tile's own sum holds
// its truncations at the tile's magnitude (the correction products
// apart, mma_step_apart). A's TF32 terms are formed once (the hi terms
// are P's own bits), and the loop runs over output columns outermost so
// that each sum needs eight registers.
template <typename T, int DP>
__device__ __forceinline__ void rescale_add_ay(float (&acc)[DP / 2],
                                               const float (&alpha)[2],
                                               const float (&a)[32],
                                               const T* y) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr int LD = Tile<T, DP>::LD;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const T* yr = y + 2 * t * LD + g;
  uint32_t ah[32], al[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) tf32_terms<SPLIT>(a[j], ah[j], al[j]);
#pragma unroll
  for (int nb = 0; nb < DP / 8; ++nb) {
    float d[4] = {0.f, 0.f, 0.f, 0.f}, c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint32_t fh[4] = {ah[4 * kk], ah[4 * kk + 2], ah[4 * kk + 1],
                              ah[4 * kk + 3]};
      const uint32_t fl[4] = {al[4 * kk], al[4 * kk + 2], al[4 * kk + 1],
                              al[4 * kk + 3]};
      const T* yb = yr + 8 * kk * LD + 8 * nb;
      uint32_t bh0, bl0, bh1, bl1;
      tf32_terms<SPLIT>(to_f32(yb[0]), bh0, bl0);
      tf32_terms<SPLIT>(to_f32(yb[LD]), bh1, bl1);
      if constexpr (SPLIT)
        mma_step_apart(d, c, fh, fl, bh0, bh1, bl0, bl1);
      else
        mma_step<SPLIT>(d, fh, fl, bh0, bh1, bl0, bl1);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[4 * nb + e] = fmaf(acc[4 * nb + e], alpha[e >> 1], d[e] + c[e]);
  }
}

// Copies 64-row tiles of one head (b, h) of a (batch, time, head)-strided
// tensor into staged tiles: thread t moves `unit` bytes at column t % cpr
// of rows t / cpr + k·(128 / cpr), by cp.async for 16, 8 or 4 bytes (the
// caller commits) or a plain 2-byte copy; rows past the extent are zero.
// Columns [D, DP) are zero_pad's.
template <typename T, int DP>
struct RowCopier {
  const uint8_t* src;  // this thread's chunk at time 0
  long long st;        // time stride in bytes
  int unit, r0, rpp, col;
  bool active;

  __device__ __forceinline__ RowCopier(const T* x, const Strides& s, int b,
                                       int h, int D, int unit_) {
    unit = unit_;
    const int cpr = D * (int)sizeof(T) / unit;
    rpp = THREADS / cpr;
    r0 = threadIdx.x / cpr;
    col = (threadIdx.x - r0 * cpr) * unit;
    active = threadIdx.x < rpp * cpr;
    st = s.t * (long long)sizeof(T);
    src = reinterpret_cast<const uint8_t*>(x + at(s, b, 0, h)) + col;
  }

  // rows [t0, t0 + 64) into the tile at dst
  __device__ __forceinline__ void copy(T* dst, int t0, int n) const {
    if (!active) return;
    constexpr int RB = Tile<T, DP>::LD * (int)sizeof(T);
    uint8_t* d = reinterpret_cast<uint8_t*>(dst) + col;
    for (int r = r0; r < 64; r += rpp) {
      const bool in = t0 + r < n;
      const uint8_t* p = in ? src + (long long)(t0 + r) * st : src;
      uint8_t* dr = d + r * RB;
      const uint32_t ds = smem_u32(dr);
      if (unit == 16)
        cp_async16(ds, p, in ? 16 : 0);
      else if (unit == 8)
        cp_async8(ds, p, in ? 8 : 0);
      else if (unit == 4)
        cp_async4(ds, p, in ? 4 : 0);
      else
        *reinterpret_cast<uint16_t*>(dr) =
            in ? *reinterpret_cast<const uint16_t*>(p) : (uint16_t)0;
    }
  }
};

// Zeros columns [D, DP) of `count` consecutive staged tiles: the k-steps
// of the products run to DP.
template <typename T, int DP>
__device__ __forceinline__ void zero_pad(T* tiles, int count, int D) {
  constexpr int LD = Tile<T, DP>::LD;
  const int w = DP - D;
  for (int i = threadIdx.x; i < count * 64 * w; i += THREADS) {
    const int r = i / w;
    tiles[r * LD + D + (i - r * w)] = from_f32<T>(0.f);
  }
}

// Store this thread's part of a 64 x DP accumulator, times f[row half],
// as rows t0 + frag_row (those below n), columns below D; and as float32
// into x32 when it is given.
template <typename T, int NA>
__device__ __forceinline__ void store_acc(const float (&acc)[NA],
                                          const float (&f)[2], T* x,
                                          float* x32, const Strides& s,
                                          int b, int h, int t0, int n,
                                          int D) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = t0 + frag_row(2 * i);
    if (t >= n) continue;
    const long long base = at(s, b, t, h);
#pragma unroll
    for (int nb = 0; nb < NA / 4; ++nb) {
      const int d = frag_col(4 * nb);
      const float v0 = acc[4 * nb + 2 * i] * f[i];
      const float v1 = acc[4 * nb + 2 * i + 1] * f[i];
      if (d < D) x[base + d] = from_f32<T>(v0);
      if (d + 1 < D) x[base + d + 1] = from_f32<T>(v1);
      if (x32 && d < D) x32[base + d] = v0;
      if (x32 && d + 1 < D) x32[base + d + 1] = v1;
    }
  }
}

// --------------------------------------------------------------------------
// forward
// --------------------------------------------------------------------------

// One block per (b, h, 64-query tile), four warps of 16 rows. Over the
// key tiles (to the causal diagonal): S = Q·Kᵀ (product_xyt), the online
// softmax on the fragment (softmax_tile: bias, causal test, the
// pre-dropout partial l, the keep hash; alpha rescales the accumulator
// per row), then O = O·alpha + P·V (rescale_add_ay) with P taken from
// registers as it stands, rounded to T first (bfloat16: the reference's rounding point
// before its MXU product; float32 takes none). Q is staged once, K and V
// tiles through STAGES cp.async stages (with two, tile kt + 1 is in
// flight while tile kt is multiplied). At DP = 64 in float32 one stage
// takes 52 KB of shared memory; at most 168 registers a thread put three
// blocks on an SM.
template <typename T, int DP, int STAGES>
__global__ void __launch_bounds__(THREADS, 3) fused_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ bias,
    const int* __restrict__ seed, T* __restrict__ o, float* __restrict__ o32,
    float* __restrict__ m_out, float* __restrict__ l_out, Strides sq,
    Strides sk, Strides sv, Strides so, int unit, Geometry g) {
  constexpr int TE = Tile<T, DP>::ELEMS;
  extern __shared__ __align__(16) uint8_t fwd_smem[];
  T* q_s = reinterpret_cast<T*>(fwd_smem);
  T* k_s = q_s + TE;                 // STAGES tiles
  T* v_s = k_s + STAGES * TE;        // STAGES tiles

  const int nqt = (g.Tq + BM - 1) / BM;
  const int bh = blockIdx.x / nqt, r0 = (blockIdx.x - bh * nqt) * BM;
  const int b = bh / g.H, h = bh - b * g.H;
  const int rows[2] = {r0 + frag_row(0), r0 + frag_row(2)};
  const int n = key_tiles(g, r0);
  const RowCopier<T, DP> kc(k, sk, b, h, g.D, unit),
      vc(v, sv, b, h, g.D, unit);
  auto load_kv = [&](int t) {
    kc.copy(k_s + (t % STAGES) * TE, t * BN, g.Tk);
    vc.copy(v_s + (t % STAGES) * TE, t * BN, g.Tk);
  };
  RowCopier<T, DP>(q, sq, b, h, g.D, unit).copy(q_s, r0, g.Tq);
#pragma unroll
  for (int t = 0; t < STAGES; ++t) {  // one group a tile, Q in the first
    if (t < n) load_kv(t);
    cp_async_commit();
  }
  zero_pad<T, DP>(q_s, 1 + 2 * STAGES, g.D);

  const uint32_t s0 = (uint32_t)seed[0];
  const uint32_t s1 = (uint32_t)seed[1] ^ (uint32_t)bh;
  const float* bias_b = bias + (long long)b * g.Tk;
  float m_i[2] = {NEG_INF, NEG_INF}, l_i[2] = {0.f, 0.f}, alpha[2];
  float acc[DP / 2], s[32], bc[16];
#pragma unroll
  for (int j = 0; j < DP / 2; ++j) acc[j] = 0.f;
  for (int kt = 0; kt < n; ++kt) {
    const int st = kt % STAGES;
    load_bias(bc, bias_b, kt * BN, g.Tk);
    cp_async_wait<STAGES - 1>();  // Q (and the pads) and key tile kt
    __syncthreads();
    product_xyt<T, DP, true>(s, q_s, k_s + st * TE);
    softmax_tile(s, bc, g, kt * BN, rows, m_i, l_i, alpha, s0, s1);
    if constexpr (!std::is_same<T, float>::value) {
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] = round_to<T>(s[j]);
    }
    rescale_add_ay<T, DP>(acc, alpha, s, v_s + st * TE);
    __syncthreads();  // every warp is done with stage st
    if (kt + STAGES < n) load_kv(kt + STAGES);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // fully masked rows: l = 0 and acc = 0, so the output is exactly 0
  float f[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_i[i] = quad_sum(l_i[i]);
    f[i] = g.inv_keep / fmaxf(l_i[i], 1e-30f);
  }
  store_acc<T>(acc, f, o, o32, so, b, h, r0, g.Tq, g.D);
  if ((threadIdx.x & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (rows[i] < g.Tq) {
        m_out[(long long)bh * g.Tq + rows[i]] = m_i[i];
        l_out[(long long)bh * g.Tq + rows[i]] = l_i[i];
      }
  }
}

// --------------------------------------------------------------------------
// backward: dQ and dK/dV
// --------------------------------------------------------------------------

// One block per (b, h, 64-query tile): d_row = rowsum(dO ⊙ O) and the
// row statistics the dK/dV kernel reads (rowbuf: float32 (2, B, H, Tq),
// [0] = lse = m·log2e + log2(max(l, 1e-30)), +inf for a dead row, [1] =
// d_row·scale), then over the key tiles: S = Q·Kᵀ and dP = dO·Vᵀ,
// dS = p·scale·(dP - d_row) on the fragment (ds_tile, which also hands
// the dropout keep bits to `keep`, 32 keys a word), dQ += dS·K. One stage
// of K and V: 70 KB of shared memory at DP = 64 in float32 and at most
// 168 registers a thread put three blocks on an SM, which hide each
// other's copies (a second stage, and so two blocks an SM, was slower).
template <typename T, int DP>
__global__ void __launch_bounds__(THREADS, 3) fused_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ o32,
    const T* __restrict__ dout, const float* __restrict__ bias,
    const int* __restrict__ seed, const float* __restrict__ m_in,
    const float* __restrict__ l_in, float* __restrict__ rowbuf,
    uint32_t* __restrict__ keep, T* __restrict__ dq, Strides sq,
    Strides sk, Strides sv, Strides so, Strides sdo, Strides sdq,
    long long bht, int unit, Geometry g) {
  constexpr int TE = Tile<T, DP>::ELEMS;
  extern __shared__ __align__(16) uint8_t bwd_smem[];
  T* q_s = reinterpret_cast<T*>(bwd_smem);
  T* do_s = q_s + TE;
  T* k_s = do_s + TE;
  T* v_s = k_s + TE;

  const int nqt = (g.Tq + BM - 1) / BM;
  const int bh = blockIdx.x / nqt, r0 = (blockIdx.x - bh * nqt) * BM;
  const int b = bh / g.H, h = bh - b * g.H;
  const int rows[2] = {r0 + frag_row(0), r0 + frag_row(2)};
  const int n = key_tiles(g, r0);
  const long long row0 = (long long)bh * g.Tq;
  const RowCopier<T, DP> kc(k, sk, b, h, g.D, unit),
      vc(v, sv, b, h, g.D, unit);
  RowCopier<T, DP>(q, sq, b, h, g.D, unit).copy(q_s, r0, g.Tq);
  RowCopier<T, DP>(dout, sdo, b, h, g.D, unit).copy(do_s, r0, g.Tq);
  if (n > 0) {
    kc.copy(k_s, 0, g.Tk);
    vc.copy(v_s, 0, g.Tk);
  }
  cp_async_commit();
  zero_pad<T, DP>(q_s, 4, g.D);

  // per row: lsq (ds_tile's) and d_row = Σ dO·O
  const float log2_scale = log2f(g.scale);
  float lsq[2], dr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = rows[i];
    const bool in = row < g.Tq;
    float part = 0.f;
    if (in) {
      const T* dorow = dout + at(sdo, b, row, h);
      const float* orow = o32 + at(so, b, row, h);
#pragma unroll
      for (int nb = 0; nb < DP / 8; ++nb) {
        const int d = frag_col(4 * nb);
        if (d < g.D) part = fmaf(to_f32(dorow[d]), orow[d], part);
        if (d + 1 < g.D) part = fmaf(to_f32(dorow[d + 1]), orow[d + 1], part);
      }
    }
    dr[i] = quad_sum(part);
    const long long ri = row0 + row;
    const float m = in ? m_in[ri] : NEG_INF;
    const float lse =
        m <= NEG_INF * 0.5f
            ? INFINITY
            : fmaf(m, LOG2E, log2f(fmaxf(in ? l_in[ri] : 1.f, 1e-30f)));
    lsq[i] = lse - log2_scale;
    if (in && (threadIdx.x & 3) == 0) {
      rowbuf[ri] = lse;
      rowbuf[bht + ri] = dr[i] * g.scale;
    }
  }

  const uint32_t s0 = (uint32_t)seed[0];
  const uint32_t s1 = (uint32_t)seed[1] ^ (uint32_t)bh;
  const float* bias_b = bias + (long long)b * g.Tk;
  float acc[DP / 2], s[32], da[32], bc[16];
#pragma unroll
  for (int j = 0; j < DP / 2; ++j) acc[j] = 0.f;
  for (int kt = 0; kt < n; ++kt) {
    if (kt > 0) {
      kc.copy(k_s, kt * BN, g.Tk);
      vc.copy(v_s, kt * BN, g.Tk);
      cp_async_commit();
    }
    load_bias(bc, bias_b, kt * BN, g.Tk);
    cp_async_wait<0>();  // Q, dO (and the pads) and key tile kt
    __syncthreads();
    product_xyt<T, DP>(s, q_s, k_s);
    product_xyt<T, DP>(da, do_s, v_s);
    uint32_t bits[2][2] = {{0u, 0u}, {0u, 0u}};
    ds_tile(s, da, bc, g, kt * BN, rows, lsq, dr, s0, s1, bits);
    if (g.dropout) store_keep(bits, keep, g, row0, rows, kt);
    if constexpr (!std::is_same<T, float>::value) {
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] = round_to<T>(s[j]);
    }
    product_ay<T, DP>(acc, s, k_s);
    __syncthreads();  // every warp is done with key tile kt
  }
  cp_async_wait<0>();
  const float one[2] = {1.f, 1.f};
  store_acc<T>(acc, one, dq, nullptr, sdq, b, h, r0, g.Tq, g.D);
}

// One block per (b, h, 64-key tile): over the query tiles (from the
// causal diagonal), Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (rows are this block's
// keys), Pᵀ and dSᵀ on the fragment from the dQ kernel's row statistics
// and keep bits (grads_tile), then dV += Pᵀ·dO and dK += dSᵀ·Q. One
// stage of Q, dO and the statistics, three blocks an SM, as in the dQ
// kernel. No atomics: dK and dV are summed in one block, in query
// order.
template <typename T, int DP>
__global__ void __launch_bounds__(THREADS, 3) fused_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ bias, const float* __restrict__ rowbuf,
    const uint32_t* __restrict__ keep, T* __restrict__ dk,
    T* __restrict__ dv, Strides sq, Strides sk, Strides sv, Strides sdo,
    Strides sdk, Strides sdv, long long bht, int unit, Geometry g) {
  constexpr int TE = Tile<T, DP>::ELEMS;
  extern __shared__ __align__(16) uint8_t bwd_smem[];
  T* k_s = reinterpret_cast<T*>(bwd_smem);
  T* v_s = k_s + TE;
  T* q_s = v_s + TE;
  T* do_s = q_s + TE;
  // lse and d_row·scale of the tile's 64 rows, then two keep words a row
  float* stats = reinterpret_cast<float*>(do_s + TE);

  const int nkt = (g.Tk + BN - 1) / BN;
  const int bh = blockIdx.x / nkt, kt = blockIdx.x - bh * nkt;
  const int c0 = kt * BN;
  const int b = bh / g.H, h = bh - b * g.H;
  const int keys[2] = {c0 + frag_row(0), c0 + frag_row(2)};
  const int nqt = (g.Tq + BM - 1) / BM;
  int first = 0;  // causal: the first query tile that sees key c0
  if (g.causal) {
    const int r = c0 - (g.Tk - g.Tq);
    first = r <= 0 ? 0 : min(nqt, r / BM);
  }
  const long long row0 = (long long)bh * g.Tq;
  const int nw = (g.Tk + 31) / 32;
  // this thread's keys sit in word (threadIdx.x / 64) of a row's two, at
  // bits 16 (warp % 2) + lane / 4 and that + 8
  const uint32_t kbit[2] = {1u << (16 * ((threadIdx.x >> 5) & 1) +
                                   ((threadIdx.x & 31) >> 2)),
                            1u << (16 * ((threadIdx.x >> 5) & 1) +
                                   ((threadIdx.x & 31) >> 2) + 8)};
  const RowCopier<T, DP> qc(q, sq, b, h, g.D, unit),
      dc(dout, sdo, b, h, g.D, unit);
  auto load_q = [&](int qt) {
    const int r0 = qt * BM;
    qc.copy(q_s, r0, g.Tq);
    dc.copy(do_s, r0, g.Tq);
    float* sm = stats;
    {
      const int which = threadIdx.x / BM, r = threadIdx.x - which * BM;
      const bool in = r0 + r < g.Tq;
      const float* src = rowbuf + which * bht + row0 + r0 + r;
      cp_async4(smem_u32(sm + threadIdx.x), in ? src : rowbuf, in ? 4 : 0);
    }
    if (g.dropout) {
      const int r = threadIdx.x >> 1, w = 2 * kt + (threadIdx.x & 1);
      const bool in = r0 + r < g.Tq && w < nw;
      cp_async4(smem_u32(sm + 2 * BM + threadIdx.x),
                in ? keep + (row0 + r0 + r) * nw + w : keep, in ? 4 : 0);
    }
  };

  RowCopier<T, DP>(k, sk, b, h, g.D, unit).copy(k_s, c0, g.Tk);
  RowCopier<T, DP>(v, sv, b, h, g.D, unit).copy(v_s, c0, g.Tk);
  if (first < nqt) load_q(first);
  cp_async_commit();
  zero_pad<T, DP>(k_s, 4, g.D);

  float bkey[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    bkey[i] = keys[i] < g.Tk ? bias[(long long)b * g.Tk + keys[i]] : 0.f;
  float dk_acc[DP / 2], dv_acc[DP / 2], s[32], da[32];
#pragma unroll
  for (int j = 0; j < DP / 2; ++j) dk_acc[j] = dv_acc[j] = 0.f;
  for (int qt = first; qt < nqt; ++qt) {
    if (qt > first) {
      load_q(qt);
      cp_async_commit();
    }
    cp_async_wait<0>();  // K, V (and the pads) and query tile qt
    __syncthreads();
    product_xyt<T, DP>(s, k_s, q_s);
    product_xyt<T, DP>(da, v_s, do_s);
    grads_tile(s, da, stats, bkey, g, qt * BM, keys, kbit);
    if constexpr (!std::is_same<T, float>::value) {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        s[j] = round_to<T>(s[j]);
        da[j] = round_to<T>(da[j]);
      }
    }
    product_ay<T, DP>(dv_acc, s, do_s);
    product_ay<T, DP>(dk_acc, da, q_s);
    __syncthreads();  // every warp is done with query tile qt
  }
  cp_async_wait<0>();
  const float one[2] = {1.f, 1.f};
  store_acc<T>(dk_acc, one, dk, nullptr, sdk, b, h, c0, g.Tk, g.D);
  store_acc<T>(dv_acc, one, dv, nullptr, sdv, b, h, c0, g.Tk, g.D);
}

// The forward's dynamic shared memory: Q and STAGES tiles each of K and V.
template <typename T, int DP, int STAGES>
size_t fwd_smem_bytes() {
  return (1 + 2 * STAGES) * sizeof(T) * (size_t)Tile<T, DP>::ELEMS;
}

// The backward's dynamic shared memory: four staged tiles (Q, dO, K, V),
// and for dK/dV the query tile's row statistics and keep words.
template <typename T, int DP>
size_t bwd_smem_bytes(bool dkdv) {
  return 4 * sizeof(T) * (size_t)Tile<T, DP>::ELEMS +
         (dkdv ? 4 * (size_t)BM * sizeof(float) : 0);
}

// The widest copy (16, 8 or 4 bytes, else one element) that a staged
// row's bytes and every staged tensor's base and strides allow.
template <int N>
int copy_unit(int row_bytes, int itemsize, const void* const (&ptrs)[N],
              const Strides (&ss)[N]) {
  for (int u = 16; u >= 4; u >>= 1) {
    bool ok = row_bytes % u == 0;
    for (int i = 0; i < N && ok; ++i)
      ok = reinterpret_cast<uintptr_t>(ptrs[i]) % u == 0 &&
           ss[i].b * itemsize % u == 0 && ss[i].t * itemsize % u == 0 &&
           ss[i].h * itemsize % u == 0;
    if (ok) return u;
  }
  return itemsize;
}

template <typename T, int DP, int STAGES>
int launch_fwd(const void* q, const void* k, const void* v,
               const float* bias, const int* seed, void* o, float* o32,
               float* m, float* l, const long long* st, int B, Geometry g,
               cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<T, DP, STAGES>();
  cudaError_t err = allow_smem(fused_fwd_kernel<T, DP, STAGES>, smem);
  if (err != cudaSuccess) return (int)err;
  const Strides sq = strides_at(st, 0), sk = strides_at(st, 1),
                sv = strides_at(st, 2);
  const int unit = copy_unit<3>(g.D * (int)sizeof(T), (int)sizeof(T),
                                {q, k, v}, {sq, sk, sv});
  const long long blocks = (long long)B * g.H * ((g.Tq + BM - 1) / BM);
  fused_fwd_kernel<T, DP, STAGES>
      <<<(unsigned)blocks, THREADS, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), bias, seed, static_cast<T*>(o), o32, m,
          l, sq, sk, sv, strides_at(st, 3), unit, g);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int launch_bwd(const void* q, const void* k, const void* v, const float* o32,
               const void* dout, const float* bias, const int* seed,
               const float* m, const float* l, float* rowbuf, uint32_t* keep,
               void* dq, void* dk, void* dv, const long long* st, int B,
               Geometry g, cudaStream_t stream) {
  const size_t smem_q = bwd_smem_bytes<T, DP>(false);
  const size_t smem_kv = bwd_smem_bytes<T, DP>(true);
  cudaError_t err = allow_smem(fused_bwd_dq_kernel<T, DP>, smem_q);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(fused_bwd_dkdv_kernel<T, DP>, smem_kv);
  if (err != cudaSuccess) return (int)err;
  const Strides sq = strides_at(st, 0), sk = strides_at(st, 1),
                sv = strides_at(st, 2), so = strides_at(st, 3),
                sdo = strides_at(st, 4), sdq = strides_at(st, 5),
                sdk = strides_at(st, 6), sdv = strides_at(st, 7);
  const int unit = copy_unit<4>(g.D * (int)sizeof(T), (int)sizeof(T),
                                {q, k, v, dout}, {sq, sk, sv, sdo});
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const long long bht = (long long)B * g.H * g.Tq;
  const long long q_blocks = (long long)B * g.H * ((g.Tq + BM - 1) / BM);
  const long long k_blocks = (long long)B * g.H * ((g.Tk + BN - 1) / BN);
  // dQ first: it also writes the row statistics and keep bits dK/dV reads
  fused_bwd_dq_kernel<T, DP>
      <<<(unsigned)q_blocks, THREADS, smem_q, stream>>>(
          qt, kt, vt, o32, dot, bias, seed, m, l, rowbuf, keep,
          static_cast<T*>(dq), sq, sk, sv, so, sdo, sdq, bht, unit, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_bwd_dkdv_kernel<T, DP>
      <<<(unsigned)k_blocks, THREADS, smem_kv, stream>>>(
          qt, kt, vt, dot, bias, rowbuf, keep, static_cast<T*>(dk),
          static_cast<T*>(dv), sq, sk, sv, sdo, sdk, sdv, bht, unit, g);
  return (int)cudaGetLastError();
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
#define MXT_FWD(T, DP)                                                      \
  return launch_fwd<T, DP, FWD_STAGES>(q, k, v, bs, sd, o, of, mf, lf,     \
                                       strides, B, g, st)
  if (dtype == 0) {
    if (D <= 64) MXT_FWD(float, 64);
    MXT_FWD(float, 128);
  }
  if (dtype == 1) {
    if (D <= 64) MXT_FWD(__nv_bfloat16, 64);
    MXT_FWD(__nv_bfloat16, 128);
  }
#undef MXT_FWD
  return (int)cudaErrorInvalidValue;
}

int mxt_fused_attention_bwd(const void* q, const void* k, const void* v,
                            const void* o32, const void* dout,
                            const void* bias, const void* seed,
                            const void* m, const void* l, void* rowbuf,
                            void* keep, void* dq, void* dk, void* dv,
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
  float* rb = static_cast<float*>(rowbuf);
  uint32_t* kp = static_cast<uint32_t*>(keep);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MXT_BWD(T, DP)                                                      \
  return launch_bwd<T, DP>(q, k, v, of, dout, bs, sd, mf, lf, rb, kp, dq,  \
                           dk, dv, strides, B, g, st)
  if (dtype == 0) {
    if (D <= 64) MXT_BWD(float, 64);
    MXT_BWD(float, 128);
  }
  if (dtype == 1) {
    if (D <= 64) MXT_BWD(__nv_bfloat16, 64);
    MXT_BWD(__nv_bfloat16, 128);
  }
#undef MXT_BWD
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
