// Fused attention for training on Hopper's tensor cores, bfloat16 only:
// O = dropout(softmax(Q·Kᵀ·scale + bias [+ causal])) · V, forward and
// backward.
//
// Replaces, for bfloat16 inputs, the Pallas TPU kernels of
// mxnet_tpu/ops/pallas_attention.py:
//   fused_fwd_tc_kernel                   <- _fwd_kernel_packed (BTHD),
//                                            _fwd_kernel (BHTD)
//   fused_bwd_dq_tc_kernel, fused_bwd_dkdv_tc_kernel
//                                         <- _bwd_kernel_packed (BTHD),
//                                            _bwd_kernel (BHTD)
// float32 keeps the kernels of fused_attention.cu (route "cuda_core":
// mma.sync in split TF32, any row alignment), and so do bfloat16 calls
// whose rows the 16-byte async copies cannot stage (the
// wrapper's route rule, ops/fused_attention.py `kernel_route`): here
// D % 8 == 0, every (batch, time, head) element stride is a multiple of
// 8 and every base address is 16-byte aligned.
//
// Semantics are those of fused_attention.cu: bias 0 or -1e30; causal
// masks key > query + (Tk - Tq) with -1e30; a row whose running max is
// <= -1e30 / 2 contributes nothing and comes out as exact zeros; dropout
// keeps (row, key) iff mix(mix(pos ^ s0) ^ s1) >= threshold with
// pos = row·Tk + key and s1 = seed[1] ^ (b·H + h), the keep mask bit for
// bit; every sum is float32. Exponentials are ex2.approx of the
// log2e-scaled argument. The bfloat16 rounding points are the flash
// form's, not the reference's: the forward rounds the unnormalised
// probabilities exp(x - running max), dropped ones zeroed, before P·V
// and divides by the denominator and the keep rate at the end in
// float32; the dK/dV kernel rounds the normalised probabilities over the
// keep rate before dV; dQ and dK take dS·scale rounded, which differs
// from rounding dS and then scaling unless scale is a power of two
// (D = 40, 128).
//
// What bounds it on an H100. At BERT-base shapes (T = 512, D = 64) the
// forward does ~256 flops per bfloat16 byte it must move and the backward
// ~360, near the tensor cores' ridge (~295), so the products have to run
// on them. Beside them, every (query, key) pair costs the CUDA cores an
// exponential, about ten float operations and, with dropout, the
// reference's hash (about 18 integer operations on the half-rate integer
// pipe); at these shapes that work, not the products, sets the time.
//
// Design.
//   * Products on the tensor cores: wgmma m64nNk16, bf16 operands,
//     float32 accumulators in registers. S = Q·Kᵀ (and dP = dO·Vᵀ) read
//     both operands from shared memory, K-major (the head dim is
//     contiguous). O += P·V, dQ += dS·K, dV += Pᵀ·dO and dK += dSᵀ·Q take
//     the left operand from registers: the score accumulator, rescaled,
//     masked and rounded in place, is already laid out as a wgmma A
//     fragment; the right operand is an MN-major shared-memory tile.
//   * The softmax, bias, causal test and dropout hash run on the
//     accumulator fragment: thread t of warp w holds rows 16w + t/4 and
//     16w + t/4 + 8, columns 8j + 2(t%4) + {0, 1}; row reductions are two
//     shuffles among the four threads of a row. No branch around the
//     per-element work (it would diverge): absent keys carry bias -inf
//     and dead rows a scaled max of +inf, so their exponentials are 0.
//   * Software pipeline: each iteration issues the next tile's S (and
//     dP) and the current tile's second product as two wgmma groups,
//     waits for the first and runs the next tile's softmax or dS while
//     the second is still on the tensor cores.
//   * Staging: bf16 tiles, 128-byte swizzled (wgmma.cuh), filled with
//     16-byte cp.async from per-thread pointers set up once (TileCopier;
//     rows past the extent and head-dim columns past D are zero-filled,
//     so D pads to DP = 64 or 128 in shared memory), one iteration ahead
//     of use: rings of two K and two V tiles (forward), three K and two V
//     (dQ: K_t is read by dQ += dS_t·K_t while K_{t+1} is multiplied),
//     three Q/dO tiles (dK/dV).
//   * Tiles: one warpgroup (128 threads) a block, 64 query rows, 64-key
//     tiles. At DP = 64 the forward takes 41 KB of shared memory and 128
//     registers a thread (four blocks an SM), dQ 57 KB and 168 (three),
//     dK/dV 69 KB and about 230 (two); blocks interleave their products
//     and element work on an SM.
//   * Causal: the forward and dQ stop at the diagonal tile, dK/dV start
//     there.
//   * Deterministic backward, no atomics: the dQ kernel (one block per
//     (b, h, query tile)) runs first and writes, per row, the log2-domain
//     logsumexp m·log2e + log2(max(l, 1e-30)) (+inf when dead) and
//     d_row = rowsum(dO ⊙ O) from the forward's float32 O copy, and with
//     dropout the keep bits of every tile it visits (32 keys a word);
//     scale and 1 / l ride in the exponents. The dK/dV kernel (one block
//     per (b, h, key tile)) loops over query tiles and reads those instead
//     of hashing again. S and dP are recomputed in both kernels: 14·D
//     flops a pair against the minimum 10·D.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int MAX_D = 128;
constexpr int THREADS = 128;  // one warpgroup

// Copies 64-row tiles of one head (b, h) of a (batch, time, head)-strided
// tensor into swizzled shared-memory tiles with cp.async: thread t always
// copies 16-byte chunk t % (DP / 8) of rows t / (DP / 8) + k·(128 / (DP /
// 8)), so its source pointer and destination offset are set up once and
// a tile costs one pointer step, one bound test and one cp.async a
// chunk. Columns past D and rows past the extent n are zero-filled.
template <int DP>
struct TileCopier {
  static constexpr int CPR = DP / 8;          // 16-byte chunks a row
  static constexpr int RPP = THREADS / CPR;   // rows a pass covers
  const bf16* src;  // this thread's chunk of row r0 at time 0
  long long st;     // time stride
  uint32_t off;     // this thread's first chunk in a tile
  int r0;
  bool col;         // the chunk lies below D

  __device__ __forceinline__ TileCopier(const bf16* x, const Strides& s,
                                        int b, int h, int D) {
    const int c = threadIdx.x % CPR;
    r0 = threadIdx.x / CPR;
    st = s.t;
    src = x + at(s, b, r0, h) + c * 8;
    off = swizzled<64>(r0, c);
    col = c * 8 < D;
  }

  // rows [t0, t0 + 64) into the tile at dst; the caller commits
  __device__ __forceinline__ void copy(uint32_t dst, int t0, int n) const {
    const bf16* p = src + (long long)t0 * st;
    if (col && t0 + 64 <= n) {  // a whole tile: no bound tests
#pragma unroll
      for (int k = 0; k < 64 / RPP; ++k) {
        cp_async16(dst + off + k * RPP * 128, p, 16);
        p += RPP * st;
      }
      return;
    }
#pragma unroll
    for (int k = 0; k < 64 / RPP; ++k) {
      const bool in = col && t0 + r0 + k * RPP < n;
      cp_async16(dst + off + k * RPP * 128, in ? p : src, in ? 16 : 0);
      p += RPP * st;
    }
  }
};

// Store this thread's part of a 64 x DP accumulator times f[row half] as
// bf16 rows t0 + frag_row (those below n), columns below D; and as
// float32 into x32 when it is given.
template <int NA>
__device__ __forceinline__ void store_rows(const float (&acc)[NA],
                                           const float (&f)[2], bf16* x,
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
      if (d >= D) continue;
      const float v0 = acc[4 * nb + 2 * i] * f[i];
      const float v1 = acc[4 * nb + 2 * i + 1] * f[i];
      *reinterpret_cast<__nv_bfloat162*>(x + base + d) =
          __floats2bfloat162_rn(v0, v1);
      if (x32)
        *reinterpret_cast<float2*>(x32 + base + d) = make_float2(v0, v1);
    }
  }
}

// --------------------------------------------------------------------------
// forward
// --------------------------------------------------------------------------

// Software pipeline of key tile t: while the tensor cores run
// S_{t+1} = Q·K_{t+1}ᵀ and O += P_t·V_t, the CUDA cores run tile t + 1's
// softmax and hash. Copies run one iteration ahead: the group issued in
// iteration t brings K_{t+2} and V_{t+1} (two stages each).
template <int DP>
__global__ void __launch_bounds__(THREADS) fused_fwd_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const float* __restrict__ bias,
    const int* __restrict__ seed, bf16* __restrict__ o,
    float* __restrict__ o32, float* __restrict__ m_out,
    float* __restrict__ l_out, Strides sq, Strides sk, Strides sv,
    Strides so, Geometry g) {
  constexpr int NA = DP / 2;                 // accumulator floats of O
  constexpr uint32_t QB = BM * DP * 2, KB = BN * DP * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t k_ring = q_s + QB, v_ring = k_ring + 2 * KB;

  const int nqt = (g.Tq + BM - 1) / BM;
  const int bh = blockIdx.x / nqt, r0 = (blockIdx.x - bh * nqt) * BM;
  const int b = bh / g.H, h = bh - b * g.H;
  const int rows[2] = {r0 + frag_row(0), r0 + frag_row(2)};
  const int n = key_tiles(g, r0);
  const TileCopier<DP> kc(k, sk, b, h, g.D), vc(v, sv, b, h, g.D);
  auto load_k = [&](int t) { kc.copy(k_ring + (t & 1) * KB, t * BN, g.Tk); };
  auto load_v = [&](int t) { vc.copy(v_ring + (t & 1) * KB, t * BN, g.Tk); };

  TileCopier<DP>(q, sq, b, h, g.D).copy(q_s, r0, g.Tq);
  if (n > 0) load_k(0);
  cp_async_commit();
  if (n > 1) load_k(1);
  if (n > 0) load_v(0);
  cp_async_commit();

  const uint32_t s0 = (uint32_t)seed[0];
  const uint32_t s1 = (uint32_t)seed[1] ^ (uint32_t)bh;
  const float* bias_b = bias + (long long)b * g.Tk;
  float m_i[2] = {NEG_INF, NEG_INF}, l_i[2] = {0.f, 0.f}, alpha[2];
  float acc[NA], s[32], bc[16];
#pragma unroll
  for (int j = 0; j < NA; ++j) acc[j] = 0.f;

  if (n > 0) {
    load_bias(bc, bias_b, 0, g.Tk);
    cp_async_wait<1>();  // Q and K_0
    fence_proxy_async();
    __syncthreads();
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss(s, kmajor_desc<BM>(q_s, kk), kmajor_desc<BN>(k_ring, kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    softmax_tile(s, bc, g, 0, rows, m_i, l_i, alpha, s0, s1);
  }
  // O += P_kt·V_kt, with S_{kt+1} issued first unless kt is the last
  // tile; each branch issues and waits for its own wgmma groups (a group
  // in flight across a join makes ptxas serialize every wgmma)
  for (int kt = 0; kt < n; ++kt) {
    const bool more = kt + 1 < n;
    cp_async_wait<0>();  // K_{kt+1} and V_kt
    fence_proxy_async();
    __syncthreads();     // every warp is past S_kt and P_{kt-1}·V_{kt-1}
    if (kt + 2 < n) load_k(kt + 2);
    if (more) load_v(kt + 1);
    cp_async_commit();
    uint32_t pa[4][4];
    to_a_frags(s, pa);
    if (more) load_bias(bc, bias_b, (kt + 1) * BN, g.Tk);
    const uint32_t vs = v_ring + (kt & 1) * KB;
    fence_regs(s);
    fence_regs(acc);
    fence_regs(pa);
    wgmma_fence();
    if (more) {
      const uint32_t ks = k_ring + ((kt + 1) & 1) * KB;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss(s, kmajor_desc<BM>(q_s, kk), kmajor_desc<BN>(ks, kk), kk);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs(acc, pa[kk], mnmajor_desc<BN>(vs, kk));
      wgmma_commit();
      fence_regs(s);
      fence_regs(acc);
      fence_regs(pa);
      wgmma_wait<1>();   // S_{kt+1}; P_kt·V_kt may still run
      fence_regs(s);
      softmax_tile(s, bc, g, (kt + 1) * BN, rows, m_i, l_i, alpha, s0, s1);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
#pragma unroll
      for (int j = 0; j < NA; ++j) acc[j] *= alpha[(j >> 1) & 1];
    } else {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs(acc, pa[kk], mnmajor_desc<BN>(vs, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
    }
  }
  cp_async_wait<0>();

  float f[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_i[i] = quad_sum(l_i[i]);
    f[i] = g.inv_keep / fmaxf(l_i[i], 1e-30f);
  }
  store_rows(acc, f, o, o32, so, b, h, r0, g.Tq, g.D);
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
// backward: d_row, 1 / l and dQ
// --------------------------------------------------------------------------

// rowbuf: float32 (2, B, H, Tq) the dK/dV kernel reads: [0] = lse =
// m·log2e + log2(max(l, 1e-30)) (+inf for a dead row), so that
// ex2(x·log2e - lse) = p, [1] = d_row·scale. keep: the
// dropout keep bits of every visited tile (store_keep), or null without
// dropout. Pipeline as the forward's: S_{t+1} and dP_{t+1} and
// dQ += dS_t·K_t run on the tensor cores while tile t + 1's dS is formed.
// The group issued in iteration t brings K_{t+2} (three stages: K_t is
// still read) and V_{t+2} (two stages).
//
// Three blocks an SM at DP = 64: left to itself ptxas takes ~190
// registers for more overlap and fits two, which is ~25% slower (the
// cap costs 8 bytes of spill).
template <int DP>
__global__ void __launch_bounds__(THREADS, DP == 64 ? 3 : 1)
    fused_bwd_dq_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const float* __restrict__ o32,
    const bf16* __restrict__ dout, const float* __restrict__ bias,
    const int* __restrict__ seed, const float* __restrict__ m_in,
    const float* __restrict__ l_in, float* __restrict__ rowbuf,
    uint32_t* __restrict__ keep, bf16* __restrict__ dq, Strides sq,
    Strides sk, Strides sv, Strides so, Strides sdo, Strides sdq,
    long long bht, Geometry g) {
  constexpr int NA = DP / 2;
  constexpr uint32_t QB = BM * DP * 2, KB = BN * DP * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t do_s = q_s + QB;
  const uint32_t k_ring = do_s + QB, v_ring = k_ring + 3 * KB;

  const int nqt = (g.Tq + BM - 1) / BM;
  const int bh = blockIdx.x / nqt, r0 = (blockIdx.x - bh * nqt) * BM;
  const int b = bh / g.H, h = bh - b * g.H;
  const int rows[2] = {r0 + frag_row(0), r0 + frag_row(2)};
  const int n = key_tiles(g, r0);
  const long long row0 = (long long)bh * g.Tq;
  const TileCopier<DP> kc(k, sk, b, h, g.D), vc(v, sv, b, h, g.D);
  auto load_kv = [&](int t) {
    kc.copy(k_ring + (t % 3) * KB, t * BN, g.Tk);
    vc.copy(v_ring + (t & 1) * KB, t * BN, g.Tk);
  };

  TileCopier<DP>(q, sq, b, h, g.D).copy(q_s, r0, g.Tq);
  TileCopier<DP>(dout, sdo, b, h, g.D).copy(do_s, r0, g.Tq);
  if (n > 0) load_kv(0);
  cp_async_commit();
  if (n > 1) load_kv(1);
  cp_async_commit();

  // per row: lsq (see ds_tile) and d_row = Σ dO·O
  const float log2_scale = log2f(g.scale);
  float lsq[2], dr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = rows[i];
    const bool in = row < g.Tq;
    float part = 0.f;
    if (in) {
      const bf16* dorow = dout + at(sdo, b, row, h);
      const float* orow = o32 + at(so, b, row, h);
#pragma unroll
      for (int nb = 0; nb < DP / 8; ++nb) {
        const int d = frag_col(4 * nb);
        if (d < g.D) {
          const float2 ov = *reinterpret_cast<const float2*>(orow + d);
          const float2 dv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(dorow + d));
          part = fmaf(dv.x, ov.x, part);
          part = fmaf(dv.y, ov.y, part);
        }
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
  float acc[NA], s[32], da[32], bc[16];
#pragma unroll
  for (int j = 0; j < NA; ++j) acc[j] = 0.f;

  if (n > 0) {
    load_bias(bc, bias_b, 0, g.Tk);
    cp_async_wait<1>();  // Q, dO, K_0, V_0
    fence_proxy_async();
    __syncthreads();
    fence_regs(s);
    fence_regs(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss(s, kmajor_desc<BM>(q_s, kk), kmajor_desc<BN>(k_ring, kk), kk);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss(da, kmajor_desc<BM>(do_s, kk), kmajor_desc<BN>(v_ring, kk),
               kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(da);
    uint32_t bits[2][2] = {{0u, 0u}, {0u, 0u}};
    ds_tile(s, da, bc, g, 0, rows, lsq, dr, s0, s1, bits);
    if (g.dropout) store_keep(bits, keep, g, row0, rows, 0);
  }
  for (int kt = 0; kt < n; ++kt) {
    const bool more = kt + 1 < n;
    cp_async_wait<0>();  // K_{kt+1} and V_{kt+1}
    fence_proxy_async();
    __syncthreads();     // every warp is past S_kt, dP_kt and dQ's K_{kt-1}
    if (kt + 2 < n) load_kv(kt + 2);
    cp_async_commit();
    uint32_t dsa[4][4];
    to_a_frags(s, dsa);
    if (more) load_bias(bc, bias_b, (kt + 1) * BN, g.Tk);
    const uint32_t ks = k_ring + (kt % 3) * KB;
    fence_regs(s);
    fence_regs(da);
    fence_regs(acc);
    fence_regs(dsa);
    wgmma_fence();
    if (more) {
      const uint32_t ks1 = k_ring + ((kt + 1) % 3) * KB;
      const uint32_t vs1 = v_ring + ((kt + 1) & 1) * KB;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss(s, kmajor_desc<BM>(q_s, kk), kmajor_desc<BN>(ks1, kk), kk);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss(da, kmajor_desc<BM>(do_s, kk), kmajor_desc<BN>(vs1, kk), kk);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs(acc, dsa[kk], mnmajor_desc<BN>(ks, kk));
      wgmma_commit();
      fence_regs(s);
      fence_regs(da);
      fence_regs(acc);
      fence_regs(dsa);
      wgmma_wait<1>();   // S_{kt+1} and dP_{kt+1}; dQ's product may run
      fence_regs(s);
      fence_regs(da);
      uint32_t bits[2][2] = {{0u, 0u}, {0u, 0u}};
      ds_tile(s, da, bc, g, (kt + 1) * BN, rows, lsq, dr, s0, s1, bits);
      if (g.dropout) store_keep(bits, keep, g, row0, rows, kt + 1);
      wgmma_wait<0>();
    } else {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs(acc, dsa[kk], mnmajor_desc<BN>(ks, kk));
      wgmma_commit();
      wgmma_wait<0>();
    }
    fence_regs(acc);
    fence_regs(dsa);
  }
  cp_async_wait<0>();

  const float one[2] = {1.f, 1.f};
  store_rows(acc, one, dq, nullptr, sdq, b, h, r0, g.Tq, g.D);
}

// --------------------------------------------------------------------------
// backward: dK and dV
// --------------------------------------------------------------------------

// dV += Pᵀ·dO and dK += dSᵀ·Q for the query tile whose Q and dO sit at
// qs and qs + qb, issued as one wgmma group.
template <int NA>
__device__ __forceinline__ void grad_products(float (&dk)[NA],
                                              float (&dv)[NA],
                                              const uint32_t (&pa)[4][4],
                                              const uint32_t (&dsa)[4][4],
                                              uint32_t qs, uint32_t qb) {
#pragma unroll
  for (int kk = 0; kk < BM / 16; ++kk)
    wgmma_rs(dv, pa[kk], mnmajor_desc<BM>(qs + qb, kk));
#pragma unroll
  for (int kk = 0; kk < BM / 16; ++kk)
    wgmma_rs(dk, dsa[kk], mnmajor_desc<BM>(qs, kk));
  wgmma_commit();
}

// The accumulators are transposed: rows are this block's 64 keys, columns
// the 64 query rows of the current query tile (Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ), so
// Pᵀ and dSᵀ are A fragments of dV += Pᵀ·dO and dK += dSᵀ·Q as they stand.
// Pipeline as the forward's over query tiles; Q, dO and the row
// statistics go through three stages (tile t is still read while t + 1
// is multiplied and t + 2 is copied).
template <int DP>
__global__ void __launch_bounds__(THREADS) fused_bwd_dkdv_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ bias, const float* __restrict__ rowbuf,
    const uint32_t* __restrict__ keep, bf16* __restrict__ dk,
    bf16* __restrict__ dv, Strides sq, Strides sk, Strides sv, Strides sdo,
    Strides sdk, Strides sdv, long long bht, Geometry g) {
  constexpr int NA = DP / 2;
  constexpr uint32_t QB = BM * DP * 2, KB = BN * DP * 2;
  constexpr uint32_t STAT = 4 * BM * 4;      // 2 x 64 floats, 128 words
  extern __shared__ uint8_t smem_raw[];
  const uint32_t k_s = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t v_s = k_s + KB;
  const uint32_t ring = v_s + KB;            // stage st: Q, then dO
  const uint32_t stats = ring + 3 * 2 * QB;  // stage st: statistics
  const float* stats_g =
      reinterpret_cast<const float*>(smem_raw + (stats - smem_u32(smem_raw)));

  const int nkt = (g.Tk + BN - 1) / BN;
  const int kt = blockIdx.x - blockIdx.x / nkt * nkt;
  const int bh = blockIdx.x / nkt, c0 = kt * BN;
  const int b = bh / g.H, h = bh - b * g.H;
  const int keys[2] = {c0 + frag_row(0), c0 + frag_row(2)};
  const int nqt = (g.Tq + BM - 1) / BM;
  int first = 0;  // causal: the first query that sees key c0
  if (g.causal) {
    const int r = c0 - (g.Tk - g.Tq);
    first = r <= 0 ? 0 : min(nqt, r / BM);
  }
  const long long row0 = (long long)bh * g.Tq;
  const int nw = (g.Tk + 31) / 32;
  // this thread's keys sit in word (threadIdx.x / 64) of the two, at bits
  // 16 (warp % 2) + lane / 4 and that + 8
  const uint32_t kbit[2] = {1u << (16 * ((threadIdx.x >> 5) & 1) +
                                   ((threadIdx.x & 31) >> 2)),
                            1u << (16 * ((threadIdx.x >> 5) & 1) +
                                   ((threadIdx.x & 31) >> 2) + 8)};

  // Q, dO, the row statistics and keep words of query tile qt into its
  // stage
  const TileCopier<DP> qc(q, sq, b, h, g.D), dc(dout, sdo, b, h, g.D);
  auto load_q = [&](int qt) {
    const int r0 = qt * BM, st = (qt - first) % 3;
    const uint32_t qs = ring + st * 2 * QB;
    qc.copy(qs, r0, g.Tq);
    dc.copy(qs + QB, r0, g.Tq);
    {
      const int which = threadIdx.x / BM, r = threadIdx.x - which * BM;
      const bool in = r0 + r < g.Tq;
      const float* src = rowbuf + which * bht + row0 + r0 + r;
      cp_async4(stats + st * STAT + threadIdx.x * 4, in ? src : rowbuf,
                in ? 4 : 0);
    }
    if (g.dropout) {
      const int r = threadIdx.x >> 1, w = 2 * kt + (threadIdx.x & 1);
      const bool in = r0 + r < g.Tq && w < nw;
      cp_async4(stats + st * STAT + (2 * BM + threadIdx.x) * 4,
                in ? keep + (row0 + r0 + r) * nw + w : keep, in ? 4 : 0);
    }
  };

  TileCopier<DP>(k, sk, b, h, g.D).copy(k_s, c0, g.Tk);
  TileCopier<DP>(v, sv, b, h, g.D).copy(v_s, c0, g.Tk);
  if (first < nqt) load_q(first);
  cp_async_commit();
  if (first + 1 < nqt) load_q(first + 1);
  cp_async_commit();

  float bkey[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    bkey[i] = keys[i] < g.Tk ? bias[(long long)b * g.Tk + keys[i]] : 0.f;
  float dk_acc[NA], dv_acc[NA], s[32], da[32];
#pragma unroll
  for (int j = 0; j < NA; ++j) dk_acc[j] = dv_acc[j] = 0.f;

  if (first < nqt) {
    cp_async_wait<1>();  // K, V and query tile `first`
    fence_proxy_async();
    __syncthreads();
    fence_regs(s);
    fence_regs(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss(s, kmajor_desc<BN>(k_s, kk), kmajor_desc<BM>(ring, kk), kk);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss(da, kmajor_desc<BN>(v_s, kk), kmajor_desc<BM>(ring + QB, kk),
               kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(da);
    grads_tile(s, da, stats_g, bkey, g, first * BM, keys, kbit);
  }
  for (int qt = first; qt < nqt; ++qt) {
    const bool more = qt + 1 < nqt;
    const int st = (qt - first) % 3, st1 = (qt + 1 - first) % 3;
    cp_async_wait<0>();  // query tile qt + 1
    fence_proxy_async();
    __syncthreads();     // every warp is done with query tile qt - 1
    if (qt + 2 < nqt) load_q(qt + 2);
    cp_async_commit();
    uint32_t pa[4][4], dsa[4][4];
    to_a_frags(s, pa);
    to_a_frags(da, dsa);
    const uint32_t qs = ring + st * 2 * QB;
    fence_regs(s);
    fence_regs(da);
    fence_regs(dk_acc);
    fence_regs(dv_acc);
    fence_regs(pa);
    fence_regs(dsa);
    wgmma_fence();
    if (more) {
      const uint32_t qs1 = ring + st1 * 2 * QB;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss(s, kmajor_desc<BN>(k_s, kk), kmajor_desc<BM>(qs1, kk), kk);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss(da, kmajor_desc<BN>(v_s, kk),
                 kmajor_desc<BM>(qs1 + QB, kk), kk);
      wgmma_commit();
      grad_products(dk_acc, dv_acc, pa, dsa, qs, QB);
      fence_regs(s);
      fence_regs(da);
      fence_regs(dk_acc);
      fence_regs(dv_acc);
      fence_regs(pa);
      fence_regs(dsa);
      wgmma_wait<1>();   // S_{qt+1}ᵀ and dP_{qt+1}ᵀ; dV, dK may run
      fence_regs(s);
      fence_regs(da);
      grads_tile(s, da, stats_g + st1 * 4 * BM, bkey, g, (qt + 1) * BM, keys,
                 kbit);
      wgmma_wait<0>();
    } else {
      grad_products(dk_acc, dv_acc, pa, dsa, qs, QB);
      wgmma_wait<0>();
    }
    fence_regs(dk_acc);
    fence_regs(dv_acc);
    fence_regs(pa);
    fence_regs(dsa);
  }
  cp_async_wait<0>();

  const float one[2] = {1.f, 1.f};
  store_rows(dk_acc, one, dk, nullptr, sdk, b, h, c0, g.Tk, g.D);
  store_rows(dv_acc, one, dv, nullptr, sdv, b, h, c0, g.Tk, g.D);
}

// dynamic shared memory of each kernel, 1024 bytes of alignment slack
// included
size_t fwd_smem(int DP) { return 1024 + (size_t)(BM + 4 * BN) * DP * 2; }
size_t dq_smem(int DP) { return 1024 + (size_t)(2 * BM + 5 * BN) * DP * 2; }
size_t dkdv_smem(int DP) {
  return 1024 + (size_t)(2 * BN + 6 * BM) * DP * 2 + 3 * 4 * BM * 4;
}

template <int DP>
int launch_fwd(const void* q, const void* k, const void* v,
               const float* bias, const int* seed, void* o, float* o32,
               float* m, float* l, const long long* st, int B, Geometry g,
               cudaStream_t stream) {
  const size_t smem = fwd_smem(DP);
  cudaError_t err = allow_smem(fused_fwd_tc_kernel<DP>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * g.H * ((g.Tq + BM - 1) / BM);
  fused_fwd_tc_kernel<DP><<<(unsigned)blocks, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), bias, seed, static_cast<bf16*>(o), o32, m,
      l, strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
      strides_at(st, 3), g);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_bwd(const void* q, const void* k, const void* v, const float* o32,
               const void* dout, const float* bias, const int* seed,
               const float* m, const float* l, float* rowbuf, uint32_t* keep,
               void* dq, void* dk, void* dv, const long long* st, int B,
               Geometry g, cudaStream_t stream) {
  const size_t smem_q = dq_smem(DP), smem_kv = dkdv_smem(DP);
  cudaError_t err = allow_smem(fused_bwd_dq_tc_kernel<DP>, smem_q);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(fused_bwd_dkdv_tc_kernel<DP>, smem_kv);
  if (err != cudaSuccess) return (int)err;
  const Strides sq = strides_at(st, 0), sk = strides_at(st, 1),
                sv = strides_at(st, 2), so = strides_at(st, 3),
                sdo = strides_at(st, 4), sdq = strides_at(st, 5),
                sdk = strides_at(st, 6), sdv = strides_at(st, 7);
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dot = static_cast<const bf16*>(dout);
  const long long bht = (long long)B * g.H * g.Tq;
  const long long q_blocks = (long long)B * g.H * ((g.Tq + BM - 1) / BM);
  const long long k_blocks = (long long)B * g.H * ((g.Tk + BN - 1) / BN);
  // dQ first: it also writes the row statistics and keep bits dK/dV reads
  fused_bwd_dq_tc_kernel<DP><<<(unsigned)q_blocks, THREADS, smem_q, stream>>>(
      qt, kt, vt, o32, dot, bias, seed, m, l, rowbuf, keep,
      static_cast<bf16*>(dq), sq, sk, sv, so, sdo, sdq, bht, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_bwd_dkdv_tc_kernel<DP>
      <<<(unsigned)k_blocks, THREADS, smem_kv, stream>>>(
          qt, kt, vt, dot, bias, rowbuf, keep, static_cast<bf16*>(dk),
          static_cast<bf16*>(dv), sq, sk, sv, sdo, sdk, sdv, bht, g);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes; bfloat16 tensors only. The arguments
// are those of fused_attention.cu's entries without the dtype, and the
// backward takes two scratch buffers: strides is a host array of (batch,
// time, head) element strides, 3 per tensor (forward q, k, v, o — o32 has
// o's strides; backward q, k, v, o32, dout, dq, dk, dv); m, l: float32
// (B, H, Tq); rowbuf: float32 (2, B, H, Tq); keep: int32 (B, H, Tq,
// ceil(Tk / 32)) with dropout, else unused; seed: (2,) int32 on the
// device. The caller guarantees D % 8 == 0, strides that are multiples of
// 8 and 16-byte aligned bases. Each returns the cudaError_t of its
// launches (0 = launched).
extern "C" {

int mxt_fused_attention_tc_fwd(const void* q, const void* k, const void* v,
                               const void* bias, const void* seed, void* o,
                               void* o32, void* m, void* l,
                               const long long* strides, int B, int H,
                               int Tq, int Tk, int D, float scale,
                               float inv_keep, uint32_t threshold,
                               int dropout, int causal, void* stream) {
  if (D < 1 || D > MAX_D || D % 8) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || Tq == 0) return (int)cudaSuccess;
  const Geometry g =
      geometry(H, Tq, Tk, D, scale, inv_keep, threshold, dropout, causal);
  const float* bs = static_cast<const float*>(bias);
  const int* sd = static_cast<const int*>(seed);
  float* of = static_cast<float*>(o32);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return D > 64 ? launch_fwd<128>(q, k, v, bs, sd, o, of, mf, lf, strides, B,
                                  g, st)
                : launch_fwd<64>(q, k, v, bs, sd, o, of, mf, lf, strides, B,
                                 g, st);
}

int mxt_fused_attention_tc_bwd(const void* q, const void* k, const void* v,
                               const void* o32, const void* dout,
                               const void* bias, const void* seed,
                               const void* m, const void* l, void* rowbuf,
                               void* keep, void* dq, void* dk, void* dv,
                               const long long* strides, int B, int H,
                               int Tq, int Tk, int D, float scale,
                               float inv_keep, uint32_t threshold,
                               int dropout, int causal, void* stream) {
  if (D < 1 || D > MAX_D || D % 8) return (int)cudaErrorInvalidValue;
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
  return D > 64 ? launch_bwd<128>(q, k, v, of, dout, bs, sd, mf, lf, rb, kp,
                                  dq, dk, dv, strides, B, g, st)
                : launch_bwd<64>(q, k, v, of, dout, bs, sd, mf, lf, rb, kp,
                                 dq, dk, dv, strides, B, g, st);
}

}  // extern "C"
