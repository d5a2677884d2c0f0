// Hopper (sm_90a) building blocks of the tensor-core kernels: cp.async
// copies into 128-byte-swizzled shared-memory tiles, the shared-memory
// matrix descriptors that wgmma reads them through, and the wgmma
// products the kernels use, as inline PTX.
//
// Tile layout. A tile of R rows by DP bf16 columns (DP a multiple of 64)
// is stored as DP / 64 panels of R rows x 128 bytes; in each panel the
// 16-byte chunk c of row r sits at chunk c ^ (r % 8) (the 128-byte
// swizzle, applied by the hardware to address bits [4, 7) from bits
// [7, 10), so every panel starts on a 1024-byte boundary). One layout
// serves both operand kinds:
//   * K-major (the reduction runs along the row, e.g. Q and K in Q·Kᵀ):
//     k-step kk (columns [16 kk, 16 kk + 16)) starts 32 bytes further
//     into the row of panel kk / 4; 8-row groups are 1024 bytes apart.
//   * MN-major (the reduction runs down the rows, e.g. V in P·V): k-step
//     kk (rows [16 kk, 16 kk + 16)) starts 2048 bytes further; 8-row
//     groups are 1024 bytes apart, 64-column panels R * 128 bytes apart.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c of row r in an R-row swizzled tile.
template <int R>
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  return (uint32_t)((c >> 3) * R * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

// 16 bytes from global to shared; bytes < 16 zero-fills the rest.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// 8 bytes from global to shared; bytes < 8 zero-fills the rest.
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// 4 bytes from global to shared; bytes = 0 writes a zero.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Make this thread's generic-proxy writes to shared memory (cp.async
// included) visible to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers a wgmma reads or writes in place: the compiler may not
// move, copy or reorder their accesses across this point. Called on the
// accumulators and A fragments before wgmma_fence, after the commit and
// after the wait, so that nothing touches them while a product is in
// flight (ptxas serializes every wgmma of a kernel where something does).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i)
    asm volatile("" : "+r"(a[i >> 2][i & 3])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle (layout type 1).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// K-major operand: k-step kk of an R-row tile at `tile`.
template <int R>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int kk) {
  return make_desc(tile + (kk >> 2) * R * 128 + (kk & 3) * 32, 16, 1024);
}

// MN-major operand: k-step kk (rows [16 kk, 16 kk + 16)) of an R-row tile.
template <int R>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int kk) {
  return make_desc(tile + kk * 2048, R * 128, 1024);
}

// Two floats rounded to a bf16 pair (x in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// D(64 x 64) (+)= A(64 x 16) · B(16 x 64), A and B in shared memory, both
// K-major (tnspA = tnspB = 0). scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64 x 64) += A(64 x 16) · B(16 x 64), A in registers (four bf16 pairs
// a thread, laid out as the accumulator of a 64 x 16 tile), B in shared
// memory MN-major (tnspB = 1).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64 x 128) += A(64 x 16) · B(16 x 128), A in registers (four bf16 pairs
// a thread, laid out as the accumulator of a 64 x 16 tile), B in shared
// memory MN-major (tnspB = 1).
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// --------------------------------------------------------------------------
// The accumulator fragment of a 64-row wgmma tile: thread t of warp w
// holds rows 16w + t/4 and 16w + t/4 + 8, columns 8j + 2(t%4) + {0, 1};
// a row's reductions are two shuffles among its four threads.
// --------------------------------------------------------------------------

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The A fragments of a 64 x 64 accumulator, rounded to bf16: k-step kk
// covers its columns [16 kk, 16 kk + 16).
__device__ __forceinline__ void to_a_frags(const float (&x)[32],
                                           uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// The A fragments of a 64 x 64 accumulator as N bf16 terms: term 0 =
// bf16(x), term i = bf16(x - terms 0..i-1). Three terms carry x to
// float32's 24 bits, so sum_i term_i·B keeps the product at float32
// accuracy where B is exact in bf16.
template <int N>
__device__ __forceinline__ void to_a_frags_terms(const float (&x)[32],
                                                 uint32_t (&a)[N][4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float x0 = x[8 * kk + 2 * r], x1 = x[8 * kk + 2 * r + 1];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        a[i][kk][r] = pack_bf16(x0, x1);
        const float2 h = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&a[i][kk][r]));
        x0 -= h.x;
        x1 -= h.y;
      }
    }
}

// Accumulator element j of this thread: row (0..63) and column (0..63)
// within the tile.
__device__ __forceinline__ int frag_row(int j) {
  return 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2) +
         8 * ((j >> 1) & 1);
}
__device__ __forceinline__ int frag_col(int j) {
  return 8 * (j >> 2) + 2 * (threadIdx.x & 3) + (j & 1);
}

// The max over this thread's 16 elements of row half i of a 64 x 64
// accumulator, then over the four threads that share the row.
__device__ __forceinline__ float row_max(const float (&x)[32], int i) {
  float m[8];
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
    m[nb] = fmaxf(x[4 * nb + 2 * i], x[4 * nb + 2 * i + 1]);
#pragma unroll
  for (int w = 4; w > 0; w >>= 1)
#pragma unroll
    for (int nb = 0; nb < w; ++nb) m[nb] = fmaxf(m[nb], m[nb + w]);
  return quad_max(m[0]);
}

}  // namespace
