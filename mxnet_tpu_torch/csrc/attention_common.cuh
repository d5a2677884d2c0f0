// Pieces of the fused training attention that the CUDA-core kernels
// (fused_attention.cu) and the tensor-core kernels (fused_attention_tc.cu)
// share: the reference's dropout hash, strided addressing of (batch,
// time, head) rows, the launch geometry and host-side launch helpers.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;

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
