// Greedy non-maximum suppression for box_nms on the CUDA cores.
//
// Replaces mxnet_tpu/ops/detection.py:59 _nms_single. The reference runs
// it as XLA and has no Pallas body for it: a lax.fori_loop over the N
// boxes of an image in score order, step i masking row i of the (N, N)
// IoU matrix. At SSD-512's N = 5,624 anchors an image that matrix is
// 126 MB in float32 and the loop is 5,624 dependent steps; an eager
// PyTorch port of it issues several launches a step.
//
// Inputs are already in score-descending order (ops/detection.py sorts
// and unsorts around the call), one image after another, contiguous:
//   boxes  (B, N) float4   corner boxes (x1, y1, x2, y2), 16-byte aligned
//   ids    (B, N) float    class ids (compared for equality only)
//   valid  (B, N) uint8    candidates (score over the threshold, class
//                          not background, within topk); a 0 row is never
//                          kept and never suppresses
//   mask   (B, N, W) u64   scratch, W = ceil(N / 64)
//   keep   (B, N) uint8    out: 1 where the row survives
// Row i, if valid and not yet suppressed when the walk reaches it, is
// kept and suppresses every later row j (j > i) whose IoU with it is
// above the threshold and whose id equals its own (any id with
// force_suppress).
//
// Two kernels:
//   nms_mask_kernel   grid (W row tiles, W column tiles, B), 64 threads.
//                     Thread t of block (r, c) owns row i = 64 r + t and
//                     writes word c of its mask row: bit k set when
//                     column j = 64 c + k lies after i, below N, overlaps
//                     i above the threshold and shares its id. Rows that
//                     are not valid and tiles left of the row's own are
//                     skipped: the scan reads neither.
//   nms_scan_kernel   one warp an image. The valid rows and the removed
//                     rows are two bitmasks of W words in shared memory
//                     (88 words each at N = 5,624). It walks the words in
//                     order, and in each word the candidate bits (valid,
//                     not removed, after the last row taken) from the
//                     lowest: that row is kept, and the warp ORs its
//                     mask row into the removed bitmask. That is the
//                     reference's loop: a row's bit is final by the time
//                     the walk reaches it, because only earlier rows
//                     suppress it, and a kept row never sets its own bit.
//                     At the end keep = valid & ~removed.
//
// Traps, each matched here:
//   * nvcc contracts a * b + c into an FMA by default. The IoU is built
//     from __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn, each rounded on
//     its own in the plain version's order (tl = max, br = min,
//     wh = max(br - tl, 0), inter = w * h, union = (area_a + area_b) -
//     inter, iou = inter / union where union > 0, else 0), so it equals
//     the plain version's bit for bit: a pair at the threshold (IoU
//     exactly 0.5 against 0.5) must not flip.
//   * fmaxf / fminf drop a NaN where jnp.maximum and torch.maximum keep
//     it. nan_max / nan_min keep it (as span_split.cuh's nan_max): a NaN
//     coordinate makes the union NaN, the IoU 0, and the pair suppresses
//     nothing, as in the reference.
//   * Rows that are not valid can sit anywhere in the sorted order: an
//     id_index / background_id filter leaves rows with high scores
//     invalid. The scan tests each row's valid bit and never assumes
//     that the valid rows come first.
//   * N is rarely a multiple of 64: bits past N are never set, in the
//     mask (k < N - 64 c) or in the valid bitmask.
//
// What bounds it on an H100: latency. Counted by what a call's data needs
// (every row reads and writes its few bytes once; the mask's pairs among
// valid rows), the bound is a few microseconds. The scan is a serial walk:
// one dependent global read of a mask row and two warp barriers for each
// kept row, plus a shared-memory step for each word. The mask kernel is
// 126 MB of writes at most (B = 32, N = 5,624, every row valid); rows that
// are not valid cost a skipped thread.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;   // boxes a mask word covers, threads a mask block
// mask words of a row at most: the scan's two bitmasks fill 48 KB of
// shared memory, the most a launch gets without an attribute call
constexpr int kMaxWords = 3072;

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ float area(float4 a) {
  return __fmul_rn(nan_max(__fsub_rn(a.z, a.x), 0.f),
                   nan_max(__fsub_rn(a.w, a.y), 0.f));
}

// ops/detection.py _iou_corner for one pair, operation for operation
__device__ __forceinline__ float iou(float4 a, float4 b) {
  const float w = nan_max(__fsub_rn(nan_min(a.z, b.z), nan_max(a.x, b.x)),
                          0.f);
  const float h = nan_max(__fsub_rn(nan_min(a.w, b.w), nan_max(a.y, b.y)),
                          0.f);
  const float inter = __fmul_rn(w, h);
  const float uni = __fsub_rn(__fadd_rn(area(a), area(b)), inter);
  return uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
}

__global__ void __launch_bounds__(kTile)
nms_mask_kernel(const float4* __restrict__ boxes,
                const float* __restrict__ ids,
                const uint8_t* __restrict__ valid,
                unsigned long long* __restrict__ mask, int N, int words,
                float thresh, int force) {
  const int rt = blockIdx.x, ct = blockIdx.y;
  if (ct < rt) return;               // columns before the row's tile
  const size_t base = (size_t)blockIdx.z * N;
  const int t = threadIdx.x;
  const int j0 = ct * kTile;
  const int n = min(kTile, N - j0);  // live columns of the tile
  __shared__ float4 cbox[kTile];
  __shared__ float cid[kTile];
  if (t < n) {
    cbox[t] = boxes[base + j0 + t];
    cid[t] = ids[base + j0 + t];
  }
  __syncthreads();
  const int i = rt * kTile + t;
  if (i >= N || !valid[base + i]) return;
  const float4 bi = boxes[base + i];
  const float idi = ids[base + i];
  unsigned long long bits = 0;
  for (int k = max(0, i - j0 + 1); k < n; ++k) {   // columns j > i
    if ((force || cid[k] == idi) && iou(bi, cbox[k]) > thresh)
      bits |= 1ull << k;
  }
  mask[(base + i) * words + ct] = bits;
}

__global__ void __launch_bounds__(32)
nms_scan_kernel(const uint8_t* __restrict__ valid,
                const unsigned long long* __restrict__ mask,
                uint8_t* __restrict__ keep, int N, int words) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* live = smem;            // valid rows
  unsigned long long* removed = smem + words; // suppressed rows
  const size_t base = (size_t)blockIdx.x * N;
  const int lane = threadIdx.x;
  for (int w = lane; w < words; w += 32) {
    const int i0 = w * kTile, n = min(kTile, N - i0);
    unsigned long long bits = 0;
    for (int k = 0; k < n; ++k)
      bits |= (unsigned long long)(valid[base + i0 + k] != 0) << k;
    live[w] = bits;
    removed[w] = 0;
  }
  __syncwarp();
  for (int w = 0; w < words; ++w) {
    unsigned long long after = ~0ull;   // bits after the last row taken
    while (true) {
      // every lane reads the same word here, before any lane writes it
      const unsigned long long cand = live[w] & ~removed[w] & after;
      __syncwarp();
      if (!cand) break;
      const int bit = __ffsll((long long)cand) - 1;
      // row 64 w + bit is kept: its later overlaps are removed
      const unsigned long long* row =
          mask + (base + (size_t)w * kTile + bit) * words;
      for (int k = w + lane; k < words; k += 32) removed[k] |= row[k];
      __syncwarp();
      after = ~((2ull << bit) - 1);     // 0 after bit 63
    }
  }
  __syncwarp();
  for (int i = lane; i < N; i += 32) {
    const int w = i / kTile;
    keep[base + i] = (uint8_t)(((live[w] & ~removed[w]) >> (i % kTile)) & 1);
  }
}

}  // namespace

extern "C" {

// The keep mask of B images of N score-sorted boxes each (layouts above).
// The wrapper checks N <= 64 * kMaxWords and B <= 65535 (the mask grid's
// third dimension). Returns the launch's cudaError_t (0 on success).
int mxt_nms(const void* boxes, const void* ids, const void* valid,
            void* mask, void* keep, int B, int N, float thresh, int force,
            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int words = (N + kTile - 1) / kTile;
  if (B <= 0 || N <= 0 || words > kMaxWords || B > 65535)
    return (int)cudaErrorInvalidValue;
  auto* m = static_cast<unsigned long long*>(mask);
  nms_mask_kernel<<<dim3(words, words, B), kTile, 0, st>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(ids),
      static_cast<const uint8_t*>(valid), m, N, words, thresh, force);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nms_scan_kernel<<<B, 32, 2 * words * sizeof(unsigned long long), st>>>(
      static_cast<const uint8_t*>(valid), m, static_cast<uint8_t*>(keep), N,
      words);
  return (int)cudaGetLastError();
}

}  // extern "C"
