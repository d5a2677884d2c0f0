// Greedy non-maximum suppression for box_nms, designed for Hopper.
//
// Replaces mxnet_tpu/ops/detection.py:59 _nms_single. The reference runs
// it as XLA and has no Pallas body for it: a lax.fori_loop over the N
// boxes of an image in score order, step i masking row i of the (N, N)
// IoU matrix. At SSD-512's N = 5,624 anchors an image that matrix is
// 126 MB in float32 and the loop is 5,624 dependent steps.
//
// Inputs are already in score-descending order (ops/detection.py sorts
// and unsorts around the call), one image after another, contiguous:
//   boxes  (B, N) float4   corner boxes (x1, y1, x2, y2), 16-byte aligned
//   ids    (B, N) float    class ids (compared for equality only)
//   valid  (B, N) uint8    candidates (score over the threshold, class
//                          not background, within topk); a 0 row is never
//                          kept and never suppresses
//   keep   (B, N) uint8    out: 1 where the row survives
// Row i, if valid and not yet suppressed when the walk reaches it, is
// kept and suppresses every later row j (j > i) whose IoU with it is
// above the threshold and whose id equals its own (any id with
// force_suppress).
//
// The work the function needs scales with M^2, M an image's valid rows
// (topk caps M near 400 at SSD-512's detect, N = 5,624), so every step
// after the first pass over the flags works on the valid rows alone.
//
// One launch a call, whatever the data: nms_kernel, a thread-block
// cluster of C blocks of 1,024 threads an image, C the largest of 16, 8,
// 4, 2 and 1 of which all B clusters fit the card at once (asked of
// cudaOccupancyMaxActiveClusters; a GPC holds whole clusters, so an H100
// takes 30 clusters of four 214 KB blocks, not 33): 2 at the detect
// cell's B = 32, 1 at B = 128, 16 for one or two images. A cluster that
// waits for a second wave costs a whole call's time again, and an image
// on the global path is worked by its own cluster alone.
//   (1) Compaction: each block reads the N valid flags once, coalesced,
//   and numbers the valid rows in walk order by a prefix sum (popcounts
//   of 8 flags a thread, a warp scan by shuffles, a scan of the warp
//   totals); the boxes, ids and areas of the first kOnChipRows of them
//   land in its shared memory in that order, a thread's 8 loads in
//   flight together. The image's count M decides its path, on the card
//   and alike in every block of the cluster: on chip where M <=
//   kOnChipRows = 1,216, else the global path below.
//   (2) The mask: an M x ceil(M/64) array of 64-bit words in the leader
//   block's dynamic shared memory (23 KB at M = 415, 182 KB at the
//   limit); bit k of word w of row i says that row i suppresses
//   compacted row 64 w + k (> i). The leader zeroes it; each warp of the
//   cluster takes tasks of 32 rows by 32 columns (half a word; 4 to 16
//   columns where that leaves warps idle), a lane a row, the columns one
//   after another as broadcasts from shared memory, skipped by the whole
//   warp where no lane's row shares the column's id. Each lane ORs its
//   bits into the leader's half word over distributed shared memory
//   (map_shared_rank, atomicOr); one cluster barrier closes it.
//   (3) The walk: one warp of the leader; lane w holds the removed bits
//   of word w in a register (W <= 19 words). Tile t (64 rows) is
//   resolved in rounds, not row by row (walk_tile): lane l holds the
//   diagonal words of rows l and l + 32, and each round two warp
//   OR-reductions find the open rows no live row suppresses (kept) and
//   those a kept row suppresses (removed); the rounds are as many as the
//   tile's longest chain of suppressions. Then, for each later word w,
//   lane l loads word w of rows l and l + 32 where kept and a warp
//   OR-reduction hands lane w the sum (or_kept). No global memory is
//   touched in the walk.
//   (4) keep is written for all N rows, coalesced, by a second pass over
//   the flags: 0 for invalid rows.
// The global path, for an image with more valid rows than fit on chip
// (topk = -1 on a dense image), by the same cluster in the same launch:
// its blocks write the compacted boxes and ids to global scratch (each
// block a share of the flag segments), then its 32 C warps take the
// tasks of the upper-triangular mask in turn (a warp 32 rows against a
// 64-column tile staged in its shared memory, a lane a row and a word
// written to global memory), and after a cluster
// barrier the leader walks the words from L2: warp 0 resolves tile t
// from its diagonal words (prefetched while the previous tile was
// resolved), then each warp ORs the kept rows' words into four later
// words at a time (or_kept, two loads a lane a word, all in flight).
// The scratch exists only where N > kOnChipRows (the caller's to give);
// such an image gets its cluster's C SMs and no more.
//
// Limits: N <= 64 * kMaxWords = 196,608 (the global walk's bitmask, 24
// KB of shared memory), B <= 65,535 (the wrapper's check).
//
// Traps, each matched here:
//   * nvcc contracts a * b + c into an FMA by default. The IoU is built
//     from __fmul_rn / __fadd_rn / __fsub_rn, each rounded on
//     its own in the plain version's order (tl = max, br = min,
//     wh = max(br - tl, 0), inter = w * h, union = (area_a + area_b) -
//     inter, iou = inter / union where union > 0, else 0), so it equals
//     the plain version's bit for bit: a pair at the threshold (IoU
//     exactly 0.5 against 0.5) must not flip. The quotient's rounding
//     is not computed but decided: RN(inter / union) > thresh exactly
//     where inter > union * mid in double (mid: halfway from thresh to
//     the next float up; a tie goes the way round-to-even takes it;
//     tests/test_torch_detection.py holds the rule to float32 division).
//     Where inter is 0 or the union not above 0 the IoU is exactly 0,
//     still tested against the threshold: a negative threshold
//     suppresses such a pair.
//   * fmaxf / fminf drop a NaN where jnp.maximum and torch.maximum keep
//     it. nan_max / nan_min keep it (max.NaN / min.NaN): a NaN
//     coordinate makes inter and the union NaN, the IoU 0, and the pair
//     suppresses nothing, as in the reference.
//   * Rows that are not valid can sit anywhere in the sorted order: an
//     id_index / background_id filter leaves rows with high scores
//     invalid. Compaction keeps the order and drops them wherever they
//     are; keep is 0 for them.
//   * M is rarely a multiple of 64: the bits past M start out removed, so
//     the walk never takes them, and no mask word has them set.
//
// What bounds it on an H100: latency. Counted by what a call's data needs
// (every row's flag read and keep written once; a valid row's box and id
// read once; an id test a pair of valid rows and one IoU a pair that
// shares an id), the bound is a fraction of a microsecond, set by the
// bytes. What is left is the serial walk (rounds of warp reductions,
// tile after tile: 7 tiles an image at the detect cell), the mask's IoUs
// (~86 k an image there, spread over the cluster's SMs), two passes over
// the flags, the cluster barriers and the launch; on the global path,
// the mask's IoUs on C SMs and a tile's ORs from L2.
//
// Built with -DNMS_PROBE, thread 0 of every block stamps clock64() at
// the phase boundaries into the buffer mxt_nms_probe names; built with
// -DNMS_CLUSTER=c, every launch takes clusters of c blocks
// (tools/compare_kernels.py's nms part times each size).
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 64;           // rows a mask word covers
constexpr int kOnChipRows = 1216;   // valid rows an image keeps on chip
constexpr int kMaxWords = 3072;     // mask words of a row at most
constexpr int kThreads = 1024;      // threads of a block
constexpr int kSeg = 8;             // valid flags a thread takes a pass
constexpr int kOrBatch = 4;         // later words a warp ORs at once
                                    // from L2 (the global walk)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = kThreads / 32;
// the cluster sizes a launch tries, largest first
#ifdef NMS_CLUSTER
constexpr int kSizes[] = {NMS_CLUSTER};
#else
constexpr int kSizes[] = {16, 8, 4, 2, 1};
#endif
constexpr int kNumSizes = sizeof(kSizes) / sizeof(kSizes[0]);
// the on-chip block's dynamic shared memory at the limit, which the
// global path reuses: its warps' staged column tiles, then the walk's
// bitmask and two diagonals
constexpr size_t kLimitSmem =
    (size_t)kOnChipRows * (sizeof(float4) + 2 * sizeof(float)) +
    (size_t)kOnChipRows * ((kOnChipRows + kTile - 1) / kTile) * 8;
static_assert(kLimitSmem >= (size_t)kWarps * kTile *
                                (sizeof(float4) + 2 * sizeof(float)),
              "the global path's column tiles fit");
static_assert(kLimitSmem >= (size_t)(kMaxWords + 2 * kTile) * 8,
              "the global walk's bitmask fits");
static_assert((kOnChipRows + kTile - 1) / kTile <= 32,
              "the on-chip walk holds a word a lane");

#ifdef NMS_PROBE
constexpr int kProbeSlots = 8;   // words a block: 6 stamps, path, C
__device__ unsigned long long* g_probe;
#define NMS_MARK(k)                                                 \
  do {                                                              \
    if (g_probe != nullptr && threadIdx.x == 0)                     \
      g_probe[(size_t)blockIdx.x * kProbeSlots + (k)] = clock64();  \
  } while (0)
#else
#define NMS_MARK(k) \
  do {              \
  } while (0)
#endif

// max and min that return NaN where either side is NaN (jnp.maximum,
// torch.maximum), one instruction each on the card. Where they meet -0
// and +0 they may return either; the suppression test reads a zero's
// sign nowhere (inter == 0 and union > 0 take both alike).
__device__ __forceinline__ float nan_max(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return (a > b || a != a) ? a : b;
#endif
}

__device__ __forceinline__ float nan_min(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return (a < b || a != a) ? a : b;
#endif
}

__device__ __forceinline__ float area(float4 a) {
  return __fmul_rn(nan_max(__fsub_rn(a.z, a.x), 0.f),
                   nan_max(__fsub_rn(a.w, a.y), 0.f));
}

// The threshold test without its division: IoU = RN(inter / union) is
// above thresh exactly where inter / union exceeds the midpoint `mid`
// between thresh and the next float up (or equals it and the tie rounds
// up, `tie_up`: thresh's last bit is odd). union * mid is exact in
// double (24 + 25 significant bits), so the test compares inter with it
// there, rounding nothing.
struct Thresh {
  float t;
  double mid;
  bool tie_up;
};

__device__ __forceinline__ Thresh make_thresh(float t) {
  return {t, 0.5 * ((double)t + (double)nextafterf(t, INFINITY)),
          (__float_as_uint(t) & 1) != 0};
}

// Whether the IoU of boxes a and b is above the threshold (the callers
// test the ids first): ops/detection.py _iou_corner for the pair,
// operation for operation up to the quotient (aa, ab: the boxes' areas).
// Where inter is 0 or the union not above 0 the IoU is exactly 0.
__device__ __forceinline__ bool iou_above(float4 a, float aa, float4 b,
                                          float ab, const Thresh& th) {
  const float w = nan_max(__fsub_rn(nan_min(a.z, b.z), nan_max(a.x, b.x)),
                          0.f);
  const float h = nan_max(__fsub_rn(nan_min(a.w, b.w), nan_max(a.y, b.y)),
                          0.f);
  const float inter = __fmul_rn(w, h);
  const float uni = __fsub_rn(__fadd_rn(aa, ab), inter);
  const double x = (double)uni * th.mid, y = (double)inter;
  return inter != 0.f && uni > 0.f ? y > x || (y == x && th.tie_up)
                                   : 0.f > th.t;
}

// Walks an image's N valid flags in order with the whole block, kSeg
// contiguous flags a thread a pass (all its loads in flight at once):
// f(s0, bits, k) for each thread's rows s0 .. s0 + kSeg - 1 (those below
// N), bit j of `bits` set where row s0 + j is valid, k the number of
// valid rows before s0. Returns the number of valid rows. Every thread
// of the block calls it; sw holds 33 ints.
template <class F>
__device__ int valid_pass(const uint8_t* __restrict__ valid, int N, int* sw,
                          F f) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  int base = 0;
  for (int c0 = 0; c0 < N; c0 += blockDim.x * kSeg) {
    const int s0 = c0 + tid * kSeg;
    unsigned bits = 0;
#pragma unroll
    for (int j = 0; j < kSeg; ++j)
      bits |= (unsigned)(s0 + j < N && valid[s0 + j] != 0) << j;
    const int cnt = __popc(bits);
    int inc = cnt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(kFull, inc, d);
      if (lane >= d) inc += o;
    }
    if (lane == 31) sw[warp] = inc;
    __syncthreads();
    if (warp == 0) {
      const int t = lane < nw ? sw[lane] : 0;
      int s = t;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_up_sync(kFull, s, d);
        if (lane >= d) s += o;
      }
      if (lane < nw) sw[lane] = s - t;
      if (lane == 31) sw[32] = s;
    }
    __syncthreads();
    f(s0, bits, base + sw[warp] + inc - cnt);
    base += sw[32];
    __syncthreads();
  }
  return base;
}

// A valid_pass segment's valid rows, loaded together and handed on in
// order: g(k, box, id) with k their place among the valid rows
template <class G>
__device__ __forceinline__ void gather_rows(const float4* __restrict__ boxes,
                                            const float* __restrict__ ids,
                                            int s0, unsigned bits, int k,
                                            G g) {
  if (!bits) return;
  float4 bx[kSeg];
  float id[kSeg];
#pragma unroll
  for (int j = 0; j < kSeg; ++j)
    if ((bits >> j) & 1) {
      bx[j] = boxes[s0 + j];
      id[j] = ids[s0 + j];
    }
#pragma unroll
  for (int j = 0; j < kSeg; ++j)
    if ((bits >> j) & 1) g(k++, bx[j], id[j]);
}

// A valid_pass segment's keep bytes: kept(k) for its valid rows (k their
// place among the valid rows), 0 for the others
template <class K>
__device__ __forceinline__ void write_keep(uint8_t* __restrict__ keep,
                                           int N, int s0, unsigned bits,
                                           int k, K kept) {
#pragma unroll
  for (int j = 0; j < kSeg; ++j) {
    const bool on = (bits >> j) & 1;
    if (s0 + j < N) keep[s0 + j] = on ? (uint8_t)kept(k) : 0;
    k += on;
  }
}

__device__ __forceinline__ unsigned long long or_warp(unsigned long long x) {
  return (unsigned long long)__reduce_or_sync(kFull, (unsigned)x) |
         (unsigned long long)__reduce_or_sync(kFull, (unsigned)(x >> 32))
             << 32;
}

// The kept rows' words ORed into later words, by a whole warp: for each
// word w of w0 .. w0 + NB - 1 below T, lane l loads row(k, w), word w of
// the rows k = l and l + 32 of the tile set in `kept` (every load of the
// batch in flight at once), a warp reduction joins the lanes, and
// done(w, sum) runs on every lane.
template <int NB, class R, class D>
__device__ __forceinline__ void or_kept(unsigned long long kept, int w0,
                                        int T, R row, D done) {
  const int lane = threadIdx.x & 31;
  unsigned long long x[NB];
#pragma unroll
  for (int q = 0; q < NB; ++q) {
    const int w = w0 + q;
    x[q] = w < T ? ((kept >> lane) & 1 ? row(lane, w) : 0ull) |
                   ((kept >> (lane + 32)) & 1 ? row(lane + 32, w) : 0ull)
                 : 0ull;
  }
#pragma unroll
  for (int q = 0; q < NB; ++q)
    if (w0 + q < T) done(w0 + q, or_warp(x[q]));
}

// The greedy walk over one tile of 64 rows, by a whole warp. r: the rows
// removed before the tile (by earlier tiles, or past M); lane l holds the
// tile's diagonal words of rows l and l + 32 (d0, d1; bit k: the row
// suppresses row k of the tile, k after it). Resolved in rounds instead
// of row by row: an open row that no kept or open row suppresses is
// kept, one that a kept row suppresses is removed. Every round decides
// the lowest open row at least, so the rounds are as many as the longest
// chain of suppressions in the tile, not its kept rows. Returns the kept
// rows.
__device__ __forceinline__ unsigned long long walk_tile(
    unsigned long long r, unsigned long long d0, unsigned long long d1) {
  const int lane = threadIdx.x & 31;
  unsigned long long kept = 0, open = ~r;
  while (open) {
    const unsigned long long live = kept | open;
    const unsigned long long threat = or_warp(
        ((live >> lane) & 1 ? d0 : 0ull) |
        ((live >> (lane + 32)) & 1 ? d1 : 0ull));
    const unsigned long long sup = or_warp(
        ((kept >> lane) & 1 ? d0 : 0ull) |
        ((kept >> (lane + 32)) & 1 ? d1 : 0ull));
    const unsigned long long now = open & ~threat;
    kept |= now;
    open &= ~(now | sup);
  }
  return kept;
}

// the removed bits a word starts with: the rows past M
__device__ __forceinline__ unsigned long long past_m(int w, int M) {
  const int left = M - w * kTile;
  return left >= kTile ? 0ull : (left <= 0 ? ~0ull : ~0ull << left);
}

// words before row tile r's strip in an image's upper-triangular mask of
// T x T tiles: strip r' holds 64 rows of T - r' words
__device__ __forceinline__ size_t strip(int r, int T) {
  return (size_t)kTile * ((size_t)r * T - (size_t)r * (r - 1) / 2);
}

// The global path of one image (M > kOnChipRows valid rows), by every
// block of its cluster, out of line (inlined, its state spilled the
// on-chip path's registers). boxes, ids, v, keep, gbox and gid start at
// the image's first row; m is its upper-triangular mask in the scratch
// (row l of strip t, column tile c: m[strip(t, T) + l (T - t) + c - t]).
// The leader writes keep.
__device__ __noinline__ void global_path(
    cg::cluster_group cluster, int rank, int C,
    const float4* __restrict__ boxes, const float* __restrict__ ids,
    const uint8_t* __restrict__ v, uint8_t* __restrict__ keep,
    unsigned long long* __restrict__ m, float4* __restrict__ gbox,
    float* __restrict__ gid, int N, int M, Thresh th, int force,
    unsigned char* smem, int* sw) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the valid rows in walk order, to the scratch, a block every C-th flag
  // segment
  valid_pass(v, N, sw, [&](int s0, unsigned bits, int k) {
    if ((s0 / kSeg) % C == rank)
      gather_rows(boxes, ids, s0, bits, k, [&](int k, float4 bx, float id) {
        gbox[k] = bx;
        gid[k] = id;
      });
  });
  cluster.sync();
  NMS_MARK(2);

  // the mask: task u (32 rows g of row tile r = g / 2, against column
  // tile c >= r; T - r of them a row group) to warp u of the cluster,
  // round robin; the warp's column tile in its shared memory
  const int T = (M + kTile - 1) / kTile;
  float4* cbox = reinterpret_cast<float4*>(smem) + warp * kTile;
  float* cid = reinterpret_cast<float*>(reinterpret_cast<float4*>(smem) +
                                        kWarps * kTile) + warp * kTile;
  float* carea = cid + kWarps * kTile;
  int g = 0;
  long long gbase = 0;   // tasks of the row groups before g
  for (long long u = (long long)rank * kWarps + warp;;
       u += (long long)C * kWarps) {
    while (g < 2 * T && u >= gbase + (T - g / 2)) {
      gbase += T - g / 2;
      ++g;
    }
    if (g >= 2 * T) break;
    const int r = g / 2, c = r + (int)(u - gbase);
    __syncwarp();   // the previous task's columns are read
    for (int s = lane; s < kTile; s += 32) {
      const int j = kTile * c + s;
      if (j < M) {
        const float4 x = __ldcg(gbox + j);
        cbox[s] = x;
        carea[s] = area(x);
        cid[s] = __ldcg(gid + j);
      }
    }
    __syncwarp();
    const int l = 32 * (g & 1) + lane, i = kTile * r + l;
    const float4 bi = __ldcg(gbox + (i < M ? i : 0));
    const float ai = area(bi), idi = __ldcg(gid + (i < M ? i : 0));
    const int n = min(kTile, M - kTile * c);
    unsigned long long word = 0;
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
      const int j = kTile * c + k;
      const bool want = i < M && j > i && (force || cid[k] == idi);
      if (__any_sync(kFull, want) &&
          iou_above(bi, ai, cbox[k], carea[k], th) && want)
        word |= 1ull << k;
    }
    if (i < M) m[strip(r, T) + (size_t)l * (T - r) + (c - r)] = word;
  }
  cluster.sync();
  NMS_MARK(3);
  if (rank != 0) return;

  // the walk, by the leader: rem holds word w's removed bits, then its
  // kept bits; sdiag the diagonal words of this tile and the next
  unsigned long long* rem = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* sdiag = rem + kMaxWords;   // [2][kTile]
  __syncthreads();   // every warp is done with its column tile
  for (int w = tid; w < T; w += blockDim.x) rem[w] = past_m(w, M);
  if (tid < kTile) sdiag[tid] = tid < M ? __ldcg(m + (size_t)tid * T) : 0ull;
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    const unsigned long long* s = m + strip(t, T);
    unsigned long long* d = sdiag + (t & 1) * kTile;
    if (tid < 32) {
      const unsigned long long kept = walk_tile(rem[t], d[tid], d[tid + 32]);
      __syncwarp();
      if (tid == 0) rem[t] = kept;
    } else if (tid < 32 + kTile && t + 1 < T) {   // the next diagonal
      const int l = tid - 32;
      sdiag[((t + 1) & 1) * kTile + l] =
          kTile * (t + 1) + l < M
              ? __ldcg(m + strip(t + 1, T) + (size_t)l * (T - t - 1))
              : 0ull;
    }
    __syncthreads();
    const unsigned long long kept = rem[t];
    for (int w0 = t + 1 + kOrBatch * warp; w0 < T;
         w0 += kOrBatch * (blockDim.x >> 5))
      or_kept<kOrBatch>(kept, w0, T,
              [&](int k, int w) {
                return __ldcg(s + (size_t)k * (T - t) + (w - t));
              },
              [&](int w, unsigned long long x) {
                if (lane == 0) rem[w] |= x;
              });
    __syncthreads();
  }
  NMS_MARK(4);
  valid_pass(v, N, sw, [&](int s0, unsigned bits, int k) {
    write_keep(keep, N, s0, bits, k,
               [&](int k) { return (rem[k >> 6] >> (k & 63)) & 1; });
  });
}

__global__ void __launch_bounds__(kThreads, 1)
nms_kernel(const float4* __restrict__ boxes, const float* __restrict__ ids,
           const uint8_t* __restrict__ valid, uint8_t* __restrict__ keep,
           unsigned long long* __restrict__ gmask, float4* __restrict__ gbox,
           float* __restrict__ gid, int N, int cap, float thresh,
           int force) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int sw[33];
  __shared__ unsigned long long skeep[32];
  NMS_MARK(0);
  const int capw = (cap + kTile - 1) / kTile;
  float4* sbox = reinterpret_cast<float4*>(smem);
  unsigned long long* smask =
      reinterpret_cast<unsigned long long*>(sbox + cap);
  float* sid = reinterpret_cast<float*>(smask + (size_t)cap * capw);
  float* sarea = sid + cap;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int C = (int)cluster.num_blocks();
  const int b = blockIdx.x / C;
  const size_t base = (size_t)b * N;
  const uint8_t* v = valid + base;
  const int lane = threadIdx.x & 31;
  const Thresh th = make_thresh(thresh);

  // (1) the valid rows in walk order, gathered into shared memory
  const int M = valid_pass(v, N, sw, [&](int s0, unsigned bits, int k) {
    if (k < cap)
      gather_rows(boxes + base, ids + base, s0, bits, k,
                  [&](int k, float4 bx, float id) {
                    if (k < cap) {
                      sbox[k] = bx;
                      sid[k] = id;
                      sarea[k] = area(bx);
                    }
                  });
  });
  NMS_MARK(1);
#ifdef NMS_PROBE
  if (g_probe != nullptr && threadIdx.x == 0) {
    g_probe[(size_t)blockIdx.x * kProbeSlots + 6] = M > cap;
    g_probe[(size_t)blockIdx.x * kProbeSlots + 7] = C;
  }
#endif
  if (M > cap) {   // cap < N here: the caller gave the scratch
    const int TN = (N + kTile - 1) / kTile;
    global_path(cluster, rank, C, boxes + base, ids + base, v, keep + base,
                gmask + (size_t)b * strip(TN, TN), gbox + base, gid + base,
                N, M, th, force, smem, sw);
    NMS_MARK(5);
    return;
  }
  const int W = (M + kTile - 1) / kTile;

  // (2) the mask, into the leader's shared memory, zeroed first; the
  // barrier also says that every block of the cluster has started
  if (rank == 0)
    for (int x = threadIdx.x; x < M * W; x += blockDim.x) smask[x] = 0;
  cluster.sync();
  NMS_MARK(2);
  unsigned* lmask = reinterpret_cast<unsigned*>(
      cluster.map_shared_rank(smask, 0));
  // A task: word w, half h of it, a part of cw columns of the half, and a
  // group of 32 rows; lane l takes row 32 g + l against the part's
  // columns one after another (each a broadcast from shared memory;
  // skipped by the whole warp where no lane's row shares its id), and
  // ORs its bits into the half word. Word w has both halves for every
  // group of rows below min(M, 64 (w + 1)). Parts are narrower than a
  // half (32 / cw of them, cw >= 4) while the tasks would not fill the
  // cluster's warps: a small image's chains of columns stay short.
  int tasks = 0;   // tasks at cw = 32
  for (int x = 0; x < W; ++x)
    tasks += 2 * ((min(M, kTile * (x + 1)) + 31) / 32);
  int parts = 1;
  while (parts < 8 && tasks * parts < C * kWarps) parts *= 2;
  const int cw = 32 / parts;
  int w = 0, wbase = 0;   // word of the task, tasks of the words before
  for (int u = rank * kWarps + (threadIdx.x >> 5);; u += C * kWarps) {
    while (w < W &&
           u >= wbase + 2 * parts * ((min(M, kTile * (w + 1)) + 31) / 32)) {
      wbase += 2 * parts * ((min(M, kTile * (w + 1)) + 31) / 32);
      ++w;
    }
    if (w >= W) break;
    const int v = u - wbase, g = v / (2 * parts), h = (v / parts) & 1;
    const int part = v % parts;
    const int i = 32 * g + lane, ii = i < M ? i : 0;
    const float4 bi = sbox[ii];
    const float ai = sarea[ii], idi = sid[ii];
    const int j0 = kTile * w + 32 * h + cw * part, n = min(cw, M - j0);
    unsigned bits = 0;
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
      const int j = j0 + k;
      const bool want = i < M && j > i && (force || sid[j] == idi);
      if (__any_sync(kFull, want) &&
          iou_above(bi, ai, sbox[j], sarea[j], th) && want)
        bits |= 1u << k;
    }
    if (bits)
      atomicOr(&lmask[2 * ((size_t)i * W + w) + h], bits << (cw * part));
  }
  cluster.sync();
  NMS_MARK(3);
  if (rank != 0) return;

  // (3) the walk, one warp: lane w holds word w's removed bits, then its
  // kept bits
  if (threadIdx.x < 32) {
    unsigned long long rem = lane < W ? past_m(lane, M) : ~0ull;
    for (int t = 0; t < W; ++t) {
      const unsigned long long* row = smask + (size_t)kTile * t * W;
      const int i0 = kTile * t + lane, i1 = i0 + 32;
      const unsigned long long kept = walk_tile(
          __shfl_sync(kFull, rem, t), i0 < M ? row[(size_t)lane * W + t] : 0,
          i1 < M ? row[(size_t)(lane + 32) * W + t] : 0);
      if (lane == t) rem = kept;
      for (int w0 = t + 1; w0 < W; ++w0)   // the later words
        or_kept<1>(kept, w0, W,
                [&](int k, int w) { return row[(size_t)k * W + w]; },
                [&](int w, unsigned long long x) {
                  if (lane == w) rem |= x;
                });
    }
    if (lane < W) skeep[lane] = rem;
  }
  __syncthreads();
  NMS_MARK(4);

  // (4) keep for every row, in order
  valid_pass(v, N, sw, [&](int s0, unsigned bits, int k) {
    write_keep(keep + base, N, s0, bits, k,
               [&](int k) { return (skeep[k >> 6] >> (k & 63)) & 1; });
  });
  NMS_MARK(5);
}

}  // namespace

extern "C" {

// The keep mask of B images of N score-sorted boxes each (layouts above),
// in one launch. Where N > kOnChipRows the global path's scratch must be
// given: mask, B upper-triangular masks of ceil(N / 64)^2 tiles of 64
// words; gbox (B, N) float4 and gid (B, N) float, the compacted rows.
// Returns the first failing call's cudaError_t (0 on success).
int mxt_nms(const void* boxes, const void* ids, const void* valid,
            void* keep, void* mask, void* gbox, void* gid, int B, int N,
            float thresh, int force, void* stream) {
  const int words = (N + kTile - 1) / kTile;
  if (B <= 0 || N <= 0 || words > kMaxWords || B > 65535 ||
      (N > kOnChipRows && !(mask && gbox && gid)))
    return (int)cudaErrorInvalidValue;
  const int cap = N < kOnChipRows ? N : kOnChipRows;
  const int capw = (cap + kTile - 1) / kTile;
  const size_t smem = (size_t)cap * (sizeof(float4) + 2 * sizeof(float)) +
                      (size_t)cap * capw * sizeof(unsigned long long);
  // the shared-memory limit is the largest any call takes, so that calls
  // from two host threads never lower it under each other's launch
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(nms_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kLimitSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        nms_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // the largest size of which all B clusters fit at once, else the
  // smallest; how many fit is asked of the runtime once for each device,
  // size and shared-memory size (a size the card cannot take fits none)
  static struct { size_t smem; int fit; } fits[64][kNumSizes] = {};
  int C = kSizes[kNumSizes - 1];
  for (int x = 0; x < kNumSizes; ++x) {
    cfg.gridDim = dim3(B * kSizes[x]);
    attr[0].val.clusterDim.x = kSizes[x];
    int fit = 0;
    if (dev < 64 && fits[dev][x].smem == smem) {
      fit = fits[dev][x].fit;
    } else {
      if (cudaOccupancyMaxActiveClusters(&fit, nms_kernel, &cfg) !=
          cudaSuccess) {
        fit = 0;
        cudaGetLastError();
      }
      if (dev < 64) fits[dev][x] = {smem, fit};
    }
    if (B <= fit) {
      C = kSizes[x];
      break;
    }
  }
  cfg.gridDim = dim3(B * C);
  attr[0].val.clusterDim.x = C;
  err = cudaLaunchKernelEx(
      &cfg, nms_kernel, static_cast<const float4*>(boxes),
      static_cast<const float*>(ids), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), static_cast<unsigned long long*>(mask),
      static_cast<float4*>(gbox), static_cast<float*>(gid), N, cap, thresh,
      force);
  return (int)err;
}

#ifdef NMS_PROBE
// Where the probe build stamps its clocks: kProbeSlots words a block, or
// nullptr for none
int mxt_nms_probe(void* p) {
  return (int)cudaMemcpyToSymbol(g_probe, &p, sizeof(p));
}
#endif

}  // extern "C"
