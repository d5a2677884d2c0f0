// A probe of the fused attention forward's K/V staging:
// fused_attention.cu's fused_fwd_kernel<T, DP, STAGES> with one stage
// (K and V of tile kt copied while the other blocks of the SM multiply)
// and with two (tile kt + 1 in flight while tile kt is multiplied, at
// more shared memory a block and so fewer blocks an SM). Built and timed
// by mxnet_tpu_torch/tools/probe_fused_fwd.py; nothing in the package
// calls it. The package launches FWD_STAGES.

#include "fused_attention.cu"

// stages: 1 or 2; every other argument as mxt_fused_attention_fwd's.
// Returns the cudaError_t of the launch.
extern "C" int mxt_probe_fused_fwd(
    int stages, const void* q, const void* k, const void* v,
    const void* bias, const void* seed, void* o, void* o32, void* m, void* l,
    const long long* strides, int B, int H, int Tq, int Tk, int D,
    float scale, float inv_keep, uint32_t threshold, int dropout, int causal,
    int dtype, void* stream) {
  if (D < 1 || D > MAX_D || (stages != 1 && stages != 2))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || Tq == 0) return (int)cudaSuccess;
  const Geometry g =
      geometry(H, Tq, Tk, D, scale, inv_keep, threshold, dropout, causal);
  const float* bs = static_cast<const float*>(bias);
  const int* sd = static_cast<const int*>(seed);
  float* of = static_cast<float*>(o32);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MXT_PROBE(T, DP, S)                                                \
  return launch_fwd<T, DP, S>(q, k, v, bs, sd, o, of, mf, lf, strides, B, \
                              g, st)
#define MXT_PROBE_DP(T, S)                                                 \
  if (D <= 64) MXT_PROBE(T, 64, S);                                        \
  MXT_PROBE(T, 128, S)
  if (dtype == 0) {
    if (stages == 1) { MXT_PROBE_DP(float, 1); }
    MXT_PROBE_DP(float, 2);
  }
  if (dtype == 1) {
    if (stages == 1) { MXT_PROBE_DP(__nv_bfloat16, 1); }
    MXT_PROBE_DP(__nv_bfloat16, 2);
  }
#undef MXT_PROBE_DP
#undef MXT_PROBE
  return (int)cudaErrorInvalidValue;
}
