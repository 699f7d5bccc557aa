// Shared constants and helpers of the blend kernels (blend_forward.cu,
// blend_backward.cu).  The constants equal svgir_tpu_torch/ops/common.py.
//
// Instance slab row layout (one row of KR floats per instance):
//   0 x, 1 y, 2 conic_xx, 3 conic_xy, 4 conic_yy, 5 opacity,
//   6..9 j0..j3 (screen -> tangent 2x2), 10 lam_x, 11 lam_y
//   NG .. NG+CA-1          plain channels, blended with weight w
//   NG+CA + vtx*CV + c     vertex channels (v-major), blended with
//                          w * bilinear weight of vertex vtx
#pragma once

#include <cuda_runtime.h>

#define SVGIR_NG 12
#define SVGIR_ALPHA_MIN (1.0f / 255.0f)
#define SVGIR_ALPHA_MAX 0.99f
#define SVGIR_LOG_T_EPS (-9.210340371976182f)
#define SVGIR_FULL_MASK 0xffffffffu

// Butterfly sum over the warp.  Every lane ends with a sum, and lane 0's
// is formed in the same order on every run, so callers read lane 0 only:
// the reductions stay deterministic without atomics.
__device__ __forceinline__ float svgir_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(SVGIR_FULL_MASK, v, o);
  return v;
}

// Bilinear vertex coordinates of a pixel in a surfel's tangent frame
// (forward.cu:604-617): u, v clamped to [0.001, 0.999], plus the raw values
// and the uv extents the backward needs.
struct SvgirUV {
  float du0, du1, uvmx, uvmy, u_raw, v_raw, u, v;
};

__device__ __forceinline__ SvgirUV svgir_uv(const float* r, float dx, float dy) {
  SvgirUV q;
  q.du0 = dx * r[6] + dy * r[7];
  q.du1 = dx * r[8] + dy * r[9];
  q.uvmx = 0.5f * r[10] + 0.1f;
  q.uvmy = 0.5f * r[11] + 0.1f;
  q.u_raw = q.du0 / q.uvmx * 0.5f + 0.5f;
  q.v_raw = q.du1 / q.uvmy * 0.5f + 0.5f;
  q.u = fminf(fmaxf(q.u_raw, 0.001f), 0.999f);
  q.v = fminf(fmaxf(q.v_raw, 0.001f), 0.999f);
  return q;
}

// Dynamic shared memory above the 48 KB default needs an opt-in per kernel.
template <typename Kernel>
__host__ cudaError_t svgir_smem_opt_in(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}
