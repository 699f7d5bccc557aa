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
#include <cstdint>

#define SVGIR_NG 12
#define SVGIR_ALPHA_MIN (1.0f / 255.0f)
#define SVGIR_ALPHA_MAX 0.99f
#define SVGIR_LOG_T_EPS (-9.210340371976182f)
#define SVGIR_FULL_MASK 0xffffffffu
#define SVGIR_SMEM_MAX 232448  // bytes of shared memory a Hopper block may opt in to

// Butterfly sum over the warp.  Every lane ends with a sum, and lane 0's
// is formed in the same order on every run, so callers read lane 0 only:
// the reductions stay deterministic without atomics.
__device__ __forceinline__ float svgir_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(SVGIR_FULL_MASK, v, o);
  return v;
}

// The least power at which an instance of opacity o can pass the footprint
// test, less a margin: below it o * exp(power) < 1/255 whatever the
// rounding of expf and of the product (a few ulp, against a margin of 1e-3
// in the exponent), so the kernels skip expf there and the pair stays out,
// as it would have.  No positive opacity: no power passes.
__device__ __forceinline__ float svgir_power_floor(float o) {
  return o > 0.f ? logf(SVGIR_ALPHA_MIN / o) - 1e-3f : __int_as_float(0x7f800000);
}

// log(1 - alpha) of a pair that passes the footprint test, at the pixel
// (px, py), given the pair's float32 alpha (its decisions' value).  From
// alpha 0.5 up, d log(1 - alpha) / d alpha = -1 / (1 - alpha) reaches
// -100 below the 0.99 clamp, and log1pf(-alpha) carried alpha's own
// float32 rounding and expf's last bits (6e-8 each) into the term 100-fold:
// at the recipe's size on an H100 a pixel's logT lay 1.9e-5 from exact.
// There 1 - alpha is formed as (1 - o) - o expm1(power), two terms of one
// sign for an activated opacity o <= 1, from the power evaluated in
// float64 (thin splats cancel its terms: 70x the power measured) and
// rounded once: the term lands within a few ulp.  Below 0.5, and for
// o > 1 (test inputs only), log1pf(-alpha) as the plain version.
__device__ __forceinline__ float svgir_log1m_alpha(const float* r, float px, float py,
                                                   float alpha) {
  const float o = r[5];
  if (alpha < 0.5f || o > 1.f) return log1pf(-alpha);
  const double dx = (double)r[0] - (double)px, dy = (double)r[1] - (double)py;
  const float power =
      (float)(-0.5 * ((double)r[2] * dx * dx + (double)r[4] * dy * dy) - (double)r[3] * dx * dy);
  return logf(fmaxf(1.f - SVGIR_ALPHA_MAX, (1.f - o) - o * expm1f(power)));
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

// The lane blocks of PPT pixels: BX x BY (PPT 1: 1x1, 2: 1x2, 4: 2x2).
template <int PPT>
struct SvgirLaneBlock {
  static constexpr int BX = PPT == 4 ? 2 : 1, BY = PPT / BX;
};

// Top-left pixel (x0, y0) of the lane block of thread (warp, lane) in a
// tile of side `tile`: lanes hold their blocks in an 8 x 4 grid, so a warp
// covers an (8 BX) x (4 BY) patch; patches tile the tile row-major.  Pixel
// j of the block is (x0 + j % BX, y0 + j / BX).
template <int PPT>
__device__ __forceinline__ void svgir_lane_origin(int warp, int lane, int tile, int& x0,
                                                  int& y0) {
  using LB = SvgirLaneBlock<PPT>;
  const int pw = 8 * LB::BX, ph = 4 * LB::BY;
  const int wpr = tile / pw;
  x0 = (warp % wpr) * pw + (lane & 7) * LB::BX;
  y0 = (warp / wpr) * ph + (lane >> 3) * LB::BY;
}

// Index in the tile of pixel j of thread (warp, lane).
template <int PPT>
__device__ __forceinline__ int svgir_pixel(int warp, int lane, int j, int tile) {
  using LB = SvgirLaneBlock<PPT>;
  int x0, y0;
  svgir_lane_origin<PPT>(warp, lane, tile, x0, y0);
  return (y0 + j / LB::BX) * tile + x0 + j % LB::BX;
}

// Whether the patches of PPT pixels a lane tile a tile of side `tile`.
__host__ __device__ constexpr bool svgir_ppt_fits(int ppt, int tile) {
  return tile % (ppt == 4 ? 16 : 8) == 0;
}

// A load from shared memory that the compiler neither keeps in a register
// nor hoists: each use reads again (for per-thread values parked there to
// spare registers).
__device__ __forceinline__ float svgir_lds(const float* p) {
  float v;
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(a));
  return v;
}

// Asynchronous copies from device to shared memory (cp.async, sm_80+):
// issued by each thread, committed as a group, waited for before the
// barrier that publishes the data.
__device__ __forceinline__ void svgir_cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void svgir_cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void svgir_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void svgir_cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copies n floats from device to shared memory, by `stride` threads from
// `tid`: asynchronously (ASYNC; the caller commits and waits) in 16-byte
// pieces where both ends allow it, else with plain loads and stores.
template <bool ASYNC>
__device__ __forceinline__ void svgir_stage(float* dst, const float* src, int n, int tid,
                                            int stride) {
  if constexpr (ASYNC) {
    if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0 &&
        (n & 3) == 0) {
      for (int e = 4 * tid; e < n; e += 4 * stride) svgir_cp_async16(dst + e, src + e);
    } else {
      for (int e = tid; e < n; e += stride) svgir_cp_async4(dst + e, src + e);
    }
  } else {
    for (int e = tid; e < n; e += stride) dst[e] = src[e];
  }
}

// A kernel's resident blocks per SM at this block size and shared memory,
// into info[0..4) with the threads, pixels per thread and bytes.
template <typename Kernel>
__host__ int svgir_occupancy(Kernel kernel, int threads, int ppt, size_t smem, int* info) {
  int blocks = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  info[0] = blocks;
  info[1] = threads;
  info[2] = ppt;
  info[3] = (int)smem;
  return (int)err;
}

// Dynamic shared memory above the 48 KB default needs an opt-in per kernel.
template <typename Kernel>
__host__ cudaError_t svgir_smem_opt_in(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}
