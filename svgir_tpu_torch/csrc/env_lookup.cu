// B7 svgir_env_lookup_forward / svgir_env_lookup_backward replace
// svgir_tpu/ops/env_lookup_pallas.py bilinear_lookup_pallas (_fwd_kernel,
// _bwd_kernel): the align_corners bilinear sample of an env map [H, W, C]
// at M pixel coordinates (u in [0, W-1], v in [0, H-1]), and its gradient
// with respect to the env only, summed over all queries.
//
// Edge semantics (env_lookup_pallas.py:44-53): the floor of a coordinate
// is clipped to [0, size-1], its fraction to [0, 1]; the first tap is the
// floor clamped to size-2, and when the floor sat on the last row or
// column the second tap takes weight 1.
//
// The TPU kernel built 2-tap one-hot weight matrices and contracted them on
// the matrix unit, its way around gathers.  Here one thread per query
// reads its 2x2xC taps directly.  The env (24 KB at 32x64x3) is staged in
// shared memory once per block; blocks stride over the queries.
//
// Bound: bytes.  Per query the forward reads u, v and writes C floats, the
// backward reads u, v and C cotangents: 20 B at C = 3, 7 us for the 1.2M
// queries of a stage-2 step at 3.35 TB/s, against ~0.8 us of arithmetic.
//
// Forward: products and sums are rounded one by one (__fmul_rn,
// __fadd_rn, no contraction into fused multiply-adds), in the order of the
// plain version (rows first, then columns), so the two agree exactly.
//
// Backward: 1.2M queries x 4 taps x C land on H*W*C floats, so global
// atomics would serialise on a few thousand addresses.  Each block sums its
// queries into a private copy of d_env in shared memory (shared-memory
// atomics: the order within a block varies from run to run, which costs
// float32 rounding, about 1e-6 of the largest |d_env| on the stage-2 bench
// step; chip_smoke.py holds it to 1e-5), writes the copy to partial[block],
// and a second launch sums the partials over the blocks in a fixed order.
#include "blend_common.cuh"

__device__ __forceinline__ void svgir_env_tap(float q, int size, int& s, float& w1) {
  const float q0 = fminf(fmaxf(floorf(q), 0.f), (float)(size - 1));
  const float f = fminf(fmaxf(q - q0, 0.f), 1.f);
  const int q0i = (int)q0;
  s = min(q0i, size - 2);
  w1 = q0i > s ? 1.f : f;
}

__device__ __forceinline__ float svgir_lerp_rn(float a, float b, float w) {
  return __fadd_rn(__fmul_rn(1.f - w, a), __fmul_rn(w, b));
}

__global__ void __launch_bounds__(1024)
svgir_env_fwd_kernel(const float* __restrict__ env, const float* __restrict__ u,
                     const float* __restrict__ v, long long m, int h, int w, int c,
                     float* __restrict__ out) {
  extern __shared__ float s_env[];
  const int hwc = h * w * c;
  for (int i = threadIdx.x; i < hwc; i += blockDim.x) s_env[i] = env[i];
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x; q < m; q += stride) {
    int su, sv;
    float wu, wv;
    svgir_env_tap(u[q], w, su, wu);
    svgir_env_tap(v[q], h, sv, wv);
    const float* e00 = s_env + (sv * w + su) * c;  // (sv, su); +c: (sv, su+1)
    const float* e10 = e00 + w * c;                // (sv+1, su)
    for (int ch = 0; ch < c; ++ch) {
      const float r0 = svgir_lerp_rn(e00[ch], e10[ch], wv);
      const float r1 = svgir_lerp_rn(e00[c + ch], e10[c + ch], wv);
      out[q * c + ch] = svgir_lerp_rn(r0, r1, wu);
    }
  }
}

__global__ void __launch_bounds__(1024)
svgir_env_bwd_partial_kernel(const float* __restrict__ u, const float* __restrict__ v,
                             const float* __restrict__ g, long long m, int h, int w, int c,
                             float* __restrict__ partial) {
  extern __shared__ float s_d[];
  const int hwc = h * w * c;
  for (int i = threadIdx.x; i < hwc; i += blockDim.x) s_d[i] = 0.f;
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x; q < m; q += stride) {
    int su, sv;
    float wu, wv;
    svgir_env_tap(u[q], w, su, wu);
    svgir_env_tap(v[q], h, sv, wv);
    float* d00 = s_d + (sv * w + su) * c;
    float* d10 = d00 + w * c;
    for (int ch = 0; ch < c; ++ch) {
      const float gq = g[q * c + ch];
      const float a0 = (1.f - wu) * gq, a1 = wu * gq;
      atomicAdd(d00 + ch, (1.f - wv) * a0);
      atomicAdd(d00 + c + ch, (1.f - wv) * a1);
      atomicAdd(d10 + ch, wv * a0);
      atomicAdd(d10 + c + ch, wv * a1);
    }
  }
  __syncthreads();
  float* dst = partial + (size_t)blockIdx.x * hwc;
  for (int i = threadIdx.x; i < hwc; i += blockDim.x) dst[i] = s_d[i];
}

__global__ void svgir_env_bwd_reduce_kernel(const float* __restrict__ partial, int nblocks,
                                            int hwc, float* __restrict__ d_env) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= hwc) return;
  float s = 0.f;
  for (int b = 0; b < nblocks; ++b) s += partial[(size_t)b * hwc + i];
  d_env[i] = s;
}

static const int kEnvThreads = 1024;

// Forward: out [m, c].  nblocks (>= 1) blocks of 1024 threads stride over
// the queries; each stages the env in h*w*c*4 bytes of shared memory
// (refused, as an invalid value, past what a block may opt in to).
extern "C" int svgir_env_lookup_forward(const float* env, const float* u, const float* v,
                                        long long m, int h, int w, int c, int nblocks,
                                        float* out, void* stream) {
  if (h < 2 || w < 2 || c < 1 || nblocks < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)h * w * c * sizeof(float);
  cudaError_t err = svgir_smem_opt_in(svgir_env_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (m > 0)
    svgir_env_fwd_kernel<<<nblocks, kEnvThreads, smem, (cudaStream_t)stream>>>(env, u, v, m, h,
                                                                               w, c, out);
  return (int)cudaGetLastError();
}

// Backward: d_env [h, w, c] from the cotangents g [m, c]; partial holds
// nblocks * h*w*c floats of scratch, every one of them written.
extern "C" int svgir_env_lookup_backward(const float* u, const float* v, const float* g,
                                         long long m, int h, int w, int c, int nblocks,
                                         float* partial, float* d_env, void* stream) {
  if (h < 2 || w < 2 || c < 1 || nblocks < 1) return (int)cudaErrorInvalidValue;
  const int hwc = h * w * c;
  const size_t smem = (size_t)hwc * sizeof(float);
  cudaError_t err = svgir_smem_opt_in(svgir_env_bwd_partial_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  svgir_env_bwd_partial_kernel<<<nblocks, kEnvThreads, smem, s>>>(u, v, g, m, h, w, c, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  svgir_env_bwd_reduce_kernel<<<(hwc + 255) / 256, 256, 0, s>>>(partial, nblocks, hwc, d_env);
  return (int)cudaGetLastError();
}
