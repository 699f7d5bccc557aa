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
// the matrix unit, its way around gathers.  Here each query reads its
// 2x2xC taps directly.
//
// Bound: bytes.  Per query the forward reads u, v and writes C floats, the
// backward reads u, v and C cotangents: 20 B at C = 3, 7 us for the 1.2M
// queries of a stage-2 step at 3.35 TB/s, against ~0.8 us of arithmetic.
//
// Forward: a stream of queries in, samples out, with an env read at random
// (6-24 KB on the bench paths; 384 KB at the reference's default H = 128).  Each thread takes groups of
// four queries: one 16-byte load each of u and v, and the group's 4*C
// outputs, which are contiguous and start 16-byte aligned, as C 16-byte
// stores.  The env is staged in each block's shared memory: 12 random
// reads per query are cheaper there than from L1.  Staging costs the
// env's bytes of L2 reads per block, so the grid is two blocks of 512
// threads per SM at most (1,024 threads: enough 16-byte loads in flight
// to keep memory busy); the env's loads are 16 bytes wide and unrolled,
// the first group's coordinates are loaded before the staging, so their
// latency hides behind it, and every later group's load is issued before
// the current group's outputs are stored.  On an H100 at the 1.2M
// queries of a stage-2 step, reading the env in place from L1 was slower,
// and so were staging each texel as a float4 (one 16-byte shared load per
// tap) and one block of 1,024 threads per SM.
// An env past a block's shared memory (H >= 99 at W = 2H, C = 3) is read
// in place instead, through the read-only path of L1 and L2, with the same
// groups, loads and stores.
// Coordinates that are not 16-byte aligned take scalar loads, a last
// partial group scalar stores.  Products and sums are rounded one by one (__fmul_rn,
// __fadd_rn, no contraction into fused multiply-adds), in the order of
// the plain version (rows first, then columns), so the two agree exactly.
//
// Backward: 1.2M queries x 4 taps x C land on H*W*C floats, so global
// atomics would serialise on a few thousand addresses.  Each block sums its
// queries into a private copy of d_env in shared memory (shared-memory
// atomics: the order within a block varies from run to run, which costs
// float32 rounding, about 1e-6 of the largest |d_env| on the stage-2 bench
// step; chip_smoke.py holds it to 1e-5), writes the copy to partial[block],
// and a second launch sums the partials over the blocks in a fixed order.
// An env past a block's shared memory has no private copies: the queries
// add into d_env in device memory with float atomics (zero-filled by the
// caller), spread over its H*W*C addresses, in an order that varies from
// run to run, held to the same 1e-5.
#include <cstdint>

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

static const int kSmemOptInMax = 232448;  // bytes of shared memory a block may use
static const int kFwdThreads = 512;
static const int kFwdBlocksPerSM = 2;  // the wrapper's grid: at most 2 per SM
static const int kFwdQueries = 4;      // queries per thread and group

// The coordinates of group gi (queries 4gi .. 4gi+3; past m: 0).
__device__ __forceinline__ void svgir_env_load_group(const float* __restrict__ u,
                                                     const float* __restrict__ v, long long m,
                                                     long long gi, bool vec_uv, float* uq,
                                                     float* vq) {
  const long long q0 = gi * kFwdQueries;
  if (vec_uv && q0 + kFwdQueries <= m) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(u + q0));
    const float4 b = __ldg(reinterpret_cast<const float4*>(v + q0));
    uq[0] = a.x, uq[1] = a.y, uq[2] = a.z, uq[3] = a.w;
    vq[0] = b.x, vq[1] = b.y, vq[2] = b.z, vq[3] = b.w;
  } else {
#pragma unroll
    for (int k = 0; k < kFwdQueries; ++k) {
      const bool in = q0 + k < m;
      uq[k] = in ? __ldg(u + q0 + k) : 0.f;
      vq[k] = in ? __ldg(v + q0 + k) : 0.f;
    }
  }
}

// A texel of the env: staged in shared memory, or read in place (G).
template <bool G>
__device__ __forceinline__ float svgir_env_tex(const float* p) {
  if constexpr (G) return __ldg(p);
  else return *p;
}

// One query's sample of one channel from its first tap e00, rows blended
// first, then columns.
template <bool G>
__device__ __forceinline__ float svgir_env_sample(const float* e00, int wc, int c, float wu,
                                                  float wv) {
  const float r0 = svgir_lerp_rn(svgir_env_tex<G>(e00), svgir_env_tex<G>(e00 + wc), wv);
  const float r1 = svgir_lerp_rn(svgir_env_tex<G>(e00 + c), svgir_env_tex<G>(e00 + wc + c), wv);
  return svgir_lerp_rn(r0, r1, wu);
}

// CT: the channel count where it is known when compiling (3 on every path
// of the port), 0 for a count known only at run time (c_rt).  G: the env is
// read in place from device memory, not staged.
template <int CT, bool G>
__global__ void __launch_bounds__(kFwdThreads, kFwdBlocksPerSM)
svgir_env_fwd_kernel(const float* __restrict__ env, const float* __restrict__ u,
                     const float* __restrict__ v, long long m, int h, int w, int c_rt,
                     bool vec_uv, float* __restrict__ out) {
  extern __shared__ float4 s_env4[];
  float* s_env = reinterpret_cast<float*>(s_env4);
  const int c = CT > 0 ? CT : c_rt;
  const long long ngroups = (m + kFwdQueries - 1) / kFwdQueries;
  const long long stride = (long long)gridDim.x * kFwdThreads;
  long long gi = (long long)blockIdx.x * kFwdThreads + threadIdx.x;
  // the first group's coordinates are in flight while the env is staged
  float uq[kFwdQueries], vq[kFwdQueries];
  if (gi < ngroups) svgir_env_load_group(u, v, m, gi, vec_uv, uq, vq);
  // the env's loads are unrolled so that several are in flight at once
  const int hwc = h * w * c;
  if constexpr (G) {
    s_env = const_cast<float*>(env);
  } else {
    if ((hwc & 3) == 0 && ((uintptr_t)env & 15) == 0) {
      const float4* e4 = reinterpret_cast<const float4*>(env);
#pragma unroll 4
      for (int i = threadIdx.x; i < hwc / 4; i += kFwdThreads) s_env4[i] = __ldg(e4 + i);
    } else {
#pragma unroll 4
      for (int i = threadIdx.x; i < hwc; i += kFwdThreads) s_env[i] = __ldg(env + i);
    }
    __syncthreads();
  }
  const int wc = w * c;
  for (; gi < ngroups; gi += stride) {
    int base[kFwdQueries];
    float wu[kFwdQueries], wv[kFwdQueries];
#pragma unroll
    for (int k = 0; k < kFwdQueries; ++k) {
      int su, sv;
      svgir_env_tap(uq[k], w, su, wu[k]);
      svgir_env_tap(vq[k], h, sv, wv[k]);
      base[k] = (sv * w + su) * c;
    }
    const long long q0 = gi * kFwdQueries;
    float* o = out + q0 * c;
    if (q0 + kFwdQueries <= m) {
      // the group's 4*c outputs are contiguous and start 16-byte aligned:
      // float4 j holds outputs 4j..4j+3, query idx / c, channel idx % c
#pragma unroll
      for (int j = 0; j < c; ++j) {
        float r[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int idx = 4 * j + e, k = idx / c, ch = idx - k * c;
          r[e] = svgir_env_sample<G>(s_env + base[k] + ch, wc, c, wu[k], wv[k]);
        }
        reinterpret_cast<float4*>(o)[j] = make_float4(r[0], r[1], r[2], r[3]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kFwdQueries; ++k) {
        if (q0 + k >= m) break;
        for (int ch = 0; ch < c; ++ch)
          o[k * c + ch] = svgir_env_sample<G>(s_env + base[k] + ch, wc, c, wu[k], wv[k]);
      }
    }
    if (gi + stride < ngroups) svgir_env_load_group(u, v, m, gi + stride, vec_uv, uq, vq);
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

// The backward of an env past shared memory: each query adds its four
// weighted taps into d_env (zero-filled) with float atomics.
__global__ void __launch_bounds__(1024)
svgir_env_bwd_global_kernel(const float* __restrict__ u, const float* __restrict__ v,
                            const float* __restrict__ g, long long m, int h, int w, int c,
                            float* __restrict__ d_env) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x; q < m; q += stride) {
    int su, sv;
    float wu, wv;
    svgir_env_tap(u[q], w, su, wu);
    svgir_env_tap(v[q], h, sv, wv);
    float* d00 = d_env + ((size_t)sv * w + su) * c;
    float* d10 = d00 + (size_t)w * c;
    for (int ch = 0; ch < c; ++ch) {
      const float gq = g[q * c + ch];
      const float a0 = (1.f - wu) * gq, a1 = wu * gq;
      atomicAdd(d00 + ch, (1.f - wv) * a0);
      atomicAdd(d00 + c + ch, (1.f - wv) * a1);
      atomicAdd(d10 + ch, wv * a0);
      atomicAdd(d10 + c + ch, wv * a1);
    }
  }
}

__global__ void svgir_env_bwd_reduce_kernel(const float* __restrict__ partial, int nblocks,
                                            int hwc, float* __restrict__ d_env) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= hwc) return;
  float s = 0.f;
  for (int b = 0; b < nblocks; ++b) s += partial[(size_t)b * hwc + i];
  d_env[i] = s;
}

static const int kEnvThreads = 1024;  // backward

// Forward: out [m, c], 16-byte aligned (refused, as an invalid value,
// otherwise; u and v need not be).  nblocks (>= 1) blocks of 512 threads
// stride over the groups of four queries; each stages the env in h*w*c*4
// bytes of shared memory, or reads it in place where that exceeds what a
// block may opt in to.
template <int CT>
static cudaError_t launch_env_forward(const float* env, const float* u, const float* v,
                                      long long m, int h, int w, int c, int nblocks,
                                      bool vec_uv, float* out, cudaStream_t s) {
  const size_t smem = (size_t)h * w * c * sizeof(float);
  if (smem > (size_t)kSmemOptInMax) {
    if (m > 0)
      svgir_env_fwd_kernel<CT, true><<<nblocks, kFwdThreads, 0, s>>>(env, u, v, m, h, w, c,
                                                                     vec_uv, out);
    return cudaSuccess;
  }
  cudaError_t err = svgir_smem_opt_in(svgir_env_fwd_kernel<CT, false>, smem);
  if (err == cudaSuccess && m > 0)
    svgir_env_fwd_kernel<CT, false><<<nblocks, kFwdThreads, smem, s>>>(env, u, v, m, h, w, c,
                                                                      vec_uv, out);
  return err;
}

extern "C" int svgir_env_lookup_forward(const float* env, const float* u, const float* v,
                                        long long m, int h, int w, int c, int nblocks,
                                        float* out, void* stream) {
  if (h < 2 || w < 2 || c < 1 || nblocks < 1 || ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  const bool vec_uv = (((uintptr_t)u | (uintptr_t)v) & 15) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err =
      c == 3 ? launch_env_forward<3>(env, u, v, m, h, w, c, nblocks, vec_uv, out, s)
             : launch_env_forward<0>(env, u, v, m, h, w, c, nblocks, vec_uv, out, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Backward: d_env [h, w, c] from the cotangents g [m, c].  With partial
// (nblocks * h*w*c floats of scratch, every one of them written) each
// block sums into shared memory and a second launch adds the blocks;
// without it (an env past shared memory) the queries add into d_env,
// which the caller zero-fills, with float atomics.
extern "C" int svgir_env_lookup_backward(const float* u, const float* v, const float* g,
                                         long long m, int h, int w, int c, int nblocks,
                                         float* partial, float* d_env, void* stream) {
  if (h < 2 || w < 2 || c < 1 || nblocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (partial == nullptr) {
    if (m > 0)
      svgir_env_bwd_global_kernel<<<nblocks, kEnvThreads, 0, s>>>(u, v, g, m, h, w, c, d_env);
    return (int)cudaGetLastError();
  }
  const int hwc = h * w * c;
  const size_t smem = (size_t)hwc * sizeof(float);
  cudaError_t err = svgir_smem_opt_in(svgir_env_bwd_partial_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  svgir_env_bwd_partial_kernel<<<nblocks, kEnvThreads, smem, s>>>(u, v, g, m, h, w, c, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  svgir_env_bwd_reduce_kernel<<<(hwc + 255) / 256, 256, 0, s>>>(partial, nblocks, hwc, d_env);
  return (int)cudaGetLastError();
}
