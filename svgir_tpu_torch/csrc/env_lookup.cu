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
// (6-24 KB on the bench paths: H = 16, the configuration's default, and 32,
// the training recipe's; 384 KB at H = 128, the default argument of
// direct_light_map_init).  Each thread takes groups of four queries: one
// 16-byte load each of u and v, and the group's 4*C outputs, which are
// contiguous and start 16-byte aligned, as C 16-byte stores.  The env is staged in each block's shared memory: 12 random
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
// Backward: each query adds 4 taps x C weighted cotangents into d_env; at
// the recipe's shape 3.2M queries land on 6,144 floats, so adds into device
// memory would queue on a few thousand L2 addresses, and the sums are taken
// in copies of d_env in shared memory, which the blocks then add into d_env
// (zero-filled by the caller) with 16-byte float atomics, skipping zeros:
// one launch, no scratch copies in device memory, no second pass over them.
// What bounds it on an H100 are the shared-memory adds.  A shared float
// atomicAdd is a compare-and-swap loop (ATOMS.CAST.SPIN): with one copy a
// block, the adds took 0.059 of the 0.083 ms of the recipe's step, where
// plain adds (wrong sums) took 0.015.  About 3.4 lanes of a warp meet on
// one bank per access, and fewer than 2% of a warp's queries share a texel.
// So where a block holds 8 copies or more (the envs of the configuration
// and the recipe: 16x32, 32x64), each warp sums into a copy of its own
// with plain loads and stores (svgir_env_bwd_warps_kernel); lanes that
// share a first texel are found by a byte per texel and add with atomics.
// With 8 warps an SM that route is bound by the latency of the loads and
// of the warp's adds, one tap after the other.  An env with fewer copies
// to a block takes one copy a block of 1,024 threads, two an SM, one query
// a thread, shared atomics (svgir_env_bwd_kernel).  Explicit
// compare-and-swaps issued in batches (ATOMS.CAS), four queries a thread,
// clusters adding their copies through distributed shared memory, sixteen
// queries a lane, and warps holding one channel each all ran slower.
// An env past a block's shared memory (H >= 99 at W = 2H, C = 3) is cut
// into P slices that each fit one block (P = 2 at 128x256, 7 at 256x512);
// blocks come in groups of P, every block of a group reads the group's
// queries and adds only the taps in its slice, then adds its slice into
// d_env.  The order of the adds varies from run to run (float32 rounding,
// about 1e-6 of the largest |d_env| on the stage-2 bench step;
// chip_smoke.py holds it to 1e-5).
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

static const int kBwdThreads = 1024;
static const int kBwdBlocksPerSM = 2;  // the wrapper's grid: at most 2 per SM

// One query's channel: its four weighted taps added into the block's copy
// s with shared atomics (with PARTS, an address outside [0, n) lies in
// another block's slice and is skipped).
template <bool PARTS>
__device__ __forceinline__ void svgir_env_add_taps(float* s, int b, int c, int wc, float wu,
                                                   float wv, float gv, int n) {
  const float a0 = (1.f - wu) * gv, a1 = wu * gv;
  const int at[4] = {b, b + c, b + wc, b + wc + c};
  const float x[4] = {(1.f - wv) * a0, (1.f - wv) * a1, wv * a0, wv * a1};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (!PARTS || (unsigned)at[i] < (unsigned)n) atomicAdd(s + at[i], x[i]);
}

// Adds 16 bytes of a block's summed d_env (floats 4 i4 .. 4 i4 + 3) into
// d_env in device memory (16-byte aligned), skipping zeros: one vector
// atomic where CUDA has it for sm_90.
__device__ __forceinline__ void svgir_env_flush(float* d_env, int hwc, int i4, float4 x) {
  if (x.x == 0.f && x.y == 0.f && x.z == 0.f && x.w == 0.f) return;
  const int e = 4 * i4;
#if __CUDACC_VER_MAJOR__ * 100 + __CUDACC_VER_MINOR__ >= 1202
  if (e + 4 <= hwc) {
    atomicAdd(reinterpret_cast<float4*>(d_env) + i4, x);
    return;
  }
#endif
  const float y[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (e + j < hwc && y[j] != 0.f) atomicAdd(d_env + e + j, y[j]);
}

static const int kWarpQueries = 8;  // queries a lane holds: a warp's window is 256
static const int kWarpThreadsMax = 512;

// One query's channel into a warp's own copy s, one tap at a time: plain
// loads and stores for a lane that holds its first texel alone (on), a
// shared atomicAdd for one that shares it (shared), with a __syncwarp
// between taps so that one lane's store comes before another lane's load
// of the same float (lanes with different first texels meet only across
// taps, never within one).
__device__ __forceinline__ void svgir_env_warp_taps(float* s, bool on, bool shared, int b, int c,
                                                    int wc, float wu, float wv, float gv) {
  const float a0 = (1.f - wu) * gv, a1 = wu * gv;
  const int at[4] = {b, b + c, b + wc, b + wc + c};
  const float x[4] = {(1.f - wv) * a0, (1.f - wv) * a1, wv * a0, wv * a1};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (on) s[at[i]] = __fadd_rn(s[at[i]], x[i]);
    else if (shared) atomicAdd(s + at[i], x[i]);
    __syncwarp();
  }
}

// The backward of an env whose copy of d_env fits a block's shared memory
// many times over (the wrapper's plan: at least 8, with a byte per texel):
// one copy per warp, so no two warps add into one float and most adds are
// plain loads and stores in place of shared atomics.  A warp takes windows
// of 256 consecutive queries, lane l queries l, l + 32, ... (consecutive
// queries rarely share a texel), the next window's loads issued before
// this one's adds.  For each query slot the lanes write their lane into
// the byte of their first texel and read it back: the lane whose write
// stayed adds its taps with plain loads and stores; afterwards, and only
// where some lane lost, the others add theirs with shared atomics.  At the
// end the block adds its warps' copies in warp order and adds the sum into
// d_env (zero-filled by the caller).
template <int CT>
__global__ void __launch_bounds__(kWarpThreadsMax, 1)
svgir_env_bwd_warps_kernel(const float* __restrict__ u, const float* __restrict__ v,
                           const float* __restrict__ g, long long m, int h, int w, int c_rt,
                           int copy_floats, float* __restrict__ d_env) {
  extern __shared__ float4 s_d4[];
  constexpr int CG = CT > 0 ? CT : 1;
  const int c = CT > 0 ? CT : c_rt;
  const int hwc = h * w * c, wc = w * c;
  const int nwarps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n4 = copy_floats / 4;
  float* s_w = reinterpret_cast<float*>(s_d4) + warp * copy_floats;
  unsigned char* tag = reinterpret_cast<unsigned char*>(s_d4 + n4 * nwarps) +
                       warp * ((h * w + 15) & ~15);
  const long long window = 32 * kWarpQueries;
  const long long stride = (long long)gridDim.x * nwarps * window;
  long long w0 = ((long long)blockIdx.x * nwarps + warp) * window;
  float uq[kWarpQueries], vq[kWarpQueries], gq[kWarpQueries * CG];
  auto load = [&](long long base) {
#pragma unroll
    for (int k = 0; k < kWarpQueries; ++k) {
      const long long q = base + 32 * k + lane;
      const bool in = q < m;
      uq[k] = in ? __ldg(u + q) : 0.f;
      vq[k] = in ? __ldg(v + q) : 0.f;
      if constexpr (CT > 0) {
#pragma unroll
        for (int ch = 0; ch < CT; ++ch) gq[k * CT + ch] = in ? __ldg(g + q * CT + ch) : 0.f;
      }
    }
  };
  if (w0 < m) load(w0);
  for (int i = threadIdx.x; i < n4 * nwarps; i += blockDim.x)
    s_d4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  for (; w0 < m; w0 += stride) {  // the same trips for every lane
    int tex[kWarpQueries];
    float wu[kWarpQueries], wv[kWarpQueries], gc[kWarpQueries * CG];
#pragma unroll
    for (int k = 0; k < kWarpQueries; ++k) {
      int su, sv;
      svgir_env_tap(uq[k], w, su, wu[k]);
      svgir_env_tap(vq[k], h, sv, wv[k]);
      tex[k] = sv * w + su;
    }
#pragma unroll
    for (int j = 0; j < kWarpQueries * CG; ++j) gc[j] = gq[j];
    if (w0 + stride < m) load(w0 + stride);
#pragma unroll
    for (int k = 0; k < kWarpQueries; ++k) {
      const long long q = w0 + 32 * k + lane;
      const bool valid = q < m;
      if (valid) tag[tex[k]] = (unsigned char)lane;
      __syncwarp();
      const bool alone = valid && tag[tex[k]] == lane;
      const bool lost = __any_sync(0xffffffffu, valid && !alone);
#pragma unroll
      for (int ch = 0; ch < c; ++ch) {
        const float gv = CT > 0 ? gc[k * CG + ch] : (valid ? __ldg(g + q * c + ch) : 0.f);
        svgir_env_warp_taps(s_w, alone, false, tex[k] * c + ch, c, wc, wu[k], wv[k], gv);
        if (lost)
          svgir_env_warp_taps(s_w, false, valid && !alone, tex[k] * c + ch, c, wc, wu[k], wv[k],
                              gv);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n4; i += blockDim.x) {
    float4 acc = s_d4[i];
    for (int q = 1; q < nwarps; ++q) {
      const float4 x = s_d4[q * n4 + i];
      acc.x = __fadd_rn(acc.x, x.x), acc.y = __fadd_rn(acc.y, x.y);
      acc.z = __fadd_rn(acc.z, x.z), acc.w = __fadd_rn(acc.w, x.w);
    }
    svgir_env_flush(d_env, hwc, i, acc);
  }
}

// CT: the channel count where it is known when compiling (3), 0 for c_rt.
// PARTS: d_env is cut into `parts` slices of part_floats floats, block b
// holding slice b % parts and taking the queries of its group b / parts
// (an env past one block's shared memory); else each block holds all of it.
template <int CT, bool PARTS>
__global__ void __launch_bounds__(kBwdThreads, kBwdBlocksPerSM)
svgir_env_bwd_kernel(const float* __restrict__ u, const float* __restrict__ v,
                     const float* __restrict__ g, long long m, int h, int w, int c_rt, int parts,
                     int part_floats, float* __restrict__ d_env) {
  extern __shared__ float4 s_d4[];
  float* s_d = reinterpret_cast<float*>(s_d4);
  const int c = CT > 0 ? CT : c_rt;
  const int hwc = h * w * c, wc = w * c;
  const int np = PARTS ? parts : 1;
  const int lo = PARTS ? (int)(blockIdx.x % np) * part_floats : 0;
  const int n4 = part_floats / 4;
  for (int i = threadIdx.x; i < n4; i += kBwdThreads) s_d4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  const long long stride = (long long)(gridDim.x / np) * kBwdThreads;
  for (long long q = (long long)(blockIdx.x / np) * kBwdThreads + threadIdx.x; q < m;
       q += stride) {
    int su, sv;
    float wu, wv;
    svgir_env_tap(__ldg(u + q), w, su, wu);
    svgir_env_tap(__ldg(v + q), h, sv, wv);
    const int b = (sv * w + su) * c - lo;
#pragma unroll
    for (int ch = 0; ch < c; ++ch)
      svgir_env_add_taps<PARTS>(s_d, b + ch, c, wc, wu, wv, __ldg(g + q * c + ch), part_floats);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n4; i += kBwdThreads)
    svgir_env_flush(d_env, hwc, lo / 4 + i, s_d4[i]);
}

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

template <int CT>
static cudaError_t launch_env_backward(const float* u, const float* v, const float* g,
                                       long long m, int h, int w, int c, int nblocks, int parts,
                                       int part_floats, int warps, float* d_env,
                                       cudaStream_t s) {
  const size_t smem = (size_t)part_floats * sizeof(float);
  if (parts > 1) {
    cudaError_t err = svgir_smem_opt_in(svgir_env_bwd_kernel<CT, true>, smem);
    if (err == cudaSuccess)
      svgir_env_bwd_kernel<CT, true><<<nblocks, kBwdThreads, smem, s>>>(u, v, g, m, h, w, c,
                                                                         parts, part_floats,
                                                                         d_env);
    return err;
  }
  if (warps > 0) {
    const size_t wsmem = ((size_t)part_floats * 4 + ((size_t)h * w + 15) / 16 * 16) * warps;
    cudaError_t err = svgir_smem_opt_in(svgir_env_bwd_warps_kernel<CT>, wsmem);
    if (err == cudaSuccess)
      svgir_env_bwd_warps_kernel<CT><<<nblocks, warps * 32, wsmem, s>>>(u, v, g, m, h, w, c,
                                                                          part_floats, d_env);
    return err;
  }
  cudaError_t err = svgir_smem_opt_in(svgir_env_bwd_kernel<CT, false>, smem);
  if (err == cudaSuccess)
    svgir_env_bwd_kernel<CT, false><<<nblocks, kBwdThreads, smem, s>>>(u, v, g, m, h, w, c, 1,
                                                                        part_floats, d_env);
  return err;
}

// Backward: adds into d_env [h, w, c] (zero-filled by the caller, 16-byte
// aligned) the gradient of the cotangents g [m, c].  d_env is cut into
// `parts` slices of part_floats floats (a multiple of 4, at most what a
// block may opt in to), nblocks a multiple of parts.  With warps > 0 (one
// part) each of the blocks' warps holds a copy of its own and a byte per
// texel.  kernels.env_lookup.backward_plan says which.
extern "C" int svgir_env_lookup_backward(const float* u, const float* v, const float* g,
                                         long long m, int h, int w, int c, int nblocks,
                                         int parts, int part_floats, int warps, float* d_env,
                                         void* stream) {
  if (h < 2 || w < 2 || c < 1 || nblocks < 1 || parts < 1 || part_floats < 4 ||
      (part_floats & 3) || nblocks % parts || (size_t)part_floats * 4 > (size_t)kSmemOptInMax ||
      (long long)parts * part_floats < (long long)h * w * c || ((uintptr_t)d_env & 15) ||
      warps < 0 || warps * 32 > kWarpThreadsMax || (warps > 0 && parts > 1) ||
      ((size_t)part_floats * 4 + ((size_t)h * w + 15) / 16 * 16) * warps >
          (size_t)kSmemOptInMax)
    return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err =
      c == 3 ? launch_env_backward<3>(u, v, g, m, h, w, c, nblocks, parts, part_floats, warps,
                                      d_env, s)
             : launch_env_backward<0>(u, v, g, m, h, w, c, nblocks, parts, part_floats, warps,
                                      d_env, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
