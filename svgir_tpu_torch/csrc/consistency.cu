// svgir_consistency_forward / svgir_consistency_backward: the one-bounce
// irradiance of the stage-2 radiance-consistency loss at one chosen sample
// per surfel (svgir_tpu_torch/models/radiance.py irradiance_sample), and
// its gradient with respect to the env term, the albedo and the roughness.
//
// What it replaces: on the training path, radiance.py's _hit_table +
// _irradiance_from_table, which concatenate an [N, 9S+25] table (524,288 x
// 601 floats, 1.26 GB at the recipe's size), gather a whole row for every
// surfel (misses and dead rows read row 0) and shade [N, S, 4, 3]
// temporaries that autograd keeps; the gather's backward, a sort-based
// index_put_ with accumulate over all 601 columns, took 57% of the
// stage-2 step on an H100.  It has no Pallas counterpart: the JAX package
// leaves the gather and the shading to XLA (svgir_tpu/models/radiance.py),
// so this pair replaces no TPU kernel.  The plain version stays for CPU
// tensors (and for irradiance_full, the relighting's re-bake).
//
// Inputs, read in place: the bake's incident_dirs [N, S, 3], hit_idx
// [N, S] (int32) and uv [N, S, 2], env_term [N, S, 3], the vertex
// normals [N, 4, 3] (no gradient), albedo [N, 4, 3], roughness [N], and
// per query (surfel) i of M its primary direction pri_dir [M, 3] and hit
// hit [M] (the row it hit, or < 0; a row past N - 1 reads row N - 1, as
// the plain version's clamp).
//
// Forward: one warp a query.  A query whose hit is < 0 writes 0 (the
// plain version's where) and its warp leaves.  Else the warp reads the hit
// row h in place: every lane the row's per-vertex terms (broadcast loads),
// lane l the samples l, l + 32, ...; a sample whose own hit_idx[h, s] is
// >= 0 is occluded and adds nothing (the plain version's where).  Each
// unoccluded sample evaluates shading_brdf_simple(-pri_dir, dir, n_v,
// albedo_v, rough) for the four vertices with the plain version's
// normalizations (the sample direction normalized twice), clamps (1e-6 to
// 1, the denominator 1e-6 to 4 pi), constants and 2^x, blends them with
// the bilinear weights of uv[h, s] and multiplies by env_term[h, s] / S.
// Nothing of [M, S, 4, .] goes to device memory and nothing is saved for
// the backward: it reads the same inputs again.
//
// Backward: one warp a query again.  A query whose hit is < 0, or whose
// d_irr row is all zero (the dead surfels, zeroed by the loss's alive
// mask), leaves at once: the plain version adds exact zeros for both.
// Else each lane recomputes its samples' terms in registers and takes the
// gradient as autograd takes it through the plain version: env_term's
// directly, the albedo's through albedo / pi, the roughness's through
// alpha, alpha^2, k and the GGX denominator (zero where the denominator's
// clamp is active, both ends inclusive, as torch.clamp's backward).  The
// clamps on N.L, N.V, N.H and V.H pass no gradient: the directions and
// normals are constants.
//
// Bound: bytes.  The forward reads every query's hit, each hit query's
// direction and, once for each distinct hit row, its S int32 hit_idx, the
// 8 floats (direction, uv, env term) of each of its unoccluded samples
// and its 25 per-vertex floats (2,404 B at S = 64 where no sample is
// occluded), and writes the irradiance.  The backward reads every
// query's cotangent, the same rows for the hit queries whose cotangent is
// not zero, and writes its three gradients whole ((3S + 13) x 4 B a row,
// 430 MB at the recipe's 524,288 rows, most of it the wrapper's zero
// fill).  The arithmetic, about 100 flops a (sample, vertex), stays
// below that: with every one of 524,288 queries hitting at S = 64 and no
// sample occluded, 13 GFLOP (0.2 ms at 67 TFLOP/s) against 1.26 GB of
// rows (0.38 ms).
//
// Summation order and tolerance.  Forward: each lane sums its samples in
// order, then the warp's butterfly (svgir_warp_sum, lane 0's sum written):
// deterministic, in another order than PyTorch's sum over S.  Backward: a
// query's albedo and roughness sums over its samples by the butterfly;
// across the queries that hit one row, and for env_term's rows, float32
// atomics into zero-filled gradients (the wrapper zeroes them), in an
// order that changes from run to run.  Tolerance: near a specular peak
// GGX's denominator, NoH^2 (alpha^2 - 1) + 1, and the half vector of
// nearly opposite directions amplify float32 rounding, so the float32
// plain version itself lies up to about 1e-4 to 6e-4 from float64 (of an
// output's largest magnitude) on random inputs.  chip_smoke.py holds the
// forward and the three gradients to the plain version evaluated in
// float64, element by element and in the norm, within 4 times the float32
// plain version's own error on the same inputs (TOL_CONSISTENCY_RATIO), or
// 1e-4 where that is larger (TOL_CONSISTENCY_FLOOR).
#include <climits>
#include <cstdint>

#include "blend_common.cuh"

namespace {

constexpr int kWarps = 8;                // queries (warps) a block
constexpr int kThreads = kWarps * 32;
constexpr float kFourPi = 12.566370614359172f;   // 4 * math.pi, as float32
constexpr float kInvPi = 1.f / 3.14159265358979f;  // PyTorch's x / math.pi
constexpr float kClampLo = 1e-6f;

struct Vec3 {
  float x, y, z;
};

__device__ __forceinline__ float dot3(Vec3 a, Vec3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

// utils/transforms.py normalize: v * rsqrt(max(|v|^2, 1e-24))
__device__ __forceinline__ Vec3 normalize3(Vec3 v) {
  const float r = rsqrtf(fmaxf(dot3(v, v), 1e-24f));
  return {v.x * r, v.y * r, v.z * r};
}

__device__ __forceinline__ float clamp_unit(float x) { return fminf(fmaxf(x, kClampLo), 1.f); }

__device__ __forceinline__ Vec3 load3(const float* __restrict__ p) { return {p[0], p[1], p[2]}; }

// The hit row's terms that do not depend on the sample, and the query's
// view direction.
struct Row {
  Vec3 v;          // normalize(-pri_dir)
  Vec3 n[4];       // normalize(normal_v)
  float nov[4];    // clamp(N.V)
  float nom1[4];   // NoV (1 - k) + k
  float alb[12];   // albedo, vertex-major
  float r, alpha, alpha2, k;
};

__device__ __forceinline__ void load_row(Row& q, const float* __restrict__ pri,
                                         const float* __restrict__ nrm,
                                         const float* __restrict__ alb,
                                         const float* __restrict__ rough, long long i,
                                         long long h) {
  const Vec3 p = load3(pri + 3 * i);
  q.v = normalize3({-p.x, -p.y, -p.z});
  q.r = rough[h];
  q.alpha = q.r * q.r;
  q.alpha2 = q.alpha * q.alpha;
  q.k = (q.alpha + 2.f * q.r + 1.f) * 0.125f;
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    q.n[v] = normalize3(load3(nrm + 12 * h + 3 * v));
    q.nov[v] = clamp_unit(dot3(q.n[v], q.v));
    q.nom1[v] = q.nov[v] * (1.f - q.k) + q.k;
  }
#pragma unroll
  for (int j = 0; j < 12; ++j) q.alb[j] = alb[12 * h + j];
}

// One sample of the hit row: bilinear weights, the Fresnel term and, per
// vertex, the GGX denominator before (p) and after (nom) its clamp.
struct Tap {
  float w[4];
  float frac0;
  float nol[4], noh[4], nom0[4], nom2[4], p[4], nom[4];
};

__device__ __forceinline__ void eval_tap(const Row& q, Vec3 d, float u0, float u1, Tap& t) {
  const Vec3 l = normalize3(normalize3(d));
  const Vec3 hv = normalize3({q.v.x + l.x, q.v.y + l.y, q.v.z + l.z});
  const float voh = clamp_unit(dot3(q.v, hv));
  const float fmi = (-5.55473f * voh - 6.98316f) * voh;
  t.frac0 = 0.04f + 0.96f * exp2f(fmi);
  t.w[0] = (1.f - u0) * (1.f - u1);
  t.w[1] = u0 * (1.f - u1);
  t.w[2] = (1.f - u0) * u1;
  t.w[3] = u0 * u1;
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    t.nol[v] = clamp_unit(dot3(q.n[v], l));
    t.noh[v] = clamp_unit(dot3(q.n[v], hv));
    t.nom0[v] = t.noh[v] * t.noh[v] * (q.alpha2 - 1.f) + 1.f;
    t.nom2[v] = t.nol[v] * (1.f - q.k) + q.k;
    t.p[v] = kFourPi * t.nom0[v] * t.nom0[v] * q.nom1[v] * t.nom2[v];
    t.nom[v] = fminf(fmaxf(t.p[v], kClampLo), kFourPi);
  }
}

// sum_v w_v * (frac / nom_v + albedo_v / pi), per colour channel
__device__ __forceinline__ void shade(const Row& q, const Tap& t, float irr[3]) {
  const float frac = t.frac0 * q.alpha2;
  irr[0] = irr[1] = irr[2] = 0.f;
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const float spec = frac / t.nom[v];
#pragma unroll
    for (int c = 0; c < 3; ++c) irr[c] += t.w[v] * (spec + q.alb[3 * v + c] * kInvPi);
  }
}

__global__ void __launch_bounds__(kThreads)
    svgir_consistency_fwd_kernel(const float* __restrict__ dirs, const int* __restrict__ hit_idx,
                                 const float* __restrict__ uv, const float* __restrict__ env,
                                 const float* __restrict__ nrm, const float* __restrict__ alb,
                                 const float* __restrict__ rough, const float* __restrict__ pri,
                                 const int* __restrict__ hit, long long m, long long n, int s_num,
                                 float* __restrict__ irr) {
  const long long i = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= m) return;
  const int hi = hit[i];
  if (hi < 0) {
    if (lane < 3) irr[3 * i + lane] = 0.f;
    return;
  }
  const long long h = hi < n ? (long long)hi : n - 1;
  Row q;
  load_row(q, pri, nrm, alb, rough, i, h);
  const float inv_s = 1.f / (float)s_num;
  float acc[3] = {0.f, 0.f, 0.f};
  for (int s = lane; s < s_num; s += 32) {
    const long long o = h * s_num + s;
    if (hit_idx[o] >= 0) continue;   // occluded
    Tap t;
    eval_tap(q, load3(dirs + 3 * o), uv[2 * o], uv[2 * o + 1], t);
    float e[3];
    shade(q, t, e);
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[c] += e[c] * env[3 * o + c] * inv_s;
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) acc[c] = svgir_warp_sum(acc[c]);
  if (lane == 0) {
    irr[3 * i] = acc[0];
    irr[3 * i + 1] = acc[1];
    irr[3 * i + 2] = acc[2];
  }
}

__global__ void __launch_bounds__(kThreads)
    svgir_consistency_bwd_kernel(const float* __restrict__ dirs, const int* __restrict__ hit_idx,
                                 const float* __restrict__ uv, const float* __restrict__ env,
                                 const float* __restrict__ nrm, const float* __restrict__ alb,
                                 const float* __restrict__ rough, const float* __restrict__ pri,
                                 const int* __restrict__ hit, const float* __restrict__ d_irr,
                                 long long m, long long n, int s_num, float* __restrict__ d_env,
                                 float* __restrict__ d_alb, float* __restrict__ d_rough) {
  const long long i = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= m) return;
  const int hi = hit[i];
  const Vec3 g = load3(d_irr + 3 * i);
  if (hi < 0 || (g.x == 0.f && g.y == 0.f && g.z == 0.f)) return;
  const long long h = hi < n ? (long long)hi : n - 1;
  Row q;
  load_row(q, pri, nrm, alb, rough, i, h);
  const float inv_s = 1.f / (float)s_num;
  const float gs[3] = {g.x * inv_s, g.y * inv_s, g.z * inv_s};
  float ga[12];
#pragma unroll
  for (int j = 0; j < 12; ++j) ga[j] = 0.f;
  float galpha2 = 0.f, gk = 0.f;
  for (int s = lane; s < s_num; s += 32) {
    const long long o = h * s_num + s;
    if (hit_idx[o] >= 0) continue;   // occluded: no gradient
    Tap t;
    eval_tap(q, load3(dirs + 3 * o), uv[2 * o], uv[2 * o + 1], t);
    float e[3];
    shade(q, t, e);
    float gi[3];   // d irr_c: irr_c * env_c / S
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float de = gs[c] * e[c];
      if (de != 0.f) atomicAdd(d_env + 3 * o + c, de);
      gi[c] = gs[c] * env[3 * o + c];
    }
    const float frac = t.frac0 * q.alpha2;
    float gfrac = 0.f;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      float gspec = 0.f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float gb = gi[c] * t.w[v];   // d brdf_vc
        ga[3 * v + c] += gb * kInvPi;
        gspec += gb;
      }
      // spec = frac / nom
      gfrac += gspec / t.nom[v];
      if (t.p[v] >= kClampLo && t.p[v] <= kFourPi) {
        // p = 4 pi nom0^2 nom1 nom2
        const float gp = -gspec * (frac / t.nom[v]) / t.nom[v] * kFourPi;
        const float g_nom0 = gp * 2.f * t.nom0[v] * q.nom1[v] * t.nom2[v];
        const float nom00 = t.nom0[v] * t.nom0[v];
        const float g_nom1 = gp * nom00 * t.nom2[v];
        const float g_nom2 = gp * nom00 * q.nom1[v];
        galpha2 += g_nom0 * t.noh[v] * t.noh[v];      // nom0 = NoH^2 (alpha2 - 1) + 1
        gk += g_nom1 * (1.f - q.nov[v]) + g_nom2 * (1.f - t.nol[v]);   // NoX (1 - k) + k
      }
    }
    galpha2 += gfrac * t.frac0;   // frac = frac0 alpha2
  }
#pragma unroll
  for (int j = 0; j < 12; ++j) ga[j] = svgir_warp_sum(ga[j]);
  galpha2 = svgir_warp_sum(galpha2);
  gk = svgir_warp_sum(gk);
  if (lane == 0) {
    // alpha2 = alpha^2, k = (alpha + 2 r + 1) / 8, alpha = r^2
    const float galpha = galpha2 * 2.f * q.alpha + gk * 0.125f;
    const float gr = galpha * 2.f * q.r + gk * 0.25f;
#pragma unroll
    for (int j = 0; j < 12; ++j)
      if (ga[j] != 0.f) atomicAdd(d_alb + 12 * h + j, ga[j]);
    if (gr != 0.f) atomicAdd(d_rough + h, gr);
  }
}

long long blocks_for(long long m) { return (m + kWarps - 1) / kWarps; }

}  // namespace

extern "C" int svgir_consistency_forward(const float* dirs, const int* hit_idx, const float* uv,
                                         const float* env, const float* nrm, const float* alb,
                                         const float* rough, const float* pri, const int* hit,
                                         long long m, long long n, int s_num, float* irr,
                                         void* stream) {
  if (m < 0 || n < 1 || s_num < 1 || blocks_for(m) > INT_MAX) return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  svgir_consistency_fwd_kernel<<<(unsigned)blocks_for(m), kThreads, 0, (cudaStream_t)stream>>>(
      dirs, hit_idx, uv, env, nrm, alb, rough, pri, hit, m, n, s_num, irr);
  return (int)cudaGetLastError();
}

extern "C" int svgir_consistency_backward(const float* dirs, const int* hit_idx, const float* uv,
                                          const float* env, const float* nrm, const float* alb,
                                          const float* rough, const float* pri, const int* hit,
                                          const float* d_irr, long long m, long long n, int s_num,
                                          float* d_env, float* d_alb, float* d_rough,
                                          void* stream) {
  if (m < 0 || n < 1 || s_num < 1 || blocks_for(m) > INT_MAX) return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  svgir_consistency_bwd_kernel<<<(unsigned)blocks_for(m), kThreads, 0, (cudaStream_t)stream>>>(
      dirs, hit_idx, uv, env, nrm, alb, rough, pri, hit, d_irr, m, n, s_num, d_env, d_alb,
      d_rough);
  return (int)cudaGetLastError();
}
