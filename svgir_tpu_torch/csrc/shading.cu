// svgir_shading_forward / svgir_shading_backward: stage 2's per-vertex
// shading on the training path (svgir_tpu_torch/ops/shading.py
// shade_train), and its gradient with respect to the base colour, the
// roughness, the shading normals, the view directions, the baked radiance
// and the env radiance.
//
// What it replaces: on the training path, rendering_equation4 and
// ggx_specular4, about a hundred PyTorch operations over [N, S, 4, 1],
// [N, S, 4, 3] and [N, S, 12] temporaries that autograd keeps (at the
// recipe's 524,288 rows and S = 64 each [N, S, 12] float32 tensor is 1.6
// GB); with their backward they took 57% of the stage-2 step on an H100.
// It replaces no TPU kernel: the JAX package leaves the shading to XLA,
// which fuses it (svgir_tpu/ops/shading.py).  rendering_equation4 stays
// for evaluation and relighting, which read its other terms, and is this
// pair's plain version: CPU tensors take it under autograd
// (ops/shading.py shade_train), and chip_smoke.py holds this pair to it
// and autograd's gradients.
//
// Inputs: base_color [N, 12] channel-major (c * 4 + v), roughness [N, 4],
// the shading normals [N, 4, 3], viewdirs [N, 3] (points -> camera),
// radiance [N, S, 3], env_radiance [N, S, 3], visibility [N, S, 1],
// incident_dirs [N, S, 3], incident_areas [N, S, 1].
//
// Forward, exactly as rendering_equation4 defines pbr and diffuse_light:
// per (row, sample) the light (radiance + clamp(env, 0, 64) * visibility)
// * area; per vertex N.L = max(n_v . dir, 0) with the raw normal; GGX with
// the normal normalized and flipped by sign(N.V), N.L, N.V, N.H and V.H
// clamped to [1e-6, 1], Fresnel 0.04 + 0.96 * 2^((-5.55473 VoH - 6.98316)
// VoH), k = (alpha + 2 r + 1) / 8, the denominator 4 pi nom0^2 nom1 nom2
// clamped to [1e-6, 4 pi]; transport = light * area * N.L; pbr = mean over
// S of (base / pi + specular) * transport, diffuse_light = mean of
// transport.  Every normalization is utils/transforms.py's clamped-rsqrt
// form v * rsqrt(max(|v|^2, 1e-24)).
//
// Backward, as autograd takes it through rendering_equation4: each clamp
// passes its gradient where its input lies inside its bounds, both ends
// inclusive (torch.clamp's backward); sign(N.V) passes none; the
// normalizations' backward is g r - v (g . v) r^3, the second term only
// where |v|^2 >= 1e-24.  Visibility, directions and areas take no
// gradient (shade_train refuses them if they ask for one).
//
// Layout: one warp a row, lane l the samples l, l + 32, ...  Every lane
// forms the row's per-vertex terms (normals, flip, N.V, alpha^2, k) from
// broadcast loads; per sample it reads 11 floats (radiance 3, env 3,
// visibility 1, direction 3, area 1), neighbouring lanes on neighbouring
// addresses, and keeps the 4 vertices x 12 channels in registers: nothing
// of [N, S, 4, .] goes to device memory.  The forward's 24 sums over S and
// the backward's 51 (12 base colour, 4 each of alpha^2, k and N.V, 12 of
// the flipped unit normals, 12 of the raw normals, 3 of the view
// direction) are reduced by svgir_transpose_sum: recursive halving, 31
// shuffles for 32 sums where a butterfly per sum takes 160, in a fixed
// tree, so the results are the same on every run and there are no
// atomics.  The backward's row-level chain rule (the clamp of N.V, the
// flip, the normalizations of the normals and the view direction, alpha
// and k) runs once a row after the sums, on lanes 0-20.  A row whose
// cotangent (d_pbr and d_diffuse_light, 24 floats) is all zero writes
// zero gradients and reads nothing else: the blend sends none to dead rows
// (opacity 0).  The backward's warps stride over the rows (at most
// kBwdBlocks blocks), so that dead rows, which lie among the alive ones in
// a compact bake, leave no warp of a block idle while the others work.
//
// Bound: bytes.  The forward reads 11S + 31 floats a row and writes 24:
// 1.54 GB at 524,288 rows and S = 64, 0.46 ms at 3.35 TB/s; about 250
// flops a (row, sample), 8.4 GFLOP (0.13 ms at 67 TFLOP/s).  The backward
// reads 24 floats a row, 11S + 31 more for a row whose cotangent is not
// zero, and writes 6S + 31 floats every row (2.4 GB at the recipe's size
// with every row alive, 0.72 ms).
//
// Summation order and tolerance: each lane sums its samples in order, then
// the halving tree sums the lanes; PyTorch sums over S in another order.
// GGX's denominator near a specular peak amplifies float32 rounding, so
// chip_smoke.py (phase 37) holds each output to rendering_equation4 and
// autograd's gradients evaluated in float64, within TOL_SHADING_RATIO
// times the same in float32's own error on the same inputs, or 1e-6 of
// the output's largest magnitude where that is larger (TOL_SHADING_FLOOR).
#include <climits>
#include <cstdint>

#include "blend_common.cuh"

namespace {

constexpr int kWarps = 4;                           // rows (warps) a block
constexpr int kThreads = kWarps * 32;
constexpr float kFourPi = 12.566370614359172f;      // 4 * math.pi, as float32
constexpr float kInvPi = 1.f / 3.14159265358979f;
constexpr float kLo = 1e-6f;                        // the clamps' lower bound
constexpr float kEnvMax = 64.f;                     // the env term's clamp
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kFresA = -5.55473f, kFresB = -6.98316f;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float dot3(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 load3(const float* __restrict__ p) { return {p[0], p[1], p[2]}; }
__device__ __forceinline__ V3 mul3(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ void axpy3(V3& y, float s, V3 a) {
  y.x += s * a.x;
  y.y += s * a.y;
  y.z += s * a.z;
}
__device__ __forceinline__ bool unit_inside(float x) { return x >= kLo && x <= 1.f; }
__device__ __forceinline__ float clamp_unit(float x) { return fminf(fmaxf(x, kLo), 1.f); }

// utils/transforms.py normalize: v * rsqrt(max(|v|^2, 1e-24))
__device__ __forceinline__ V3 normalize3(V3 v) {
  return mul3(v, rsqrtf(fmaxf(dot3(v, v), 1e-24f)));
}

// normalize's backward: g r - v (g . v) r^3, the second term only where
// the clamp of |v|^2 passes its gradient
__device__ __forceinline__ V3 normalize3_back(V3 v, V3 g) {
  const float sq = dot3(v, v);
  const float r = rsqrtf(fmaxf(sq, 1e-24f));
  const float c = sq >= 1e-24f ? dot3(g, v) * r * r * r : 0.f;
  return {g.x * r - v.x * c, g.y * r - v.y * c, g.z * r - v.z * c};
}

// One step of svgir_transpose_sum: a lane keeps slots [0, W) or [W, 2W)
// (by its bit W) in v[0, W), sends the other half to lane ^ W and adds what
// it receives.  W is a template argument so that every index is a
// constant and v stays in registers.
template <int W>
__device__ __forceinline__ void halve(float (&v)[32], int lane) {
  const bool up = (lane & W) != 0;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const float send = up ? v[j] : v[j + W];
    const float keep = up ? v[j + W] : v[j];
    v[j] = keep + __shfl_xor_sync(SVGIR_FULL_MASK, send, W);
  }
}

// Sums slot j of every lane's v into lane j (j < 32) by recursive halving,
// in five steps of a fixed tree.
__device__ __forceinline__ float svgir_transpose_sum(float (&v)[32], int lane) {
  halve<16>(v, lane);
  halve<8>(v, lane);
  halve<4>(v, lane);
  halve<2>(v, lane);
  halve<1>(v, lane);
  return v[0];
}

// One vertex's flip sg = sign(V . normalize(n)), its flipped unit normal
// nf = normalize(n) * sg and its raw N.V (before the clamp).
__device__ __forceinline__ void vertex_frame(V3 v, V3 n, V3& nf, float& sg, float& nov_raw) {
  const V3 nn = normalize3(n);
  const float d = dot3(v, nn);
  sg = (float)((d > 0.f) - (d < 0.f));
  nf = mul3(nn, sg);
  nov_raw = dot3(nf, v);
}

// The row's terms that do not depend on the sample.
struct Row {
  V3 v;                                  // normalize(viewdir)
  V3 n[4];                               // the raw normals (the transport's N.L)
  V3 nf[4];                              // the flipped unit normals (GGX)
  float nov[4], alpha2[4], k[4], nom1[4];
};

__device__ __forceinline__ void load_row(Row& q, const float* __restrict__ nrm,
                                         const float* __restrict__ vd,
                                         const float* __restrict__ rough, long long i) {
  q.v = normalize3(load3(vd + 3 * i));
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    q.n[v] = load3(nrm + 12 * i + 3 * v);
    float sg, nov_raw;
    vertex_frame(q.v, q.n[v], q.nf[v], sg, nov_raw);
    q.nov[v] = clamp_unit(nov_raw);
    const float r = rough[4 * i + v];
    const float alpha = r * r;
    q.alpha2[v] = alpha * alpha;
    q.k[v] = (alpha + 2.f * r + 1.f) * 0.125f;
    q.nom1[v] = q.nov[v] * (1.f - q.k[v]) + q.k[v];
  }
}

// One sample's terms: the direction's unit vector, the half vector before
// (u) and after its normalization, V.H, the Fresnel term and, per vertex,
// N.L of the transport and GGX's terms.
struct Tap {
  V3 l, u, h;
  float voh_raw, voh, e2, frac0;
  float ndi_raw[4], nol_raw[4], noh_raw[4], nol[4], noh[4], nom0[4], nom2[4], p[4], nom[4], fs[4];
};

__device__ __forceinline__ void eval_tap(const Row& q, V3 d, Tap& t) {
  t.l = normalize3(d);
  t.u = {(t.l.x + q.v.x) * 0.5f, (t.l.y + q.v.y) * 0.5f, (t.l.z + q.v.z) * 0.5f};
  t.h = normalize3(t.u);
  t.voh_raw = dot3(q.v, t.h);
  t.voh = clamp_unit(t.voh_raw);
  t.e2 = exp2f((kFresA * t.voh + kFresB) * t.voh);
  t.frac0 = 0.04f + 0.96f * t.e2;
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    t.ndi_raw[v] = dot3(q.n[v], d);
    t.nol_raw[v] = dot3(q.nf[v], t.l);
    t.noh_raw[v] = dot3(q.nf[v], t.h);
    t.nol[v] = clamp_unit(t.nol_raw[v]);
    t.noh[v] = clamp_unit(t.noh_raw[v]);
    t.nom0[v] = t.noh[v] * t.noh[v] * (q.alpha2[v] - 1.f) + 1.f;
    t.nom2[v] = t.nol[v] * (1.f - q.k[v]) + q.k[v];
    t.p[v] = kFourPi * t.nom0[v] * t.nom0[v] * q.nom1[v] * t.nom2[v];
    t.nom[v] = fminf(fmaxf(t.p[v], kLo), kFourPi);
    t.fs[v] = t.frac0 * q.alpha2[v] / t.nom[v];
  }
}

// (radiance + clamp(env, 0, 64) * visibility) * area, per channel
__device__ __forceinline__ void light(const float* __restrict__ rad, const float* __restrict__ env,
                                      float vz, float ar, long long o, float e[3], float a[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    e[c] = env[3 * o + c];
    a[c] = (rad[3 * o + c] + fminf(fmaxf(e[c], 0.f), kEnvMax) * vz) * ar;
  }
}

__global__ void __launch_bounds__(kThreads)
    svgir_shading_fwd_kernel(const float* __restrict__ bc, const float* __restrict__ rough,
                             const float* __restrict__ nrm, const float* __restrict__ vd,
                             const float* __restrict__ rad, const float* __restrict__ env,
                             const float* __restrict__ vis, const float* __restrict__ dirs,
                             const float* __restrict__ area, long long n, int s_num,
                             float* __restrict__ pbr, float* __restrict__ dl) {
  const long long i = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= n) return;
  Row q;
  load_row(q, nrm, vd, rough, i);
  float fd[12];
#pragma unroll
  for (int j = 0; j < 12; ++j) fd[j] = bc[12 * i + j] * kInvPi;
  float acc[32];   // 0-11 pbr, 12-23 diffuse light (c * 4 + v)
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j] = 0.f;
  for (int s = lane; s < s_num; s += 32) {
    const long long o = i * s_num + s;
    const V3 d = load3(dirs + 3 * o);
    float e[3], a[3];
    light(rad, env, vis[o], area[o], o, e, a);
    Tap t;
    eval_tap(q, d, t);
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const float ndi = fmaxf(t.ndi_raw[v], 0.f);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float tr = a[c] * ndi;
        acc[4 * c + v] += (fd[4 * c + v] + t.fs[v]) * tr;
        acc[12 + 4 * c + v] += tr;
      }
    }
  }
  const float tot = svgir_transpose_sum(acc, lane) / (float)s_num;
  if (lane < 12)
    pbr[12 * i + lane] = tot;
  else if (lane < 24)
    dl[12 * i + lane - 12] = tot;
}

// Slots of the backward's per-lane sums.  First group: the base colour's
// (through base / pi), alpha^2's, k's and the clamped N.V's, each per
// vertex, and the unit view direction's.  Second group: the flipped unit
// normals' (from N.L and N.H of GGX) and the raw normals' (from the
// transport's N.L), vertex-major.
constexpr int kBc = 0, kAlpha2 = 12, kK = 16, kNov = 20, kV = 24;
constexpr int kNf = 0, kN = 12;

// One row of the backward: its samples' gradients written, the row's
// gradients from the warp's sums.  g: lanes 0-11 d_pbr, 12-23
// d_diffuse_light of the row, not all zero.
__device__ __forceinline__ void backward_row(
    const float* __restrict__ bc, const float* __restrict__ rough, const float* __restrict__ nrm,
    const float* __restrict__ vd, const float* __restrict__ rad, const float* __restrict__ env,
    const float* __restrict__ vis, const float* __restrict__ dirs, const float* __restrict__ area,
    long long i, int s_num, int lane, float g, float* __restrict__ sh, float* __restrict__ d_bc,
    float* __restrict__ d_rough, float* __restrict__ d_nrm, float* __restrict__ d_vd,
    float* __restrict__ d_rad, float* __restrict__ d_env) {
  // the mean's cotangents: gp for pbr, and h = gp base / pi + gd, so that
  // d transport = gp (base / pi + fs_v) + gd = h + gp fs_v
  const float sf = (float)s_num;
  float gp[12], h[12];
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    gp[j] = __shfl_sync(SVGIR_FULL_MASK, g, j) / sf;
    h[j] = gp[j] * (bc[12 * i + j] * kInvPi) + __shfl_sync(SVGIR_FULL_MASK, g, 12 + j) / sf;
  }
  Row q;
  load_row(q, nrm, vd, rough, i);
  float sa[32], sb[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) sa[j] = sb[j] = 0.f;

  for (int s = lane; s < s_num; s += 32) {
    const long long o = i * s_num + s;
    const V3 d = load3(dirs + 3 * o);
    const float vz = vis[o], ar = area[o];
    float e[3], a[3];
    light(rad, env, vz, ar, o, e, a);
    Tap t;
    eval_tap(q, d, t);
    // the transport: pbr = (base / pi + fs_v) T, diffuse light = T, T =
    // a_c max(N.L, 0)
    float da[3] = {0.f, 0.f, 0.f}, gfs[4], dndi[4];
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const float ndi = fmaxf(t.ndi_raw[v], 0.f);
      gfs[v] = dndi[v] = 0.f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int j = 4 * c + v;
        const float tr = a[c] * ndi;
        const float gt = gp[j] * tr;
        sa[kBc + j] += gt;
        gfs[v] += gt;
        const float dt = h[j] + gp[j] * t.fs[v];
        da[c] += dt * ndi;
        dndi[v] += dt * a[c];
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float dil = da[c] * ar;
      d_rad[3 * o + c] = dil;
      d_env[3 * o + c] = (e[c] >= 0.f && e[c] <= kEnvMax) ? dil * vz : 0.f;
    }
    // GGX: fs = frac0 alpha2 / nom, nom = clamp(4 pi nom0^2 nom1 nom2)
    float dfrac0 = 0.f;
    V3 dh = {0.f, 0.f, 0.f};
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const float dfrac = gfs[v] / t.nom[v];
      dfrac0 += dfrac * q.alpha2[v];
      sa[kAlpha2 + v] += dfrac * t.frac0;
      if (t.p[v] >= kLo && t.p[v] <= kFourPi) {
        const float c0 = -gfs[v] * t.fs[v] / t.nom[v] * kFourPi;
        const float n00 = t.nom0[v] * t.nom0[v];
        const float dnom0 = c0 * 2.f * t.nom0[v] * q.nom1[v] * t.nom2[v];
        const float dnom1 = c0 * n00 * t.nom2[v];
        const float dnom2 = c0 * n00 * q.nom1[v];
        sa[kAlpha2 + v] += dnom0 * t.noh[v] * t.noh[v];       // nom0 = NoH^2 (alpha2 - 1) + 1
        sa[kK + v] += dnom1 * (1.f - q.nov[v]) + dnom2 * (1.f - t.nol[v]);
        sa[kNov + v] += dnom1 * (1.f - q.k[v]);               // nom1 = NoV (1 - k) + k
        if (unit_inside(t.nol_raw[v])) {
          const float dnol = dnom2 * (1.f - q.k[v]);          // nom2 = NoL (1 - k) + k
          sb[kNf + 3 * v] += dnol * t.l.x;
          sb[kNf + 3 * v + 1] += dnol * t.l.y;
          sb[kNf + 3 * v + 2] += dnol * t.l.z;
        }
        if (unit_inside(t.noh_raw[v])) {
          const float dnoh = dnom0 * 2.f * t.noh[v] * (q.alpha2[v] - 1.f);
          sb[kNf + 3 * v] += dnoh * t.h.x;
          sb[kNf + 3 * v + 1] += dnoh * t.h.y;
          sb[kNf + 3 * v + 2] += dnoh * t.h.z;
          axpy3(dh, dnoh, q.nf[v]);
        }
      }
      if (t.ndi_raw[v] >= 0.f) {   // the transport's max(N.L, 0)
        sb[kN + 3 * v] += dndi[v] * d.x;
        sb[kN + 3 * v + 1] += dndi[v] * d.y;
        sb[kN + 3 * v + 2] += dndi[v] * d.z;
      }
    }
    // frac0 = 0.04 + 0.96 * 2^((a VoH + b) VoH)
    V3 dv = {0.f, 0.f, 0.f};
    if (unit_inside(t.voh_raw)) {
      const float dvoh = dfrac0 * 0.96f * t.e2 * kLn2 * (2.f * kFresA * t.voh + kFresB);
      axpy3(dv, dvoh, t.h);
      axpy3(dh, dvoh, q.v);
    }
    // H = normalize((L + V) / 2)
    axpy3(dv, 0.5f, normalize3_back(t.u, dh));
    sa[kV] += dv.x;
    sa[kV + 1] += dv.y;
    sa[kV + 2] += dv.z;
  }

  sh[lane] = svgir_transpose_sum(sa, lane);
  sh[32 + lane] = svgir_transpose_sum(sb, lane);
  __syncwarp();
  if (lane < 12) {
    d_bc[12 * i + lane] = sh[kBc + lane] * kInvPi;
  } else if (lane < 16) {
    // alpha = r^2, alpha2 = alpha^2, k = (alpha + 2 r + 1) / 8
    const int v = lane - 12;
    const float r = rough[4 * i + v];
    const float gk = sh[kK + v];
    const float galpha = sh[kAlpha2 + v] * 2.f * (r * r) + gk * 0.125f;
    d_rough[4 * i + v] = galpha * 2.f * r + gk * 0.25f;
  } else if (lane < 20) {
    // normal v: the clamped N.V, the flip, the normalization, plus the
    // transport's raw N.L
    const int v = lane - 16;
    const V3 nv = load3(nrm + 12 * i + 3 * v);
    V3 nf;
    float sg, nov_raw;
    vertex_frame(q.v, nv, nf, sg, nov_raw);
    V3 gnf = {sh[32 + kNf + 3 * v], sh[32 + kNf + 3 * v + 1], sh[32 + kNf + 3 * v + 2]};
    if (unit_inside(nov_raw)) axpy3(gnf, sh[kNov + v], q.v);
    const V3 dn = normalize3_back(nv, mul3(gnf, sg));
    d_nrm[12 * i + 3 * v] = dn.x + sh[32 + kN + 3 * v];
    d_nrm[12 * i + 3 * v + 1] = dn.y + sh[32 + kN + 3 * v + 1];
    d_nrm[12 * i + 3 * v + 2] = dn.z + sh[32 + kN + 3 * v + 2];
  } else if (lane == 20) {
    // the view direction: V.H and H (summed over the samples), the
    // clamped N.V of each vertex, the normalization
    V3 gv = {sh[kV], sh[kV + 1], sh[kV + 2]};
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      V3 nf;
      float sg, nov_raw;
      vertex_frame(q.v, q.n[v], nf, sg, nov_raw);
      if (unit_inside(nov_raw)) axpy3(gv, sh[kNov + v], nf);
    }
    const V3 dvd = normalize3_back(load3(vd + 3 * i), gv);
    d_vd[3 * i] = dvd.x;
    d_vd[3 * i + 1] = dvd.y;
    d_vd[3 * i + 2] = dvd.z;
  }
}

// Warps stride over the rows, so that a warp done with a dead row takes the
// next one at once; each loads the next row's cotangent while it works on
// its row.
__global__ void __launch_bounds__(kThreads)
    svgir_shading_bwd_kernel(const float* __restrict__ bc, const float* __restrict__ rough,
                             const float* __restrict__ nrm, const float* __restrict__ vd,
                             const float* __restrict__ rad, const float* __restrict__ env,
                             const float* __restrict__ vis, const float* __restrict__ dirs,
                             const float* __restrict__ area, const float* __restrict__ d_pbr,
                             const float* __restrict__ d_dl, long long n, int s_num,
                             float* __restrict__ d_bc, float* __restrict__ d_rough,
                             float* __restrict__ d_nrm, float* __restrict__ d_vd,
                             float* __restrict__ d_rad, float* __restrict__ d_env) {
  __shared__ float sums[kWarps][64];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * kWarps;
  // the cotangent row: lanes 0-11 d_pbr, 12-23 d_diffuse_light
  auto cotangent = [&](long long r) {
    if (r >= n) return 0.f;
    return lane < 12 ? d_pbr[12 * r + lane] : lane < 24 ? d_dl[12 * r + lane - 12] : 0.f;
  };
  long long i = (long long)blockIdx.x * kWarps + warp;
  float g = cotangent(i);
  for (; i < n; i += stride) {
    const float g_next = cotangent(i + stride);
    if (__ballot_sync(SVGIR_FULL_MASK, g != 0.f) != 0u) {
      backward_row(bc, rough, nrm, vd, rad, env, vis, dirs, area, i, s_num, lane, g, sums[warp],
                   d_bc, d_rough, d_nrm, d_vd, d_rad, d_env);
      __syncwarp();   // the row's sums are read before the next row's land
    } else {
      const long long row = i * s_num * 3;
      for (int j = lane; j < 3 * s_num; j += 32) {
        d_rad[row + j] = 0.f;
        d_env[row + j] = 0.f;
      }
      if (lane < 12) {
        d_bc[12 * i + lane] = 0.f;
        d_nrm[12 * i + lane] = 0.f;
      }
      if (lane < 4) d_rough[4 * i + lane] = 0.f;
      if (lane < 3) d_vd[3 * i + lane] = 0.f;
    }
    g = g_next;
  }
}

long long blocks_for(long long n) { return (n + kWarps - 1) / kWarps; }

// The backward's grid: at most kBwdBlocks blocks (about 16 a streaming
// multiprocessor of an H100, which holds two at its 245 registers a
// thread), each warp striding over the rows.
constexpr long long kBwdBlocks = 2048;

}  // namespace

extern "C" int svgir_shading_forward(const float* bc, const float* rough, const float* nrm,
                                     const float* vd, const float* rad, const float* env,
                                     const float* vis, const float* dirs, const float* area,
                                     long long n, int s_num, float* pbr, float* dl,
                                     void* stream) {
  if (n < 0 || s_num < 1 || blocks_for(n) > INT_MAX) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  svgir_shading_fwd_kernel<<<(unsigned)blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      bc, rough, nrm, vd, rad, env, vis, dirs, area, n, s_num, pbr, dl);
  return (int)cudaGetLastError();
}

extern "C" int svgir_shading_backward(const float* bc, const float* rough, const float* nrm,
                                      const float* vd, const float* rad, const float* env,
                                      const float* vis, const float* dirs, const float* area,
                                      const float* d_pbr, const float* d_dl, long long n,
                                      int s_num, float* d_bc, float* d_rough, float* d_nrm,
                                      float* d_vd, float* d_rad, float* d_env, void* stream) {
  if (n < 0 || s_num < 1 || blocks_for(n) > INT_MAX) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const long long blocks = blocks_for(n) < kBwdBlocks ? blocks_for(n) : kBwdBlocks;
  svgir_shading_bwd_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      bc, rough, nrm, vd, rad, env, vis, dirs, area, d_pbr, d_dl, n, s_num, d_bc, d_rough, d_nrm,
      d_vd, d_rad, d_env);
  return (int)cudaGetLastError();
}
