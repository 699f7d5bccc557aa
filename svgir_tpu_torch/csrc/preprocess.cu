// svgir_preprocess_forward / svgir_preprocess_backward (P1): the
// rasterizer's per-Gaussian preprocess (svgir_tpu_torch/ops/preprocess.py
// preprocess) and its gradient with respect to the means, the scales, the
// quaternions and the colour source (SH coefficients or colours).
//
// What it replaces: preprocess_forward_plain, about a hundred PyTorch
// operations over [N, .] tensors (among them the per-surfel 3x3 products M
// M^T, T cov3d T^T and R W^T as batched GEMMs), and the two hundred that
// autograd runs for their backward; at the recipe's 524,288 rows they took
// 21.6 device ms of a stage-2 step on an H100, and their dispatch a large
// share of the host's.  The TPU package leaves the preprocess to XLA,
// which fuses it (svgir_tpu/ops/preprocess.py): no TPU kernel is ported
// here.  The plain version (ops/preprocess.py preprocess_forward_plain,
// autograd taking its gradient) runs on CPU tensors and is what
// chip_smoke.py holds this pair to.
//
// Inputs: means [N, 3], scales [N, 3], quats [N, 4] (w first), the colour
// source (shs [N, K, 3] with K >= (degree + 1)^2, or colors [N, 3], or
// none), world_view, full_proj [4, 4] and campos [3] (a strided view of
// the pose) read from device memory (nothing of the camera goes through
// the host).
//
// Forward: one thread a row.  It writes every field of Preprocessed: valid
// (bool), mean2d [N, 2], depth, conic [N, 3], radius (int32), rect_min,
// rect_max [N, 2] (int32), tiles_touched (int32), normal_view [N, 3], jinv
// [N, 10], lam [N, 2], rgb [N, 3], view_cos.  The integer outputs come
// from comparisons, ceil and casts of float32 values, and the blend's
// footprint test (alpha against 1/255, the transmittance against 1e-4)
// from mean2d, conic, jinv and lam: so every value they depend on is
// formed as the plain version forms it on the card (forward_row<float>),
// operation for operation and with no fused multiply-add where PyTorch
// rounds twice: __fmul_rn / __fadd_rn / __fdiv_rn everywhere in
// forward_row; the matrix products as cuBLAS's float32 GEMMs accumulate (a
// multiply, then one fused multiply-add for each further term, in the
// order of the shared dimension); a tensor divided by a Python number as
// PyTorch divides it on the card (a multiply by the number's float32
// reciprocal); a Python number divided by a tensor as a reciprocal times
// the number; the sums of 3 and 4 terms along a last dimension in the
// order of PyTorch's CUDA reduction ((a + c) + b, (a + b) + (c + d)) and a
// 3-wide norm as its fused squares ((x0^2 + x2^2) + x1^2).  rgb, which
// enters the blend's sums only, is formed in float64 and rounded once.
//
// Backward: one thread a row.  It recomputes the forward in registers in
// float64 (forward_row<double>) and applies the chain rule in float64 to
// each output that has a cotangent, rounding each gradient once: through
// the local homography's differences of rays 1/1000 of a pixel apart,
// which cancel about three digits, a float32 chain (autograd's included)
// lies about 1e-5 of a gradient's largest magnitude from the float64 one,
// and two float32 chains that round in other orders as far from each
// other.  A cotangent autograd passes as None comes as a null pointer and
// counts as zero.  It writes d_means, d_scales, d_quats and d_shs (or
// d_colors) whole: no atomics, no zero fill.  A row whose 25 cotangent
// floats are all zero reads nothing else and writes zeros.  Autograd's
// semantics at the edges: torch.where passes nothing to the branch not
// taken; a clamp passes the gradient where min <= x <= max; the guarded
// divisions (tz, p_z, prj_x0/1 and det) pass none through their guard; the
// norm clamps (1e-12, 1e-8) pass theirs where the norm reaches them; the
// rgb clamp at 0 and the SH bands above the active degree pass zero. The
// SH part runs first (d_shs and its share of d_means), so that its
// registers are free before the geometry's.
//
// Templates: the forward on the surface mode (the view_cos cull and the
// zero z scale), the grazing cull (surface and per-pixel depth) and the
// colour source (-2 none, -1 colours, 0-4 the SH degree); the backward on
// the surface mode and the colour source.  One algorithm: the wrapper
// picks the instance from what the call observes.
//
// Bound: bytes.  The forward reads 58 floats a row at SH degree 3 (means
// 3, scales 3, quats 4, shs 48) and writes 31 values (28 floats, 3 int32
// and the bool counted as one): 187 MB at 524,288 rows, 0.056 ms at 3.35
// TB/s.  The backward reads the 25 cotangent floats, the 58 inputs again
// where they are not all zero, and writes 58 gradient floats: at most 296
// MB, 0.088 ms.  About 600 float32 operations a row forward and 1,500
// float64 ones backward (0.05 ms at the H100's 34 TFLOP/s in float64).
#include <climits>
#include <cmath>
#include <cstdint>

// The numbers of the call (set by kernels/preprocess.py; outside the
// anonymous namespace, since the C entry points take it): the real ones as
// the Python numbers they are, which the forward rounds to float32 where
// the plain version's float32 tensors meet them.
struct PrepParams {
  int width, height, tile, grid_x, grid_y;
  int sh_k;            // coefficients a row of shs holds
  int active;          // the last SH band that passes (-1: none)
  int sh_vec;          // 1 where a row of shs is read and written as float4
  int cp_stride;       // campos's stride (a column of the camera's pose)
  double fx, fy;       // focal lengths
  double lim_x, lim_y; // 1.3 tan(fov / 2)
  double x_lo, x_hi, y_lo, y_hi;  // the frustum's bounds on mean2d
  double scale_back;   // (fx + fy) / 2 / 1000
  double scale_mod;    // scale_modifier
};

namespace {

constexpr int kThreads = 128;
constexpr int kNone = -2;     // the colour source: none (rgb 0)
constexpr int kColors = -1;   //                    colors [N, 3]

// ---- arithmetic: float32 as the plain version rounds it; float64 plain -------

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float fma_(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ float rcp(float a) { return __frcp_rn(a); }
__device__ __forceinline__ float sqrt_(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ float rsqrt_(float a) { return rsqrtf(a); }
__device__ __forceinline__ double mul(double a, double b) { return a * b; }
__device__ __forceinline__ double add(double a, double b) { return a + b; }
__device__ __forceinline__ double sub(double a, double b) { return a - b; }
__device__ __forceinline__ double dvd(double a, double b) { return a / b; }
__device__ __forceinline__ double fma_(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ double rcp(double a) { return 1.0 / a; }
__device__ __forceinline__ double sqrt_(double a) { return sqrt(a); }
__device__ __forceinline__ double rsqrt_(double a) { return 1.0 / sqrt(a); }
// torch.clamp: NaN passes
template <class T>
__device__ __forceinline__ T clamp_lo(T x, T lo) {
  return x < lo ? lo : x;
}
template <class T>
__device__ __forceinline__ T clamp2(T x, T lo, T hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
// a GEMM's dot product over 3 and over 4 terms (the 4th term's factor 1)
template <class T>
__device__ __forceinline__ T gemm3(T a0, T b0, T a1, T b1, T a2, T b2) {
  return fma_(a2, b2, fma_(a1, b1, mul(a0, b0)));
}
template <class T>
__device__ __forceinline__ T gemm4(const T m[3], const float* row) {
  return add(gemm3(m[0], T(row[0]), m[1], T(row[1]), m[2], T(row[2])), T(row[3]));
}
// (a * b).sum(-1) over 3: products rounded, then (p0 + p2) + p1
template <class T>
__device__ __forceinline__ T sum3(const T a[3], const T b[3]) {
  return add(add(mul(a[0], b[0]), mul(a[2], b[2])), mul(a[1], b[1]));
}
// int32(clamp(v / tile, -2^30, 2^30)) clamped to [0, grid]
__device__ __forceinline__ int tile_coord(float v, float inv_tile, int grid) {
  const int q = (int)clamp2(mul(v, inv_tile), -1073741824.f, 1073741824.f);
  return q < 0 ? 0 : (q > grid ? grid : q);
}

// The camera: world_view rows 0-2, full_proj rows 0, 1 and 3, campos.
struct Cam {
  float wv[12], fp[12], cp[3];
};

__device__ __forceinline__ void load_cam(Cam& c, const float* __restrict__ wv,
                                         const float* __restrict__ fp,
                                         const float* __restrict__ cp, int cp_stride) {
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    c.wv[j] = __ldg(wv + j);
    c.fp[j] = __ldg(fp + (j < 8 ? j : j + 4));
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) c.cp[j] = __ldg(cp + j * cp_stride);
}

// world_view's rotation W[a][b]
__device__ __forceinline__ float W(const Cam& c, int a, int b) { return c.wv[4 * a + b]; }

// Every value of one row's forward that an output or the backward reads, in
// T (float32 in the forward, float64 in the backward).
template <class T>
struct Fwd {
  T m[3], q[4];
  T ph0, ph1, pw, px, py;       // p_hom[0:2], p_w, mean2d
  T pv[3];                      // p_view
  T sq, rinv, qn[4];            // |q|^2, its clamped rsqrt, the unit quaternion
  T R[3][3];
  T ax0[3], ax1[3], nv[3];      // R's columns in view space
  T vc;                         // view_cos
  // local homography
  T pz, d0[3], d1[3], nrm0, nrm1, mod0, mod1, dir0[3], dir1[3];
  T prj0, prj1, p0s, p1s, a0, a1, xu0[3], xu1[3], j[4];
  bool grazing;
  // EWA covariance
  T s[3], M[3][3];
  T tzs, ux, uy, cx, cy, tz2, rec, J00, J02, J11, J12, T_[2][3];
  T c0, c1, c2, det, dets;
};

template <class T, bool kSurface>
__device__ __forceinline__ void forward_row(Fwd<T>& f, const Cam& c, const PrepParams& p,
                                            const float* __restrict__ means,
                                            const float* __restrict__ scales,
                                            const float* __restrict__ quats, long long i) {
#pragma unroll
  for (int k = 0; k < 3; ++k) f.m[k] = T(__ldg(means + 3 * i + k));
#pragma unroll
  for (int k = 0; k < 4; ++k) f.q[k] = T(__ldg(quats + 4 * i + k));
  const T one = T(1), two = T(2), half = T(0.5);

  // projection: p_hom = [m, 1] full_proj^T, p_w = 1 / (p_hom[3] + 1e-7)
  f.ph0 = gemm4(f.m, c.fp);
  f.ph1 = gemm4(f.m, c.fp + 4);
  f.pw = rcp(add(gemm4(f.m, c.fp + 8), T(1e-7)));
  f.px = mul(sub(mul(add(mul(f.ph0, f.pw), one), T(p.width)), one), half);
  f.py = mul(sub(mul(add(mul(f.ph1, f.pw), one), T(p.height)), one), half);
#pragma unroll
  for (int k = 0; k < 3; ++k) f.pv[k] = gemm4(f.m, c.wv + 4 * k);

  // utils/transforms.py quat_to_rotmat on normalize(q)
  const T q2[4] = {mul(f.q[0], f.q[0]), mul(f.q[1], f.q[1]), mul(f.q[2], f.q[2]),
                   mul(f.q[3], f.q[3])};
  f.sq = add(add(q2[0], q2[1]), add(q2[2], q2[3]));
  f.rinv = rsqrt_(clamp_lo(f.sq, T(1e-24)));
#pragma unroll
  for (int k = 0; k < 4; ++k) f.qn[k] = mul(f.q[k], f.rinv);
  const T r = f.qn[0], x = f.qn[1], y = f.qn[2], z = f.qn[3];
  f.R[0][0] = sub(one, mul(two, add(mul(y, y), mul(z, z))));
  f.R[0][1] = mul(two, sub(mul(x, y), mul(r, z)));
  f.R[0][2] = mul(two, add(mul(x, z), mul(r, y)));
  f.R[1][0] = mul(two, add(mul(x, y), mul(r, z)));
  f.R[1][1] = sub(one, mul(two, add(mul(x, x), mul(z, z))));
  f.R[1][2] = mul(two, sub(mul(y, z), mul(r, x)));
  f.R[2][0] = mul(two, sub(mul(x, z), mul(r, y)));
  f.R[2][1] = mul(two, add(mul(y, z), mul(r, x)));
  f.R[2][2] = sub(one, mul(two, add(mul(x, x), mul(y, y))));

  // R[:, col] @ W^T
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const T w0 = T(W(c, k, 0)), w1 = T(W(c, k, 1)), w2 = T(W(c, k, 2));
    f.ax0[k] = gemm3(f.R[0][0], w0, f.R[1][0], w1, f.R[2][0], w2);
    f.ax1[k] = gemm3(f.R[0][1], w0, f.R[1][1], w1, f.R[2][1], w2);
    f.nv[k] = gemm3(f.R[0][2], w0, f.R[1][2], w1, f.R[2][2], w2);
  }
  f.vc = sum3(f.pv, f.nv);

  // local homography (ops/preprocess.py _local_homo)
  f.pz = f.pv[2] == T(0) ? T(1e-6) : f.pv[2];
  const T prx = dvd(f.pv[0], f.pz), pry = dvd(f.pv[1], f.pz);
  f.d0[0] = add(prx, T(0.001));
  f.d0[1] = pry;
  f.d0[2] = one;
  f.d1[0] = prx;
  f.d1[1] = add(pry, T(0.001));
  f.d1[2] = one;
  f.nrm0 = sqrt_(add(add(mul(f.d0[0], f.d0[0]), one), mul(f.d0[1], f.d0[1])));
  f.nrm1 = sqrt_(add(add(mul(f.d1[0], f.d1[0]), one), mul(f.d1[1], f.d1[1])));
  f.mod0 = clamp_lo(f.nrm0, T(1e-8));
  f.mod1 = clamp_lo(f.nrm1, T(1e-8));
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    f.dir0[k] = dvd(f.d0[k], f.mod0);
    f.dir1[k] = dvd(f.d1[k], f.mod1);
  }
  f.prj0 = sum3(f.dir0, f.nv);
  f.prj1 = sum3(f.dir1, f.nv);
  f.grazing = fabs(dvd(f.prj0, f.mod0)) < T(0.01) || fabs(dvd(f.prj1, f.mod1)) < T(0.01);
  f.p0s = f.prj0 == T(0) ? T(1e-8) : f.prj0;
  f.p1s = f.prj1 == T(0) ? T(1e-8) : f.prj1;
  f.a0 = dvd(f.vc, f.p0s);
  f.a1 = dvd(f.vc, f.p1s);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    f.xu0[k] = sub(mul(f.dir0[k], f.a0), f.pv[k]);
    f.xu1[k] = sub(mul(f.dir1[k], f.a1), f.pv[k]);
  }
  // a tensor over a Python number: a multiply by the number's reciprocal
  const T inv_sb = rcp(T(p.scale_back));
  f.j[0] = mul(sum3(f.xu0, f.ax0), inv_sb);
  f.j[1] = mul(sum3(f.xu1, f.ax0), inv_sb);
  f.j[2] = mul(sum3(f.xu0, f.ax1), inv_sb);
  f.j[3] = mul(sum3(f.xu1, f.ax1), inv_sb);

  // covariance: M = R diag(s), cov3d = M M^T
#pragma unroll
  for (int k = 0; k < 3; ++k) f.s[k] = mul(T(__ldg(scales + 3 * i + k)), T(p.scale_mod));
  if (kSurface) f.s[2] = T(0);
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) f.M[a][b] = mul(f.R[a][b], f.s[b]);
  T C[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b)
      C[a][b] = gemm3(f.M[a][0], f.M[b][0], f.M[a][1], f.M[b][1], f.M[a][2], f.M[b][2]);

  // EWA (ops/preprocess.py _ewa_cov2d): J, T = J W, cov = T cov3d T^T
  const T tz = f.pv[2], fx = T(p.fx), fy = T(p.fy);
  f.tzs = tz == T(0) ? T(1e-6) : tz;
  f.ux = dvd(f.pv[0], f.tzs);
  f.uy = dvd(f.pv[1], f.tzs);
  f.cx = clamp2(f.ux, -T(p.lim_x), T(p.lim_x));
  f.cy = clamp2(f.uy, -T(p.lim_y), T(p.lim_y));
  f.tz2 = mul(f.tzs, f.tzs);
  f.rec = rcp(f.tzs);
  f.J00 = mul(f.rec, fx);
  f.J11 = mul(f.rec, fy);
  f.J02 = dvd(mul(mul(f.cx, tz), -fx), f.tz2);
  f.J12 = dvd(mul(mul(f.cy, tz), -fy), f.tz2);
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    f.T_[0][b] = fma_(f.J02, T(W(c, 2, b)), mul(f.J00, T(W(c, 0, b))));
    f.T_[1][b] = fma_(f.J12, T(W(c, 2, b)), mul(f.J11, T(W(c, 1, b))));
  }
  T A[2][3];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b)
      A[a][b] = gemm3(f.T_[a][0], C[0][b], f.T_[a][1], C[1][b], f.T_[a][2], C[2][b]);
  const T lowpass = T(0.3);
  f.c0 = add(gemm3(A[0][0], f.T_[0][0], A[0][1], f.T_[0][1], A[0][2], f.T_[0][2]), lowpass);
  f.c1 = gemm3(A[0][0], f.T_[1][0], A[0][1], f.T_[1][1], A[0][2], f.T_[1][2]);
  f.c2 = add(gemm3(A[1][0], f.T_[1][0], A[1][1], f.T_[1][1], A[1][2], f.T_[1][2]), lowpass);
  f.det = sub(mul(f.c0, f.c2), mul(f.c1, f.c1));
  f.dets = f.det == T(0) ? one : f.det;
}

// ---- SH (utils/sh.py eval_sh_basis; sh_to_rgb_clamped) -----------------------

// utils/sh.py's constants (arrays as macros: a namespace-scope constexpr
// array is host data to nvcc, a local one is a device constant)
constexpr double kC0 = 0.28209479177387814;
constexpr double kC1 = 0.4886025119029199;
#define SVGIR_SH_C2                                                        \
  {1.0925484305920792, -1.0925484305920792, 0.31539156525252005,          \
   -1.0925484305920792, 0.5462742152960396}
#define SVGIR_SH_C3                                                        \
  {-0.5900435899266435, 2.890611442640554, -0.4570457994644658,           \
   0.3731763325901154, -0.4570457994644658, 1.445305721320277,            \
   -0.5900435899266435}
#define SVGIR_SH_C4                                                        \
  {2.5033429417967046, -1.7701307697799304, 0.9461746957575601,           \
   -0.6690465435572892, 0.10578554691520431, -0.6690465435572892,         \
   0.47308734787878004, -1.7701307697799304, 0.6258357354491761}

template <class T, int kDeg>
__device__ __forceinline__ void sh_basis(T x, T y, T z, T* b) {
  constexpr double kC2[5] = SVGIR_SH_C2, kC3[7] = SVGIR_SH_C3, kC4[9] = SVGIR_SH_C4;
  b[0] = T(kC0);
  if (kDeg > 0) {
    b[1] = T(-kC1) * y;
    b[2] = T(kC1) * z;
    b[3] = T(-kC1) * x;
  }
  if (kDeg > 1) {
    const T xx = x * x, yy = y * y, zz = z * z;
    b[4] = T(kC2[0]) * x * y;
    b[5] = T(kC2[1]) * y * z;
    b[6] = T(kC2[2]) * (T(2) * zz - xx - yy);
    b[7] = T(kC2[3]) * x * z;
    b[8] = T(kC2[4]) * (xx - yy);
    if (kDeg > 2) {
      b[9] = T(kC3[0]) * y * (T(3) * xx - yy);
      b[10] = T(kC3[1]) * x * y * z;
      b[11] = T(kC3[2]) * y * (T(4) * zz - xx - yy);
      b[12] = T(kC3[3]) * z * (T(2) * zz - T(3) * xx - T(3) * yy);
      b[13] = T(kC3[4]) * x * (T(4) * zz - xx - yy);
      b[14] = T(kC3[5]) * z * (xx - yy);
      b[15] = T(kC3[6]) * x * (xx - T(3) * yy);
    }
    if (kDeg > 3) {
      b[16] = T(kC4[0]) * x * y * (xx - yy);
      b[17] = T(kC4[1]) * y * z * (T(3) * xx - yy);
      b[18] = T(kC4[2]) * x * y * (T(7) * zz - T(1));
      b[19] = T(kC4[3]) * y * z * (T(7) * zz - T(3));
      b[20] = T(kC4[4]) * (zz * (T(35) * zz - T(30)) + T(3));
      b[21] = T(kC4[5]) * x * z * (T(7) * zz - T(3));
      b[22] = T(kC4[6]) * (xx - yy) * (T(7) * zz - T(1));
      b[23] = T(kC4[7]) * x * z * (xx - T(3) * yy);
      b[24] = T(kC4[8]) * (xx * (xx - T(3) * yy) - yy * (T(3) * xx - yy));
    }
  }
}

// The gradient at (x, y, z) of sum_k g_k b_k (the derivative of
// utils/sh.py eval_sh_basis), in float64.
template <int kDeg>
__device__ __forceinline__ void sh_basis_back(double x, double y, double z, const double* g,
                                              double d[3]) {
  constexpr double kC2[5] = SVGIR_SH_C2, kC3[7] = SVGIR_SH_C3, kC4[9] = SVGIR_SH_C4;
  double gx = 0, gy = 0, gz = 0;
  if (kDeg > 0) {
    gy -= kC1 * g[1];
    gz += kC1 * g[2];
    gx -= kC1 * g[3];
  }
  if (kDeg > 1) {
    const double xx = x * x, yy = y * y, zz = z * z;
    gx += kC2[0] * y * g[4] + kC2[3] * z * g[7] + 2 * x * (kC2[4] * g[8] - kC2[2] * g[6]);
    gy += kC2[0] * x * g[4] + kC2[1] * z * g[5] - 2 * y * (kC2[2] * g[6] + kC2[4] * g[8]);
    gz += kC2[1] * y * g[5] + 4 * kC2[2] * z * g[6] + kC2[3] * x * g[7];
    if (kDeg > 2) {
      gx += kC3[0] * 6 * x * y * g[9] + kC3[1] * y * z * g[10] - kC3[2] * 2 * x * y * g[11] -
            kC3[3] * 6 * x * z * g[12] + kC3[4] * (4 * zz - 3 * xx - yy) * g[13] +
            kC3[5] * 2 * x * z * g[14] + kC3[6] * 3 * (xx - yy) * g[15];
      gy += kC3[0] * 3 * (xx - yy) * g[9] + kC3[1] * x * z * g[10] +
            kC3[2] * (4 * zz - xx - 3 * yy) * g[11] - kC3[3] * 6 * y * z * g[12] -
            kC3[4] * 2 * x * y * g[13] - kC3[5] * 2 * y * z * g[14] -
            kC3[6] * 6 * x * y * g[15];
      gz += kC3[1] * x * y * g[10] + kC3[2] * 8 * y * z * g[11] +
            kC3[3] * (6 * zz - 3 * xx - 3 * yy) * g[12] + kC3[4] * 8 * x * z * g[13] +
            kC3[5] * (xx - yy) * g[14];
    }
    if (kDeg > 3) {
      const double z7a = 7 * zz - 1, z7b = 7 * zz - 3;
      gx += kC4[0] * y * (3 * xx - yy) * g[16] + kC4[1] * 6 * x * y * z * g[17] +
            kC4[2] * y * z7a * g[18] + kC4[5] * z * z7b * g[21] + kC4[6] * 2 * x * z7a * g[22] +
            kC4[7] * 3 * z * (xx - yy) * g[23] + kC4[8] * 4 * x * (xx - 3 * yy) * g[24];
      gy += kC4[0] * x * (xx - 3 * yy) * g[16] + kC4[1] * 3 * z * (xx - yy) * g[17] +
            kC4[2] * x * z7a * g[18] + kC4[3] * z * z7b * g[19] - kC4[6] * 2 * y * z7a * g[22] -
            kC4[7] * 6 * x * y * z * g[23] + kC4[8] * 4 * y * (yy - 3 * xx) * g[24];
      gz += kC4[1] * y * (3 * xx - yy) * g[17] + kC4[2] * 14 * x * y * z * g[18] +
            kC4[3] * y * (21 * zz - 3) * g[19] + kC4[4] * z * (140 * zz - 60) * g[20] +
            kC4[5] * x * (21 * zz - 3) * g[21] + kC4[6] * 14 * z * (xx - yy) * g[22] +
            kC4[7] * x * (xx - 3 * yy) * g[23];
    }
  }
  d[0] = gx;
  d[1] = gy;
  d[2] = gz;
}

// A row of shs as floats: the first kCount floats read in 16-byte loads
// where the row allows them (kRead floats), else one by one.
template <int kCount>
struct ShRow {
  static constexpr int kRead = (kCount + 3) / 4 * 4;
  float v[kRead];
};

template <int kCount>
__device__ __forceinline__ void load_sh(ShRow<kCount>& r, const float* __restrict__ row,
                                        bool vec) {
  if (vec) {
#pragma unroll
    for (int j = 0; j < ShRow<kCount>::kRead / 4; ++j) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(row) + j);
      r.v[4 * j] = t.x;
      r.v[4 * j + 1] = t.y;
      r.v[4 * j + 2] = t.z;
      r.v[4 * j + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kCount; ++j) r.v[j] = __ldg(row + j);
  }
}

// the band (degree) of SH coefficient k
__device__ __forceinline__ constexpr int sh_band(int k) {
  return k < 1 ? 0 : k < 4 ? 1 : k < 9 ? 2 : k < 16 ? 3 : 4;
}

// The SH direction (means - campos) / max(|.|, 1e-12) with its norm, and
// the basis masked above the active band, in T.
template <class T, int kDeg>
struct ShDir {
  T raw[3], nrm, nc, d[3];
  T b[(kDeg + 1) * (kDeg + 1)];
};

template <class T, int kDeg>
__device__ __forceinline__ void sh_dir(ShDir<T, kDeg>& s, const float* __restrict__ m,
                                       const Cam& c, int active) {
#pragma unroll
  for (int k = 0; k < 3; ++k) s.raw[k] = T(__ldg(m + k)) - T(c.cp[k]);
  s.nrm = sqrt_(s.raw[0] * s.raw[0] + s.raw[1] * s.raw[1] + s.raw[2] * s.raw[2]);
  s.nc = clamp_lo(s.nrm, T(1e-12));
#pragma unroll
  for (int k = 0; k < 3; ++k) s.d[k] = s.raw[k] / s.nc;
  sh_basis<T, kDeg>(s.d[0], s.d[1], s.d[2], s.b);
#pragma unroll
  for (int k = 0; k < (kDeg + 1) * (kDeg + 1); ++k)
    if (sh_band(k) > active) s.b[k] = T(0);
}

// sum_k sh[k][c] basis_k + 0.5, before the clamp at 0
template <class T, int kDeg>
__device__ __forceinline__ void sh_value(const ShDir<T, kDeg>& s,
                                         const ShRow<3 * (kDeg + 1) * (kDeg + 1)>& r, T v[3]) {
  v[0] = v[1] = v[2] = T(0);
#pragma unroll
  for (int j = 0; j < 3 * (kDeg + 1) * (kDeg + 1); ++j) v[j % 3] += T(r.v[j]) * s.b[j / 3];
#pragma unroll
  for (int k = 0; k < 3; ++k) v[k] += T(0.5);
}

// ---- the forward ---------------------------------------------------------------

template <bool kSurface, bool kGrazing, int kColor>
__global__ void __launch_bounds__(kThreads)
    svgir_preprocess_fwd_kernel(const float* __restrict__ means, const float* __restrict__ scales,
                                const float* __restrict__ quats, const float* __restrict__ src,
                                const float* __restrict__ wv, const float* __restrict__ fp,
                                const float* __restrict__ cp, long long n, PrepParams p,
                                bool* __restrict__ valid_out, float* __restrict__ mean2d,
                                float* __restrict__ depth, float* __restrict__ conic,
                                int* __restrict__ radius_out, int* __restrict__ rect_min,
                                int* __restrict__ rect_max, int* __restrict__ tiles,
                                float* __restrict__ normal_view, float* __restrict__ jinv,
                                float* __restrict__ lam, float* __restrict__ rgb,
                                float* __restrict__ view_cos) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  Cam c;
  load_cam(c, wv, fp, cp, p.cp_stride);
  Fwd<float> f;
  forward_row<float, kSurface>(f, c, p, means, scales, quats, i);

  // the culls (a Python number against a float32 tensor: as float32)
  bool valid = f.pv[2] >= 0.f && f.px >= (float)p.x_lo && f.px < (float)p.x_hi &&
               f.py >= (float)p.y_lo && f.py < (float)p.y_hi;
  if (kSurface) valid = valid && f.vc <= -0.01f;
  if (kGrazing) valid = valid && !f.grazing;
  valid = valid && f.det != 0.f;

  // radius = ceil(3 sqrt(max(lambda1, 0))) and the tile rect
  const float mid = mul(0.5f, add(f.c0, f.c2));
  const float disc = __fsqrt_rn(clamp_lo(sub(mul(mid, mid), f.det), 0.1f));
  const float radius = ceilf(mul(3.f, __fsqrt_rn(clamp_lo(add(mid, disc), 0.f))));
  const float inv_tile = __frcp_rn((float)p.tile);
  const float tile_f = (float)p.tile;
  const int rx0 = tile_coord(sub(f.px, radius), inv_tile, p.grid_x);
  const int ry0 = tile_coord(sub(f.py, radius), inv_tile, p.grid_y);
  const int rx1 = tile_coord(sub(add(add(f.px, radius), tile_f), 1.f), inv_tile, p.grid_x);
  const int ry1 = tile_coord(sub(add(add(f.py, radius), tile_f), 1.f), inv_tile, p.grid_y);
  const int touched = (rx1 - rx0) * (ry1 - ry0);
  valid = valid && touched > 0;

  valid_out[i] = valid;
  mean2d[2 * i] = f.px;
  mean2d[2 * i + 1] = f.py;
  depth[i] = f.pv[2];
  conic[3 * i] = dvd(f.c2, f.dets);
  conic[3 * i + 1] = dvd(-f.c1, f.dets);
  conic[3 * i + 2] = dvd(f.c0, f.dets);
  radius_out[i] = valid ? (int)radius : 0;
  rect_min[2 * i] = rx0;
  rect_min[2 * i + 1] = ry0;
  rect_max[2 * i] = rx1;
  rect_max[2 * i + 1] = ry1;
  tiles[i] = valid ? touched : 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    normal_view[3 * i + k] = f.nv[k];
    jinv[10 * i + 4 + k] = f.ax0[k];
    jinv[10 * i + 7 + k] = f.ax1[k];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) jinv[10 * i + k] = f.j[k];
  lam[2 * i] = f.s[0];
  lam[2 * i + 1] = f.s[1];
  view_cos[i] = f.vc;

  // rgb enters the blend's sums only: formed in float64, rounded once
  if constexpr (kColor == kNone) {
#pragma unroll
    for (int k = 0; k < 3; ++k) rgb[3 * i + k] = 0.f;
  } else if constexpr (kColor == kColors) {
#pragma unroll
    for (int k = 0; k < 3; ++k) rgb[3 * i + k] = __ldg(src + 3 * i + k);
  } else {
    ShDir<double, kColor> s;
    sh_dir<double, kColor>(s, means + 3 * i, c, p.active);
    ShRow<3 * (kColor + 1) * (kColor + 1)> r;
    load_sh(r, src + i * 3 * (long long)p.sh_k, p.sh_vec != 0);
    double v[3];
    sh_value<double, kColor>(s, r, v);
#pragma unroll
    for (int k = 0; k < 3; ++k) rgb[3 * i + k] = v[k] < 0.0 ? 0.f : float(v[k]);
  }
}

// ---- the backward (float64) --------------------------------------------------------

// The cotangents of one row, zero where autograd passed none.
struct Cot {
  float m2d[2], depth, conic[3], nv[3], jinv[10], lam[2], rgb[3], vc;
};

__device__ __forceinline__ void load_cot(Cot& g, long long i, const float* __restrict__ g_m2d,
                                         const float* __restrict__ g_depth,
                                         const float* __restrict__ g_conic,
                                         const float* __restrict__ g_nv,
                                         const float* __restrict__ g_jinv,
                                         const float* __restrict__ g_lam,
                                         const float* __restrict__ g_rgb,
                                         const float* __restrict__ g_vc) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    g.m2d[k] = g_m2d ? __ldg(g_m2d + 2 * i + k) : 0.f;
    g.lam[k] = g_lam ? __ldg(g_lam + 2 * i + k) : 0.f;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g.conic[k] = g_conic ? __ldg(g_conic + 3 * i + k) : 0.f;
    g.nv[k] = g_nv ? __ldg(g_nv + 3 * i + k) : 0.f;
    g.rgb[k] = g_rgb ? __ldg(g_rgb + 3 * i + k) : 0.f;
  }
#pragma unroll
  for (int k = 0; k < 10; ++k) g.jinv[k] = g_jinv ? __ldg(g_jinv + 10 * i + k) : 0.f;
  g.depth = g_depth ? __ldg(g_depth + i) : 0.f;
  g.vc = g_vc ? __ldg(g_vc + i) : 0.f;
}

__device__ __forceinline__ bool any_cot(const Cot& g) {
  bool any = g.depth != 0.f || g.vc != 0.f;
#pragma unroll
  for (int k = 0; k < 2; ++k) any = any || g.m2d[k] != 0.f || g.lam[k] != 0.f;
#pragma unroll
  for (int k = 0; k < 3; ++k) any = any || g.conic[k] != 0.f || g.nv[k] != 0.f || g.rgb[k] != 0.f;
#pragma unroll
  for (int k = 0; k < 10; ++k) any = any || g.jinv[k] != 0.f;
  return any;
}

// zeros over a row of d_shs (count floats)
__device__ __forceinline__ void zero_sh_row(float* __restrict__ row, int count, bool vec) {
  if (vec) {
    for (int j = 0; j < count / 4; ++j)
      reinterpret_cast<float4*>(row)[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    for (int j = 0; j < count; ++j) row[j] = 0.f;
  }
}

// The SH part: writes d_shs' row whole (zeros past the degree's
// coefficients), adds its share of d_means to dm.
template <int kDeg>
__device__ __forceinline__ void sh_backward(const float* __restrict__ m, const Cam& c,
                                            const PrepParams& p, const float* __restrict__ sh_row,
                                            float* __restrict__ d_sh_row, const float g_rgb[3],
                                            double dm[3]) {
  constexpr int kK = (kDeg + 1) * (kDeg + 1);
  constexpr int kCount = 3 * kK;
  constexpr int kRead = ShRow<kCount>::kRead;
  const bool vec = p.sh_vec != 0;
  ShDir<double, kDeg> s;
  sh_dir<double, kDeg>(s, m, c, p.active);
  ShRow<kCount> r;
  load_sh(r, sh_row, vec);
  double gv[3];
  {
    double v[3];
    sh_value<double, kDeg>(s, r, v);
#pragma unroll
    for (int k = 0; k < 3; ++k) gv[k] = v[k] >= 0.0 ? double(g_rgb[k]) : 0.0;
  }
  // d_shs = gv_c basis_k; d_basis_k = sum_c gv_c sh[k][c] (masked bands: 0)
  double db[kK];
#pragma unroll
  for (int k = 0; k < kK; ++k) db[k] = 0.0;
  float out[kRead];
#pragma unroll
  for (int j = 0; j < kRead; ++j) {
    if (j < kCount) {
      db[j / 3] += gv[j % 3] * double(r.v[j]);
      out[j] = float(gv[j % 3] * s.b[j / 3]);
    } else {
      out[j] = 0.f;
    }
  }
#pragma unroll
  for (int k = 0; k < kK; ++k)
    if (sh_band(k) > p.active) db[k] = 0.0;
  if (vec) {
#pragma unroll
    for (int j = 0; j < kRead / 4; ++j)
      reinterpret_cast<float4*>(d_sh_row)[j] =
          make_float4(out[4 * j], out[4 * j + 1], out[4 * j + 2], out[4 * j + 3]);
    zero_sh_row(d_sh_row + kRead, 3 * p.sh_k - kRead, true);
  } else {
#pragma unroll
    for (int j = 0; j < kCount; ++j) d_sh_row[j] = out[j];
    zero_sh_row(d_sh_row + kCount, 3 * p.sh_k - kCount, false);
  }
  double dd[3];
  sh_basis_back<kDeg>(s.d[0], s.d[1], s.d[2], db, dd);
  // d / max(|d|, 1e-12): the clamp passes where |d| >= 1e-12
  const double dnc = -(dd[0] * s.raw[0] + dd[1] * s.raw[1] + dd[2] * s.raw[2]) / (s.nc * s.nc);
  const double dn = s.nrm >= 1e-12 ? dnc / s.nrm : 0.0;
#pragma unroll
  for (int k = 0; k < 3; ++k) dm[k] += dd[k] / s.nc + dn * s.raw[k];
}

__device__ __forceinline__ double dot3(const double a[3], const double b[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// dir = d / mod, mod = max(|d|, 1e-8): the gradient with respect to d
__device__ __forceinline__ void unit_back(const double d[3], const double dd[3], double nrm,
                                          double mod, double out[3]) {
  const double dmod = nrm >= 1e-8 ? -dot3(dd, d) / (mod * mod) / nrm : 0.0;
#pragma unroll
  for (int k = 0; k < 3; ++k) out[k] = dd[k] / mod + dmod * d[k];
}

template <bool kSurface, int kColor>
__global__ void __launch_bounds__(kThreads)
    svgir_preprocess_bwd_kernel(const float* __restrict__ means, const float* __restrict__ scales,
                                const float* __restrict__ quats, const float* __restrict__ src,
                                const float* __restrict__ wv, const float* __restrict__ fp,
                                const float* __restrict__ cp, long long n, PrepParams p,
                                const float* __restrict__ g_m2d, const float* __restrict__ g_depth,
                                const float* __restrict__ g_conic, const float* __restrict__ g_nv,
                                const float* __restrict__ g_jinv, const float* __restrict__ g_lam,
                                const float* __restrict__ g_rgb, const float* __restrict__ g_vc,
                                float* __restrict__ d_means, float* __restrict__ d_scales,
                                float* __restrict__ d_quats, float* __restrict__ d_src) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  Cot g;
  load_cot(g, i, g_m2d, g_depth, g_conic, g_nv, g_jinv, g_lam, g_rgb, g_vc);
  const long long sh_at = i * 3 * (long long)p.sh_k;
  if (!any_cot(g)) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      d_means[3 * i + k] = 0.f;
      d_scales[3 * i + k] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) d_quats[4 * i + k] = 0.f;
    if constexpr (kColor == kColors) {
#pragma unroll
      for (int k = 0; k < 3; ++k) d_src[3 * i + k] = 0.f;
    } else if constexpr (kColor >= 0) {
      zero_sh_row(d_src + sh_at, 3 * p.sh_k, p.sh_vec != 0);
    }
    return;
  }
  Cam c;
  load_cam(c, wv, fp, cp, p.cp_stride);
  double dm[3] = {0.0, 0.0, 0.0};
  if constexpr (kColor == kColors) {
#pragma unroll
    for (int k = 0; k < 3; ++k) d_src[3 * i + k] = g.rgb[k];
  } else if constexpr (kColor >= 0) {
    sh_backward<kColor>(means + 3 * i, c, p, src + sh_at, d_src + sh_at, g.rgb, dm);
  }

  Fwd<double> f;
  forward_row<double, kSurface>(f, c, p, means, scales, quats, i);
  const double fx = p.fx, fy = p.fy;
  double dpv[3] = {0.0, 0.0, double(g.depth)};
  double dnv[3], dax0[3], dax1[3];
  double ds[3] = {g.lam[0], g.lam[1], 0.0};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    dnv[k] = double(g.nv[k]) + double(g.vc) * f.pv[k];
    dpv[k] += double(g.vc) * f.nv[k];
    dax0[k] = g.jinv[4 + k];
    dax1[k] = g.jinv[7 + k];
  }

  // mean2d = ((p_hom[:2] p_w + 1) size - 1) / 2
  {
    const double dpp0 = double(g.m2d[0]) * 0.5 * p.width;
    const double dpp1 = double(g.m2d[1]) * 0.5 * p.height;
    const double dpw = dpp0 * f.ph0 + dpp1 * f.ph1;
    const double dph0 = dpp0 * f.pw, dph1 = dpp1 * f.pw, dph3 = -dpw * f.pw * f.pw;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      dm[k] += dph0 * c.fp[k] + dph1 * c.fp[4 + k] + dph3 * c.fp[8 + k];
  }

  // local homography
  {
    double gj[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) gj[k] = g.jinv[k] / p.scale_back;
    double dxu0[3], dxu1[3], ddir0[3], ddir1[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      dxu0[k] = gj[0] * f.ax0[k] + gj[2] * f.ax1[k];
      dxu1[k] = gj[1] * f.ax0[k] + gj[3] * f.ax1[k];
      dax0[k] += gj[0] * f.xu0[k] + gj[1] * f.xu1[k];
      dax1[k] += gj[2] * f.xu0[k] + gj[3] * f.xu1[k];
      ddir0[k] = dxu0[k] * f.a0;
      ddir1[k] = dxu1[k] * f.a1;
      dpv[k] -= dxu0[k] + dxu1[k];
    }
    const double da0 = dot3(dxu0, f.dir0), da1 = dot3(dxu1, f.dir1);
    const double dt = da0 / f.p0s + da1 / f.p1s;
    const double dp0 = f.prj0 != 0.0 ? -da0 * f.vc / (f.p0s * f.p0s) : 0.0;
    const double dp1 = f.prj1 != 0.0 ? -da1 * f.vc / (f.p1s * f.p1s) : 0.0;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      ddir0[k] += dp0 * f.nv[k];
      ddir1[k] += dp1 * f.nv[k];
      dnv[k] += dp0 * f.dir0[k] + dp1 * f.dir1[k] + dt * f.pv[k];
      dpv[k] += dt * f.nv[k];
    }
    double dd0[3], dd1[3];
    unit_back(f.d0, ddir0, f.nrm0, f.mod0, dd0);
    unit_back(f.d1, ddir1, f.nrm1, f.mod1, dd1);
    const double dprx = dd0[0] + dd1[0], dpry = dd0[1] + dd1[1];
    dpv[0] += dprx / f.pz;
    dpv[1] += dpry / f.pz;
    if (f.pv[2] != 0.0) dpv[2] -= (dprx * f.pv[0] + dpry * f.pv[1]) / (f.pz * f.pz);
  }

  // conic and the EWA covariance: cov = U U^T, U = T M
  double dR[3][3];
  {
    const double gc0 = g.conic[0], gc1 = g.conic[1], gc2 = g.conic[2];
    const double dds = -(gc0 * f.c2 - gc1 * f.c1 + gc2 * f.c0) / (f.dets * f.dets);
    const double ddet = f.det != 0.0 ? dds : 0.0;
    const double dc0 = gc2 / f.dets + ddet * f.c2;
    const double dc1 = -gc1 / f.dets - 2 * f.c1 * ddet;
    const double dc2 = gc0 / f.dets + ddet * f.c0;
    double U[2][3], dU[2][3];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b)
        U[a][b] = f.T_[a][0] * f.M[0][b] + f.T_[a][1] * f.M[1][b] + f.T_[a][2] * f.M[2][b];
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      dU[0][b] = 2 * dc0 * U[0][b] + dc1 * U[1][b];
      dU[1][b] = dc1 * U[0][b] + 2 * dc2 * U[1][b];
    }
    // d_M = T^T dU -> d_R, d_s; d_T = dU M^T -> d_J = d_T W^T
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const double dM = f.T_[0][a] * dU[0][b] + f.T_[1][a] * dU[1][b];
        dR[a][b] = dM * f.s[b];
        ds[b] += dM * f.R[a][b];
      }
    double dT[2][3];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b)
        dT[a][b] = dU[a][0] * f.M[b][0] + dU[a][1] * f.M[b][1] + dU[a][2] * f.M[b][2];
    double dJ[2][3];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b)
        dJ[a][b] = dT[a][0] * W(c, b, 0) + dT[a][1] * W(c, b, 1) + dT[a][2] * W(c, b, 2);
    // J00 = fx / tzs, J11 = fy / tzs, J02 = -fx tx / tz2, J12 = -fy ty / tz2
    const double tz = f.pv[2];
    double dtzs = -(dJ[0][0] * fx + dJ[1][1] * fy) * f.rec * f.rec;
    const double dtx = dJ[0][2] * -fx / f.tz2;
    const double dty = dJ[1][2] * -fy / f.tz2;
    const double dtz2 = -(dJ[0][2] * f.J02 + dJ[1][2] * f.J12) / f.tz2;
    dtzs += 2 * f.tzs * dtz2;
    // tx = clamp(ux) tz, ux = pv_x / tzs
    const double dux = (f.ux >= -p.lim_x && f.ux <= p.lim_x) ? dtx * tz : 0.0;
    const double duy = (f.uy >= -p.lim_y && f.uy <= p.lim_y) ? dty * tz : 0.0;
    dpv[0] += dux / f.tzs;
    dpv[1] += duy / f.tzs;
    dtzs -= (dux * f.pv[0] + duy * f.pv[1]) / (f.tzs * f.tzs);
    dpv[2] += dtx * f.cx + dty * f.cy + (tz != 0.0 ? dtzs : 0.0);
  }

  // orientation: d_R[:, col] += W^T d_col
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const double w0 = W(c, 0, a), w1 = W(c, 1, a), w2 = W(c, 2, a);
    dR[a][0] += w0 * dax0[0] + w1 * dax0[1] + w2 * dax0[2];
    dR[a][1] += w0 * dax1[0] + w1 * dax1[1] + w2 * dax1[2];
    dR[a][2] += w0 * dnv[0] + w1 * dnv[1] + w2 * dnv[2];
  }
  // the unit quaternion, then normalize's backward
  {
    const double r = f.qn[0], x = f.qn[1], y = f.qn[2], z = f.qn[3];
    double dq[4];
    dq[0] = 2 * (z * (dR[1][0] - dR[0][1]) + y * (dR[0][2] - dR[2][0]) +
                 x * (dR[2][1] - dR[1][2]));
    dq[1] = 2 * (y * (dR[0][1] + dR[1][0]) + z * (dR[0][2] + dR[2][0]) +
                 r * (dR[2][1] - dR[1][2]) - 2 * x * (dR[1][1] + dR[2][2]));
    dq[2] = 2 * (x * (dR[0][1] + dR[1][0]) + z * (dR[1][2] + dR[2][1]) +
                 r * (dR[0][2] - dR[2][0]) - 2 * y * (dR[0][0] + dR[2][2]));
    dq[3] = 2 * (x * (dR[0][2] + dR[2][0]) + y * (dR[1][2] + dR[2][1]) +
                 r * (dR[1][0] - dR[0][1]) - 2 * z * (dR[0][0] + dR[1][1]));
    const double dot = dq[0] * f.q[0] + dq[1] * f.q[1] + dq[2] * f.q[2] + dq[3] * f.q[3];
    const double cc = f.sq >= 1e-24 ? dot * f.rinv * f.rinv * f.rinv : 0.0;
#pragma unroll
    for (int k = 0; k < 4; ++k) d_quats[4 * i + k] = float(dq[k] * f.rinv - f.q[k] * cc);
  }
  if (kSurface) ds[2] = 0.0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    d_scales[3 * i + k] = float(ds[k] * p.scale_mod);
    d_means[3 * i + k] =
        float(dm[k] + dpv[0] * W(c, 0, k) + dpv[1] * W(c, 1, k) + dpv[2] * W(c, 2, k));
  }
}

long long blocks_for(long long n) { return (n + kThreads - 1) / kThreads; }

template <bool kSurface, bool kGrazing>
int launch_forward(int color, unsigned blocks, cudaStream_t st, const float* means,
                   const float* scales, const float* quats, const float* src, const float* wv,
                   const float* fp, const float* cp, long long n, const PrepParams& p, bool* valid,
                   float* mean2d, float* depth, float* conic, int* radius, int* rect_min,
                   int* rect_max, int* tiles, float* nv, float* jinv, float* lam, float* rgb,
                   float* vc) {
#define SVGIR_PREP_FWD(C)                                                                       \
  svgir_preprocess_fwd_kernel<kSurface, kGrazing, C><<<blocks, kThreads, 0, st>>>(            \
      means, scales, quats, src, wv, fp, cp, n, p, valid, mean2d, depth, conic, radius,       \
      rect_min, rect_max, tiles, nv, jinv, lam, rgb, vc)
  switch (color) {
    case kNone: SVGIR_PREP_FWD(kNone); break;
    case kColors: SVGIR_PREP_FWD(kColors); break;
    case 0: SVGIR_PREP_FWD(0); break;
    case 1: SVGIR_PREP_FWD(1); break;
    case 2: SVGIR_PREP_FWD(2); break;
    case 3: SVGIR_PREP_FWD(3); break;
    case 4: SVGIR_PREP_FWD(4); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef SVGIR_PREP_FWD
  return (int)cudaGetLastError();
}

template <bool kSurface>
int launch_backward(int color, unsigned blocks, cudaStream_t st, const float* means,
                    const float* scales, const float* quats, const float* src, const float* wv,
                    const float* fp, const float* cp, long long n, const PrepParams& p,
                    const float* const* g, float* d_means, float* d_scales, float* d_quats,
                    float* d_src) {
#define SVGIR_PREP_BWD(C)                                                                      \
  svgir_preprocess_bwd_kernel<kSurface, C><<<blocks, kThreads, 0, st>>>(                     \
      means, scales, quats, src, wv, fp, cp, n, p, g[0], g[1], g[2], g[3], g[4], g[5], g[6], \
      g[7], d_means, d_scales, d_quats, d_src)
  switch (color) {
    case kNone: SVGIR_PREP_BWD(kNone); break;
    case kColors: SVGIR_PREP_BWD(kColors); break;
    case 0: SVGIR_PREP_BWD(0); break;
    case 1: SVGIR_PREP_BWD(1); break;
    case 2: SVGIR_PREP_BWD(2); break;
    case 3: SVGIR_PREP_BWD(3); break;
    case 4: SVGIR_PREP_BWD(4); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef SVGIR_PREP_BWD
  return (int)cudaGetLastError();
}

}  // namespace

// outs: valid, mean2d, depth, conic, radius, rect_min, rect_max,
// tiles_touched, normal_view, jinv, lam, rgb, view_cos (in Preprocessed's
// order); surface, grazing: the culls; color: -2 none, -1 colors, 0-4 the
// SH degree.
extern "C" int svgir_preprocess_forward(const float* means, const float* scales,
                                        const float* quats, const float* src, const float* wv,
                                        const float* fp, const float* cp, long long n,
                                        const PrepParams* params, int surface, int grazing,
                                        int color, void* const* outs, void* stream) {
  if (n < 0 || blocks_for(n) > INT_MAX || params == nullptr) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const unsigned blocks = (unsigned)blocks_for(n);
  const cudaStream_t st = (cudaStream_t)stream;
  auto f = [&](auto launch) {
    return launch(color, blocks, st, means, scales, quats, src, wv, fp, cp, n, *params,
                  (bool*)outs[0], (float*)outs[1], (float*)outs[2], (float*)outs[3],
                  (int*)outs[4], (int*)outs[5], (int*)outs[6], (int*)outs[7],
                  (float*)outs[8], (float*)outs[9], (float*)outs[10], (float*)outs[11],
                  (float*)outs[12]);
  };
  if (!surface) return f(launch_forward<false, false>);
  return grazing ? f(launch_forward<true, true>) : f(launch_forward<true, false>);
}

// cot: the 8 cotangents in ops/preprocess.py FLOAT_FIELDS' order, each
// null where autograd passed none.
extern "C" int svgir_preprocess_backward(const float* means, const float* scales,
                                         const float* quats, const float* src, const float* wv,
                                         const float* fp, const float* cp, long long n,
                                         const PrepParams* params, int surface, int color,
                                         const float* const* cot, float* d_means,
                                         float* d_scales, float* d_quats, float* d_src,
                                         void* stream) {
  if (n < 0 || blocks_for(n) > INT_MAX || params == nullptr) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const unsigned blocks = (unsigned)blocks_for(n);
  const cudaStream_t st = (cudaStream_t)stream;
  return surface ? launch_backward<true>(color, blocks, st, means, scales, quats, src, wv, fp,
                                         cp, n, *params, cot, d_means, d_scales, d_quats, d_src)
                 : launch_backward<false>(color, blocks, st, means, scales, quats, src, wv, fp,
                                          cp, n, *params, cot, d_means, d_scales, d_quats,
                                          d_src);
}
