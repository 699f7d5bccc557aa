// B4 svgir_blend_backward replaces svgir_tpu/ops/blend_pallas_strip.py
// blend_backward_strip (_bwd_kernel), and B6 svgir_blend_backward_tiles
// replaces svgir_tpu/ops/blend_pallas.py blend_backward (_bwd_kernel):
// per-instance gradient rows d_slab [M, KR] of the forward blend
// (blend_forward.cu).  One kernel serves both; only the layout of the
// cotangents and of the forward's outputs differs (template parameter
// TILES).  B4 reads image-layout cotangents g_img [>= CA+CV+1, Hp, Wp], the
// final logT image and eff[t]; B6 reads tile-major g_out [T, CA+CV+3,
// tile*tile] and the forward's meta block [T, 3, tile*tile] (final logT in
// row 0, chunks processed in row 2, from which it takes eff).
//
// Each tile sweeps its processed chunks (eff[t], from the forward) from last
// to first and walks the instances of a chunk backwards, rebuilding the
// log-transmittance from the forward's final logT:
//   logT_excl_i = logT_after_i - loga_i
//   d_loga_i    = g_logT + sum_{j > i} dw_j w_j
// and forming the rows of _bwd_kernel: d_mean2d, d_conic, d_opacity (only
// where alpha < 0.99), d_Jinv and d_lam (through the interior of the u, v
// clamps), the plain rows g . w and the vertex rows g . w . bilinear weight.
// dw adds the weight-sum cotangent g_wsum[i] when one is given.  Rows of
// chunks the forward skipped stay zero (the caller zero-fills d_slab).
//
// Bound: operations, as the forward, plus one reduction over the tile's
// pixels for each of the KR rows of every instance.  Design: one block per
// tile, one thread per pixel, the chunk's slab rows and g_wsum staged in
// shared memory.  Each row value is summed over the warp by shuffles
// (skipped, as exact zeros, when no pixel of the warp passes `ok`), lane 0
// parks it in shared memory, and every IB instances the block sums the
// warps' partials in a fixed order and writes the rows: deterministic, no
// atomics.  The per-Gaussian scatter-add of the rows stays outside, in
// torch (ops/rasterizer.py), as in the reference's custom VJP.
#include "blend_common.cuh"

#define SVGIR_BWD_IB 4  // instances per cross-warp reduction round

template <int MAXA, int MAXV, bool TILES>
__global__ void __launch_bounds__(1024)
svgir_blend_bwd_kernel(const float* __restrict__ slab, const int* __restrict__ tile_start,
                       const int* __restrict__ eff, const float* __restrict__ g_img,
                       const float* __restrict__ logt_img, const float* __restrict__ g_wsum,
                       int kr, int ca, int cv, int grid_x, int tile, int chunk, int img_w,
                       size_t img_hw, float* __restrict__ d_slab) {
  extern __shared__ float smem[];
  float* s_slab = smem;                 // chunk * kr
  float* s_gw = s_slab + chunk * kr;    // chunk
  float* s_part = s_gw + chunk;         // nwarps * IB * kr
  const int P = tile * tile;
  const int p = threadIdx.x;
  const int warp = p >> 5, lane = p & 31, nwarps = P >> 5;
  const int t = blockIdx.x;
  const int gx = (t % grid_x) * tile + p % tile;
  const int gy = (t / grid_x) * tile + p / tile;
  const float px = (float)gx, py = (float)gy;
  const int start = tile_start[t];
  // TILES: logt_img is the meta block [T, 3, P] (logT, n_contrib, chunks)
  const int ne = TILES ? (int)logt_img[(size_t)t * 3 * P + 2 * P] : eff[t];
  constexpr int NV = MAXV > 0 ? MAXV : 1;

  // channel k of this pixel's cotangents: image layout [k, gy, gx];
  // tile-major [t, k, p]
  const size_t o = TILES ? (size_t)t * (ca + cv + 3) * P + p : (size_t)gy * img_w + gx;
  const size_t stride = TILES ? (size_t)P : img_hw;
  float gp[MAXA];
  float gv[NV];
#pragma unroll
  for (int k = 0; k < MAXA; ++k) gp[k] = k < ca ? g_img[k * stride + o] : 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) gv[k] = (MAXV > 0 && k < cv) ? g_img[(ca + k) * stride + o] : 0.f;
  // logT after the instance being visited
  float logT = TILES ? logt_img[(size_t)t * 3 * P + p] : logt_img[(size_t)gy * img_w + gx];
  float S = g_img[(ca + cv) * stride + o];  // d_loga of the instance being visited

  for (int c = ne - 1; c >= 0; --c) {
    const int base = start + c * chunk;
    __syncthreads();
    const float* src = slab + (size_t)base * kr;
    for (int e = p; e < chunk * kr; e += P) s_slab[e] = src[e];
    for (int e = p; e < chunk; e += P) s_gw[e] = g_wsum ? g_wsum[base + e] : 0.f;
    __syncthreads();
    for (int i0 = chunk - SVGIR_BWD_IB; i0 >= 0; i0 -= SVGIR_BWD_IB) {
      for (int b = SVGIR_BWD_IB - 1; b >= 0; --b) {
        const int i = i0 + b;
        const float* r = s_slab + i * kr;
        float* part = s_part + (warp * SVGIR_BWD_IB + b) * kr;
        const float dx = r[0] - px, dy = r[1] - py;
        const float power = -0.5f * (r[2] * dx * dx + r[4] * dy * dy) - r[3] * dx * dy;
        const float ep = expf(power);
        const float alpha = fminf(SVGIR_ALPHA_MAX, r[5] * ep);
        const bool ok = (power <= 0.f) && (alpha >= SVGIR_ALPHA_MIN);
        if (!__any_sync(SVGIR_FULL_MASK, ok)) {
          // no pixel of the warp sees this instance: every row term is 0
          if (lane == 0)
            for (int k = 0; k < kr; ++k) part[k] = 0.f;
          continue;
        }
        const float loga = ok ? log1pf(-alpha) : 0.f;
        const float logT_excl = logT - loga;
        const bool gate = ok && (logT_excl >= SVGIR_LOG_T_EPS);
        const float expT = expf(logT_excl);
        const float w = gate ? alpha * expT : 0.f;

        float dw = s_gw[i];
#pragma unroll
        for (int k = 0; k < MAXA; ++k)
          if (k < ca) dw += gp[k] * r[SVGIR_NG + k];

        float d_du0 = 0.f, d_du1 = 0.f, d_lamx = 0.f, d_lamy = 0.f;
        float wv0 = 0.f, wv1 = 0.f, wv2 = 0.f, wv3 = 0.f;
        if (MAXV > 0 && cv > 0) {
          const SvgirUV q = svgir_uv(r, dx, dy);
          const float* va = r + SVGIR_NG + ca;
          float mv0 = 0.f, mv1 = 0.f, mv2 = 0.f, mv3 = 0.f;
#pragma unroll
          for (int k = 0; k < NV; ++k)
            if (k < cv) {
              mv0 += gv[k] * va[k];
              mv1 += gv[k] * va[cv + k];
              mv2 += gv[k] * va[2 * cv + k];
              mv3 += gv[k] * va[3 * cv + k];
            }
          wv0 = (1.f - q.u) * (1.f - q.v);
          wv1 = q.u * (1.f - q.v);
          wv2 = (1.f - q.u) * q.v;
          wv3 = q.u * q.v;
          dw += wv0 * mv0 + wv1 * mv1 + wv2 * mv2 + wv3 * mv3;
          float d_u = w * ((1.f - q.v) * (mv1 - mv0) + q.v * (mv3 - mv2));
          float d_v = w * ((1.f - q.u) * (mv2 - mv0) + q.u * (mv3 - mv1));
          if (!(q.u_raw > 0.001f && q.u_raw < 0.999f)) d_u = 0.f;
          if (!(q.v_raw > 0.001f && q.v_raw < 0.999f)) d_v = 0.f;
          d_du0 = d_u * 0.5f / q.uvmx;
          d_du1 = d_v * 0.5f / q.uvmy;
          d_lamx = 0.5f * (d_u * (-q.du0 / (q.uvmx * q.uvmx)) * 0.5f);
          d_lamy = 0.5f * (d_v * (-q.du1 / (q.uvmy * q.uvmy)) * 0.5f);
        }

        const float s_term = dw * w;
        const float nclamp = alpha < SVGIR_ALPHA_MAX ? 1.f : 0.f;
        const float d_alpha = (gate ? dw * expT : 0.f) + (ok ? S * (-1.f / (1.f - alpha)) : 0.f);
        const float d_power = d_alpha * alpha * nclamp;

        float v;
#define SVGIR_EMIT(k, val) \
  v = svgir_warp_sum(val); \
  if (lane == 0) part[k] = v;
        SVGIR_EMIT(0, d_power * (-r[2] * dx - r[3] * dy) + d_du0 * r[6] + d_du1 * r[8]);
        SVGIR_EMIT(1, d_power * (-r[4] * dy - r[3] * dx) + d_du0 * r[7] + d_du1 * r[9]);
        SVGIR_EMIT(2, d_power * (-0.5f * dx * dx));
        SVGIR_EMIT(3, d_power * (-dx * dy));
        SVGIR_EMIT(4, d_power * (-0.5f * dy * dy));
        SVGIR_EMIT(5, d_alpha * ep * nclamp);
        SVGIR_EMIT(6, d_du0 * dx);
        SVGIR_EMIT(7, d_du0 * dy);
        SVGIR_EMIT(8, d_du1 * dx);
        SVGIR_EMIT(9, d_du1 * dy);
        SVGIR_EMIT(10, d_lamx);
        SVGIR_EMIT(11, d_lamy);
#pragma unroll
        for (int k = 0; k < MAXA; ++k)
          if (k < ca) { SVGIR_EMIT(SVGIR_NG + k, gp[k] * w); }
        if (MAXV > 0 && cv > 0) {
#pragma unroll
          for (int k = 0; k < NV; ++k)
            if (k < cv) {
              const int row = SVGIR_NG + ca + k;
              const float gw = gv[k] * w;
              SVGIR_EMIT(row, gw * wv0);
              SVGIR_EMIT(row + cv, gw * wv1);
              SVGIR_EMIT(row + 2 * cv, gw * wv2);
              SVGIR_EMIT(row + 3 * cv, gw * wv3);
            }
        }
#undef SVGIR_EMIT
        S += s_term;
        logT = logT_excl;
      }
      __syncthreads();
      for (int e = p; e < SVGIR_BWD_IB * kr; e += P) {
        const int b = e / kr, k = e % kr;
        float s = 0.f;
        for (int wp = 0; wp < nwarps; ++wp) s += s_part[(wp * SVGIR_BWD_IB + b) * kr + k];
        d_slab[(size_t)(base + i0 + b) * kr + k] = s;
      }
      __syncthreads();
    }
  }
}

template <int MAXA, int MAXV, bool TILES>
static int launch_backward(const float* slab, const int* tile_start, const int* eff,
                           const float* g_img, const float* logt_img, const float* g_wsum,
                           int kr, int ca, int cv, int grid_x, int grid_y, int tile, int chunk,
                           float* d_slab, cudaStream_t stream) {
  const int P = tile * tile;
  const size_t smem =
      ((size_t)chunk * kr + chunk + (size_t)(P / 32) * SVGIR_BWD_IB * kr) * sizeof(float);
  auto kernel = svgir_blend_bwd_kernel<MAXA, MAXV, TILES>;
  cudaError_t err = svgir_smem_opt_in(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int img_w = grid_x * tile;
  const size_t img_hw = (size_t)grid_y * tile * img_w;
  if (grid_x * grid_y > 0)
    kernel<<<grid_x * grid_y, P, smem, stream>>>(slab, tile_start, eff, g_img, logt_img,
                                                 g_wsum, kr, ca, cv, grid_x, tile, chunk,
                                                 img_w, img_hw, d_slab);
  return (int)cudaGetLastError();
}

template <bool TILES>
static int dispatch_backward(const float* slab, const int* tile_start, const int* eff,
                             const float* g_img, const float* logt_img, const float* g_wsum,
                             int kr, int ca, int cv, int grid_x, int grid_y, int tile,
                             int chunk, float* d_slab, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (chunk % SVGIR_BWD_IB != 0) return (int)cudaErrorInvalidValue;
  if (cv == 0 && ca <= 16)
    return launch_backward<16, 0, TILES>(slab, tile_start, eff, g_img, logt_img, g_wsum, kr,
                                         ca, cv, grid_x, grid_y, tile, chunk, d_slab, s);
  if (ca <= 32 && cv <= 16)
    return launch_backward<32, 16, TILES>(slab, tile_start, eff, g_img, logt_img, g_wsum, kr,
                                          ca, cv, grid_x, grid_y, tile, chunk, d_slab, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int svgir_blend_backward(const float* slab, const int* tile_start, const int* eff,
                                    const float* g_img, const float* logt_img,
                                    const float* g_wsum, int kr, int ca, int cv, int grid_x,
                                    int grid_y, int tile, int chunk, float* d_slab,
                                    void* stream) {
  return dispatch_backward<false>(slab, tile_start, eff, g_img, logt_img, g_wsum, kr, ca, cv,
                                  grid_x, grid_y, tile, chunk, d_slab, stream);
}

// B6: g_out [T, CA+CV+3, tile*tile] and the forward's meta [T, 3, tile*tile].
extern "C" int svgir_blend_backward_tiles(const float* slab, const int* tile_start,
                                          const float* g_out, const float* meta,
                                          const float* g_wsum, int kr, int ca, int cv,
                                          int grid_x, int grid_y, int tile, int chunk,
                                          float* d_slab, void* stream) {
  return dispatch_backward<true>(slab, tile_start, nullptr, g_out, meta, g_wsum, kr, ca, cv,
                                 grid_x, grid_y, tile, chunk, d_slab, stream);
}
